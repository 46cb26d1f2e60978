#!/usr/bin/env python3
"""Drive the PyTorch port (``agac_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--services N] [--sim-services N] [--seed S]

Phases, in order; any failure exits non-zero before the last line:

1. ``device``: requires ``torch.cuda.is_available()`` and prints the
   card's name and power limit as ``nvidia-smi`` reports them.
2. ``converge``: ``bench.py``'s mixed fleet built from the port's own
   objects (N Services, N/10 ALB Ingresses, N/10 EndpointGroupBindings
   against 10 hosted zones, one out-of-band accelerator chain per
   binding) converges through the port's ``Manager`` with 16 workers
   per controller, the port's ``AWSDriver`` and an unshaped
   ``FakeAWSBackend``.  The criterion is ``bench.py``'s: every chain
   complete (accelerator, listener, endpoint group), 2 x (N + N/10)
   Route53 records, every binding bound to exactly one endpoint.  The
   controller is host code, so this phase is host-bound.
3. ``process``: the port's command line as the chart deploys it.  The
   port's ``TestApiServer`` (the Kubernetes REST protocol over HTTP) is
   seeded with 600 Services (the reference's own HTTP scale test, so
   the informers' first LIST spans two 500-object pages; one NLB each,
   every 20th hostname-annotated in one zone) and 60 ALB Ingresses.  Two ``python -m
   agac_tpu_torch controller`` replicas start against it with the
   chart's arguments, leader election at production timings and the
   chart's no-credentials fake AWS (``AGAC_CLOUD=fake``).  Read only
   over the wire, the phase requires one Lease holder, a
   ``GlobalAcceleratorCreated`` Event per object and a
   ``Route53RecordCreated`` Event per hostname, the leader's
   ``/debug/explain`` answering ``converged`` for every object, and no
   AWS call counted on the standby's ``/metrics``.  ``python -m
   agac_tpu_torch webhook`` must then deny an ``EndpointGroupArn``
   change and allow a create, and every child must stop cleanly on
   SIGTERM.  Host code: the card is idle in this phase.
4. ``shard``: the sharded deployment over the port's command line.
   Four ``python -m agac_tpu_torch controller --shard-count 4``
   replicas share one HTTP apiserver and one flock-arbitrated fake AWS
   account (``AGAC_FAKE_STATE``, 0.3 s per call) and converge 200
   Services on one NLB, created once every shard lease is held; one
   ``--shard-count 1 --disable-leader-election`` replica converges the
   same fleet alone; a run at width 2 kills the holder of shard 0 with
   SIGKILL halfway, and the survivor must steal its lease and finish
   (the plain width 2 runs against the reference on the CPU, and the
   ``autoscale`` phase starts at it).  Read over the wire, each run
   must show disjoint lease ownership, exactly 200 complete
   chains and never more, the call rate and summed AIMD ceilings
   within the 400/s per-service budget at every read, a journey closed
   per Service in the fleet-merged metrics and, after the kill, the
   survivor owning every shard.  Host code: the card is idle in this
   phase.
5. ``resize``: the live elastic resize as the operations runbook runs
   it, on the ``shard`` phase's fleet.  Two ``python -m agac_tpu_torch
   controller --shard-count 2 --shards-per-replica 4`` replicas converge
   200 Services; three eighths in, ``python -m agac_tpu_torch
   resize-shards -n 4`` grows the ring under load while the last
   quarter of the Services is created, and both replicas must report
   ring ``4x64`` stable.  ``resize-shards -n 2`` then shrinks it, the
   holder of shard 0 gets SIGKILL mid-transition, and the survivor must
   steal its leases and finish alone at ``2x64``.  A watch reads the
   shared account every 0.1 s through the run: no accelerator owner
   may ever repeat, and the fleet must create each accelerator once,
   end with exactly 200 complete chains after each resize, stay within
   the 400/s per-service budget at every read and answer
   ``converged`` for every Service.  Host code: the card is idle in
   this phase.
6. ``autoscale``: the SLO autoscaler closing its loop over processes,
   the reference's autoscaler canary as the command line runs it.  Four
   ``python -m agac_tpu_torch controller --autoscale --shard-count 2
   --shards-per-replica 1`` replicas with admission at 1 qps / burst
   10 converge 40 Services, then take a wave of 300 with no operator
   action; an observe-only twin takes the same wave beside them.  The
   acting fleet must scale out to 4 shards by its own decision within
   180 s of the wave, reach the new ring stable everywhere, and flip
   direction at most once (a scale-in no sooner than cooldown-in after
   the scale-out, and nothing after it); the twin's ring must stay put
   while a replica records the scale-out it held.  Both must create
   each accelerator once, stay within the 400/s per-service budget at
   every read, answer ``converged`` for every Service and leave no
   journey in flight on any replica once the wave is done.  Host code:
   the card is idle in this phase.
7. ``teardown``: deletion, teardown and the orphan sweeper over
   processes, on the ``shard`` phase's fleet and account.  Two ``python
   -m agac_tpu_torch controller --shard-count 2 --shards-per-replica 2
   --gc-interval 1 --gc-grace-sweeps 2 --gc-max-deletes 10`` replicas,
   each holding one shard, converge 200 Services (one in ten
   hostname-annotated, in the fake zone ``example.com``, so 20 TXT+A
   pairs), with every accelerator settling through two reads of the
   account (``AGAC_FAKE_SETTLE``), so every teardown parks on its
   disable.  The even-numbered half is deleted in one burst; once a
   deleted owner's accelerator is disabled and not yet deleted, the
   holder of shard 0 gets SIGKILL.  Its delete events die with it, so
   after the survivor steals its lease, its sweeper must find those
   orphans from ownership tags and TXT heritage alone.  A watch reads
   the shared account every 0.1 s: every kept Service keeps its
   accelerator (same ARN, enabled) and records at every read, and no
   accelerator is disabled twice (nor in the replicas' logs).  The
   phase requires exactly the kept half's chains and records at the
   end, the survivor's ``/healthz`` gc block counting at least the dead
   replica's orphans, no sweep over ``--gc-max-deletes``, the last
   orphan gone within takeover + (grace - 1 + ceil(K / budget) + 1) x
   interval + 2 x settle + 15 s of the kill, the 400/s budget at every
   read, ``converged`` for every kept Service, no journey left in flight
   and a clean exit.  Host code: the card is idle in this phase.
8. ``drift``: drift resync over processes, with the binding controller
   in the fleet, on the ``teardown`` phase's fleet settings.  Two
   ``python -m agac_tpu_torch controller --shard-count 2
   --shards-per-replica 2 --drift-resync-period 12`` replicas (the
   discovery snapshot's TTL at the period) converge ``bench.py``'s mixed
   fleet: 200 Services, 20 ALB Ingresses and 20 EndpointGroupBindings,
   each binding putting a Service's NLB into an out-of-band chain this
   script built first.  One tick is timed on each replica, with its
   reads.  Then, at once and in both shards, an accelerator is
   disabled, a listener deleted, a binding's endpoint weight edited and
   another's endpoint removed, an A record repointed and a TXT record
   deleted; the holder of shard 0 gets SIGKILL as soon as the first of
   its shard's tampers is repaired, and the survivor must take its
   shard over and repair the rest.  A watch reads the account every
   0.1 s.  The phase requires each repair within the period + its
   freshness window + one tick (+ the takeover for shard 0), tampers of
   shard 0 still open at the kill, each tick's reads within the
   runbook's per-object ceilings scaled to the fleet, no duplicate
   accelerator, no reconcile logged for a key the replica's shards did
   not own, the 400/s budget at every read, no journey left in flight,
   the bindings' finalizers removing their endpoints and nothing else,
   exactly the fleet's chains and pairs at the end and a clean exit.
   Host code: the card is idle in this phase.
9. ``sim`` (in a process of its own, beside ``drift`` and
   ``analysis``): the port's virtual-time runtime, which runs the whole
   Manager on one thread and folds every dispatch into a SHA-256
   event-trace hash.  ``replay`` replays every checked-in incident
   capture (``tests/captures/*.jsonl``) and requires a byte-identical
   hash chain and a clean oracle battery; ``fuzz`` plays the
   standard scenario's seeds 1-5 at ``quick`` and seed 1 of the
   resize, autoscale and autoscale-brownout scenarios at ``mini``, and
   requires clean oracles and the trace hashes pinned in
   ``PORT_FUZZ_PINS``; ``rollout`` brings a fleet of ``--sim-services``
   Services (default 10,000, the sim's documented scale) up over two
   virtual hours on two replicas, runs to quiescence and requires
   clean oracles, a complete accelerator chain per Service, the
   TXT+A pair per hostname-annotated Service and, where
   ``PORT_ROLLOUT_PINS`` holds one for N, the pinned trace hash;
   ``shard-soak`` brings the same number of Services up on two shards,
   kills a replica at virtual hour 3 and requires clean oracles and
   SLOs, every journey closed, one accelerator per Service, one owner
   of both shards and, where ``PORT_SHARD_SOAK_PINS`` holds one, the
   pinned hash.  The port's teardown makes two accelerator reads fewer
   than the reference's, and its staged create reads nothing between
   its three creates, so the port's fuzz, rollout and soak pins are
   its own (``FUZZ_PINS``, ``ROLLOUT_PINS`` and ``SHARD_SOAK_PINS``
   hold the reference's); ``tests/test_torch_sim.py`` and
   ``tests/test_torch_sharding_sim.py`` hold each of those runs to the
   reference's outcome on the CPU.  Host code: the card is idle in
   this phase.
10. ``analysis``: the port's static analyses over its own tree, then
   their runtime cross-check at fleet scale.  The port's linter must
   find nothing and its whole-program analyses (lock order, census,
   determinism, confinement) must pass their gate with the port's
   baseline.  ``converge``'s fleet then converges again, through the
   chaos tier's seeded fault plan (every AWS call may fail, mutations
   may fail after committing) under the racecheck watchdog, and the
   watchdog's observed lock edges and stage-tagged writes must fall
   inside the static lock graph and footprint table.  Host code: the
   card is idle in this phase.
11. ``graft``: the torch twin of the MLP, forward and
   one train step on ``cuda``, held against the same weights run on
   the CPU in float32 with bf16 rounding at the same points; then the
   JAX program's multi-chip dry run, one train step over a 4 x 2 data x
   model mesh of 8 gloo processes on the CPU, held to the unsharded
   step.

The kernel line lists none: the reference holds no Pallas kernel, so
the port has no hand-written kernel to hold against a plain version.
The last line is ``{"ok": true, "device": {...}}``.

The fleet helpers, ``converge``, ``process``, ``shard_fleet``,
``resize_fleet``, ``autoscale_fleet``, ``teardown_fleet``, ``drift_fleet``, ``rollout`` and
``shard_soak`` take the package as a parameter so that
tests can run the same fleet through the reference; this script itself
only ever loads the port.  The process drills share one lifecycle
(``ProcessFleet``) and one state-file watcher (``StateWatch``).
Measurements belong to ``perfbench/``: the fleet phases print their
bounds' outcomes, and only the ``graft`` phase times something (its
MLP's forward and train step, by CUDA events, beside their bounds).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import importlib
import json
import multiprocessing
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

PORT = "agac_tpu_torch"
N_ZONES = 10
REGION = "us-west-2"
WORKERS = 16
RESYNC_PERIOD = 30.0  # the reference's informer resync default
QUEUE_QPS, QUEUE_BURST = 10.0, 100
# bench.py's Route53 wait for a missing accelerator, 60 s / its 10x
# time compression
ACCELERATOR_MISSING_RETRY = 6.0
CONVERGE_DEADLINE = 600.0
STALL_AFTER = 120.0
QUIET = 0.5
JOIN_TIMEOUT = 15.0
# one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3 bytes/s
# and dense bf16 tensor-core FLOP/s, for the least time a step could take
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12

# the process phase
REPO = pathlib.Path(__file__).resolve().parent
# tests/test_envtest_e2e.py's scale test over HTTP: more than the REST
# client's 500-object LIST page
PROCESS_SERVICES = 600
SERVICE_ZONE = "svc.bench.example.com"
LEASE_NAMESPACE, LEASE_NAME = "kube-system", "aws-global-accelerator-controller"
# the chart's controller arguments (charts/*/values.yaml and
# templates/deployment.yaml); leader election on, at the production
# lease timings (no AGAC_LEASE_* override)
CHART_ARGS = (
    "-v", "2", "controller", "--cluster-name", "default", "--workers", "8",
    "--queue-qps", "10", "--queue-burst", "100", "--queue-max-backoff", "1000",
    "--drift-resync-period", "0",
)
PROCESS_DEADLINE = 600.0
EXIT_DEADLINE = 15.0

# the shard phase: bench.py's sharded fleet (bench.py:1255-1290): its
# Services on one NLB, workers, call latency and global per-service AWS
# budget, at the widest width the card host's 8 cores carry beside the
# apiserver (bench.py:1260-1264)
SHARD_SERVICES = 200
SHARD_WIDTH = 4
SHARD_WORKERS = 8
SHARD_LATENCY = 0.3
SHARD_BUDGET_QPS = 400.0
SHARD_LB = ("shardlb", f"shardlb-0123456789abcdef.elb.{REGION}.amazonaws.com")
# the failover run kills the holder of shard 0 once this share of the
# fleet's chains is complete
SHARD_KILL_AT = 0.5
# the bench's lease timing and retry and poll overrides
# (bench.py:1389-1411): a sub-2 s renew deadline reads a GIL pause on
# shared cores as a crash, and the chart's 60 s lease would stretch the
# failover run by a minute
SHARD_ENV = {
    "AGAC_LEASE_DURATION": "15",
    "AGAC_LEASE_RENEW_DEADLINE": "8",
    "AGAC_LEASE_RETRY_PERIOD": "0.5",
    "AGAC_ACCELERATOR_MISSING_RETRY": "0.1",
    "AGAC_LB_NOT_ACTIVE_RETRY": "0.1",
    "AGAC_POLL_INTERVAL": "0.02",
    "AGAC_POLL_TIMEOUT": "5",
}

# the resize phase: the runbook's live elastic resize (docs/operations.md:466-475)
# on the shard phase's fleet.  Two replicas at two shards, each allowed four
# (the runbook raises --shards-per-replica before growing), grow to four
# shards and shrink back to two
RESIZE_FROM, RESIZE_TO, RESIZE_CAPACITY = 2, 4, 4
# shares of the fleet created before the grow, and complete before it is
# requested; bench.py's creation batch
RESIZE_FIRST, RESIZE_AT = 0.75, 0.375
RESIZE_BATCH = 8
# a state-file watch reads the account every RESIZE_POLL s, and fails
# when two reads are more than RESIZE_POLL_BOUND s apart
RESIZE_POLL, RESIZE_POLL_BOUND = 0.1, 0.5
# the shortest window a call rate is held over: the drills' own reads of
# the replicas come at least this far apart (DRIFT_TICK_READ, the waits'
# 0.25 s, the teardown's TEARDOWN_READ)
BUDGET_WINDOW = 0.2
# the states in which the shrink's kill lands
RESIZE_STATES = ("draining", "adopting")

# the autoscale phase: the reference's autoscaler canary
# (agac_tpu_torch/sim/fuzz.py's _autoscale_config: four replicas, two shards
# growing to at most four, per-replica admission as the scarce resource, the
# policy's rails) as controller processes on the shard phase's fleet and
# account.  Each replica holds at most one shard (the canary's two would let
# one process take the whole wave); admission is the chart's 10/100 scaled by
# a tenth; the interval and cooldown-in are cut so the phase fits a chip call
AUTOSCALE_REPLICAS = 4
AUTOSCALE_FROM, AUTOSCALE_TO = 2, 4
AUTOSCALE_BASE, AUTOSCALE_WAVE = 40, 300
AUTOSCALE_QUEUE = ("1", "10")
AUTOSCALE_COOLDOWN_OUT, AUTOSCALE_COOLDOWN_IN = 90.0, 90.0
AUTOSCALE_INTERVAL = 5.0
# ring epoch 1 must be requested within this many s of the wave's first create
AUTOSCALE_REACTION_BOUND = 180.0
# the run ends this long after epoch 1 when no scale-in came, or this long
# after the scale-in's ring is stable (cut, with cooldown-in, so the whole
# script keeps a margin to the chip call's limit)
AUTOSCALE_HOLD_S, AUTOSCALE_TAIL_S = 180.0, 5.0
# every replica's journeys in flight reach 0 within this long of the last
# chain completing with the ring stable
AUTOSCALE_SETTLE_S = 15.0
# seconds between the phase's reads of the replicas, and between its
# reads of the cores busy (longer: a container host's CPU accounting can
# be coarse over a second)
AUTOSCALE_READ, AUTOSCALE_BUSY_READ = 1.0, 5.0
# the observe-only twin starts this long after the acting run, so the two
# fleets' start-ups and waves do not land on the host's cores at once
AUTOSCALE_TWIN_DELAY = 30.0

# the teardown phase: reactive teardown and the orphan sweeper
# (docs/operations.md:153-233) on the shard phase's fleet and account.
# Two replicas at two shards, each allowed both (the survivor adopts the
# dead replica's); the sweeper at the reference's drill grace and budget
# (tests/test_process_e2e.py:50) with the interval cut from the runbook's
# 300 s to 1 s; every accelerator settles through AGAC_FAKE_SETTLE reads
# of the fake account, so every teardown parks on its disable
TEARDOWN_ZONE = "example.com"
TEARDOWN_HOSTNAME_EVERY = 10
TEARDOWN_GC = {"interval": 1.0, "grace_sweeps": 2, "max_deletes": 10}
TEARDOWN_SETTLE = 2
# the kill lands once a deleted owner's accelerator is disabled and not
# yet deleted, while at most this share of the deleted owners'
# accelerators is gone
TEARDOWN_KILL_GONE = 1 / 3
# the mop-up bound's slack beyond the sweeps it counts, s
TEARDOWN_SLACK_S = 15.0
# seconds between the phase's reads of the replicas
TEARDOWN_READ = 0.5

# the drift phase: drift resync (docs/operations.md:560-640) over processes,
# with the binding controller in the fleet, on the teardown phase's fleet
# settings.  Every replica re-verifies its keys every DRIFT_PERIOD s (cut
# from the runbook's 300 s floor; at least twice one tick's wall time,
# docs/operations.md:601), with the discovery snapshot's TTL at the same
# period (docs/operations.md:63, 596)
DRIFT_PERIOD = 12.0
# the out-of-band tampers applied in each shard at once, each with the
# freshness window it can hide behind (docs/operations.md:612-621): the
# verify window (AGAC_TOPOLOGY_VERIFY_TTL) for a deleted listener and a
# binding's removed endpoint or edited weight, the record-set window
# (AGAC_RECORDSET_CACHE_TTL) for record edits, None for one discovery TTL
DRIFT_WINDOWS = {
    "disable": None,
    "listener": 15.0,
    "weight": 15.0,
    "endpoint": 15.0,
    "record-edit": 15.0,
    "record-delete": 15.0,
}
DRIFT_TAMPERS = tuple(DRIFT_WINDOWS)
DRIFT_WEIGHT = 7  # the weight the weight tamper sets (the bindings ask 100)
# one tick's reads over the runbook's fleet (1,000 Services + 100 Ingresses
# + 100 bindings in 10 zones, docs/operations.md:580-588), by the operation
# label of agac_aws_api_calls_total, each with the part of the fleet it
# scales with; a read outside the table has a ceiling of 0, but for the
# snapshot refreshes that ride on a tick: one ListAccelerators drain and
# one ListTagsForResource per accelerator per discovery TTL
# (docs/operations.md:596-598) and one ListHostedZones drain per zone TTL
# (docs/operations.md:64)
DRIFT_READS = {
    "list_listeners": (0, "accelerators"),
    "list_tags_for_resource": (0, "accelerators"),
    "list_endpoint_groups": (1100, "accelerators"),
    "describe_endpoint_group": (100, "bindings"),
    "describe_load_balancers": (202, "objects"),
    "list_resource_record_sets": (40, "zones"),
}
DRIFT_TABLE_FLEET = {"accelerators": 1100, "bindings": 100, "objects": 1200, "zones": 10}
# seconds between the phase's reads of the replicas while it times a tick
DRIFT_TICK_READ = 0.2

# the sim phase
CAPTURES = REPO / "tests" / "captures"
SIM_SERVICES = 10_000  # the sim's documented scale
ROLLOUT_SECONDS = 7200.0  # the fleet arrives over two virtual hours
QUIESCE_TIMEOUT, SETTLE_WINDOW = 12 * 3600.0, 600.0
# (scenario, seed, profile) -> the event-trace hash the reference
# package computes for the same scenario
FUZZ_PINS = {
    ("standard", 1, "quick"): (
        "621f05c7881c25b58224790e8a1126f7826386229f8b05e4183993b5747c4285"
    ),
    ("standard", 2, "quick"): (
        "6b7ef49472d9a1c99d4a9f514e620012f4526168a9df2c7a239cc54d8dd35376"
    ),
    ("standard", 3, "quick"): (
        "94e2108d4ecb65d1925613ec29070c9dfbe0da52d39b658cae88976643ae2e51"
    ),
    ("standard", 4, "quick"): (
        "0af12f13aa9420ff2792cfba9eb60684d39b638e8e9d8fb06df05ed0c0f3fd72"
    ),
    ("standard", 5, "quick"): (
        "bdc3d6684de25e63f0f8637480cf716f25253327987bebb8ec9d7df68cdb47dd"
    ),
    ("resize", 1, "mini"): (
        "1bff8b98082f252e514ebf1c1918c1209ac3ae47cec6d1c92031c7fed760e9f4"
    ),
    ("autoscale", 1, "mini"): (
        "dc96a5fb4b902ad648698050a3f9a569846e8f201e149745cea2770a1bf1f27b"
    ),
    ("autoscale-brownout", 1, "mini"): (
        "621f77d959c54831cabbe0a6f3706bedf8a5209e855f04a44aedd9cf4f0c9c40"
    ),
}
# the same scenarios -> the port's event-trace hash: its teardown
# makes two accelerator reads fewer than the reference's and its staged
# create two chain reads fewer, and every scenario creates and deletes
# objects (tests/test_torch_sim.py holds each run to the reference's
# outcome)
PORT_FUZZ_PINS = {
    ("standard", 1, "quick"): (
        "cc1a56bbda481217c9bf7a080defe75d99d0be9b77c0c0df03b6937303354da1"
    ),
    ("standard", 2, "quick"): (
        "2facba7c7d49fad784b0e3a5fb4b077917f70205ac169390a9351faef3d341f9"
    ),
    ("standard", 3, "quick"): (
        "c176b77042fa0a1823012883fd5cb9dd7c965993d55124be8b6d7a501122320c"
    ),
    ("standard", 4, "quick"): (
        "efff544fd30da0f4db7beed58d9f94bf8f39d95d3cda053ad1020767e9d74a39"
    ),
    ("standard", 5, "quick"): (
        "9dc92c12761d5835dd509031f334b170006d6b395db5b6b115d7b220f3d2f2c6"
    ),
    ("resize", 1, "mini"): (
        "27e5f94a0668f6d97e7baef6de5ef6991d3d98766056c313e0048909a39aee4d"
    ),
    ("autoscale", 1, "mini"): (
        "a8f3c5053826763de95bb4bfa67e32ec760ef943e757610fe2e9460aad36be4c"
    ),
    ("autoscale-brownout", 1, "mini"): (
        "4ab2cdb59a17ecc007e4c3c31298906f1f4bd4dbe85d369db3ded51beb03460e"
    ),
}
# Services in the rollout -> the reference's event-trace hash
ROLLOUT_PINS = {
    10_000: "29dc7b0962778f0abe088d1b37bbe44a1a82873a15346f6924723883a9f98abd",
}
# the same rollout -> the port's event-trace hash: every Service's
# staged create makes two chain reads fewer than the reference's
PORT_ROLLOUT_PINS = {
    10_000: "be3f1d5cd9902e9a69544f7dcd855ec5b4771280b9fe0c24a69bc3d77fbc5b32",
}
# the two-shard soak (tests/test_sharding_sim.py, TestTwoShardSoak): a
# replica is killed at virtual hour 3, the world runs 6 virtual hours,
# then to quiescence within 6 more
SHARD_SOAK_KILL_AT = 3 * 3600.0
SHARD_SOAK_SECONDS = 6 * 3600.0
# Services in the soak -> the reference's event-trace hash
SHARD_SOAK_PINS = {
    10_000: "6b163afcab7a96bd0b0256e7bb3f4d477b31938984c95a5aa1d5311e1df67990",
}
# the same soak -> the port's event-trace hash (as PORT_ROLLOUT_PINS)
PORT_SHARD_SOAK_PINS = {
    10_000: "f52003fbea9e5938aa1b91454a469d45feccf56c30e7da060a1006174ef8db55",
}

# the analysis phase: the chaos tier's fault plan (tests/test_chaos_e2e.py),
# with a budget of 5 faults per object of the fleet (1200 at 200 Services;
# the tier's own is about 6): a budget spread over fewer objects piles
# the faults on each key, whose backoff then outgrows the stall limit
CHAOS = {"seed": 20260729, "p": 0.25, "ambiguous": 0.4}
CHAOS_FAULTS_PER_OBJECT = 5
PORT_BASELINE = REPO / PORT / "analysis" / "baseline.json"
WORKFLOWS = REPO / ".github" / "workflows"

# the graft phase's multi-chip dry run, on the CPU as the JAX program's
# runs on virtual CPU devices
DRYRUN_DEVICES = 8


class PhaseError(RuntimeError):
    """A phase's check failed."""


# ---------------------------------------------------------------------------
# the fleet: bench.py's workload objects, built from a given package
# ---------------------------------------------------------------------------

def load(package: str = PORT) -> types.SimpleNamespace:
    """The modules the fleet and the sim phase need, from ``package``."""
    mod = lambda name: importlib.import_module(f"{package}.{name}")
    return types.SimpleNamespace(
        apis=mod("apis"),
        egb=mod("apis.endpointgroupbinding"),
        objects=mod("cluster.objects"),
        cluster=mod("cluster"),
        aws=mod("cloudprovider.aws"),
        health=mod("cloudprovider.aws.health"),
        controllers=mod("controllers"),
        leaderelection=mod("leaderelection"),
        manager=mod("manager"),
        errors=mod("errors"),
        rest=mod("cluster.rest"),
        serde=mod("cluster.serde"),
        testserver=mod("cluster.testserver"),
        fake_backend=mod("cloudprovider.aws.fake_backend"),
        fleet=mod("observability.fleet"),
        harness=mod("sim.harness"),
        oracles=mod("sim.oracles"),
        replay=mod("sim.replay"),
        fuzz=mod("sim.fuzz"),
        ring=mod("sharding.ring"),
        sharding=mod("sharding"),
        slo=mod("observability.slo"),
        profile=mod("observability.profile"),
        awstypes=mod("cloudprovider.aws.types"),
    )


def scaled_counts(n: int) -> tuple[int, int]:
    """(n_ingresses, n_bindings) for a fleet of ``n`` Services."""
    return max(1, n // 10), max(1, n // 10)


def service_lb(i: int) -> tuple[str, str]:
    name = f"bench{i:04d}"
    return name, f"{name}-0123456789abcdef.elb.{REGION}.amazonaws.com"


def alb(j: int) -> tuple[str, str]:
    name = f"k8s-ns{j % 10}-ing{j:04d}-0a1b2c3d4e"
    return name, f"{name}-111222333.{REGION}.elb.amazonaws.com"


def make_service(pkg, i: int):
    o, apis = pkg.objects, pkg.apis
    name, host = service_lb(i)
    svc = o.Service(
        metadata=o.ObjectMeta(
            name=name,
            namespace=f"ns{i % 10}",
            annotations={
                apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
                apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external",
                apis.ROUTE53_HOSTNAME_ANNOTATION: f"{name}.z{i % N_ZONES}.bench.example.com",
            },
        ),
        spec=o.ServiceSpec(
            type="LoadBalancer", ports=[o.ServicePort(name="http", port=80, protocol="TCP")]
        ),
    )
    svc.status.load_balancer.ingress.append(o.LoadBalancerIngress(hostname=host))
    return svc


def make_ingress(pkg, j: int):
    """An annotated ALB Ingress; even ``j`` names its ports in the
    listen-ports annotation, odd ``j`` derives them from its rules."""
    o, apis = pkg.objects, pkg.apis
    annotations = {
        apis.INGRESS_CLASS_ANNOTATION: "alb",
        apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
        apis.ROUTE53_HOSTNAME_ANNOTATION: f"ing{j:04d}.z{j % N_ZONES}.bench.example.com",
    }
    if j % 2 == 0:
        annotations[apis.ALB_LISTEN_PORTS_ANNOTATION] = '[{"HTTP": 80}, {"HTTPS": 443}]'
    backend = o.IngressBackend(
        service=o.IngressServiceBackend(name="backend", port=o.ServiceBackendPort(number=80))
    )
    ing = o.Ingress(
        metadata=o.ObjectMeta(name=f"ing{j:04d}", namespace=f"ns{j % 10}", annotations=annotations),
        spec=o.IngressSpec(
            ingress_class_name="alb",
            rules=[
                o.IngressRule(
                    host=f"ing{j:04d}.bench.example.com",
                    http=o.HTTPIngressRuleValue(paths=[o.HTTPIngressPath(path="/", backend=backend)]),
                )
            ],
        ),
    )
    ing.status.load_balancer.ingress.append(o.IngressLoadBalancerIngress(hostname=alb(j)[1]))
    return ing


def make_binding(pkg, k: int, endpoint_group_arn: str):
    egb = pkg.egb
    return egb.EndpointGroupBinding(
        metadata=pkg.objects.ObjectMeta(name=f"binding{k:04d}", namespace=f"ns{k % 10}"),
        spec=egb.EndpointGroupBindingSpec(
            endpoint_group_arn=endpoint_group_arn,
            weight=100,
            service_ref=egb.ServiceReference(name=f"bench{k:04d}"),
        ),
    )


def prepare_aws(pkg, aws, n: int, n_ing: int, n_egb: int) -> tuple[list, list[str]]:
    """Register the load balancers and hosted zones, and build one
    out-of-band accelerator chain per binding (cluster tag
    ``external``, so the controllers never touch it)."""
    for i in range(n):
        aws.add_load_balancer(service_lb(i)[0], REGION, service_lb(i)[1])
    for j in range(n_ing):
        aws.add_load_balancer(alb(j)[0], REGION, alb(j)[1])
    zones = [aws.add_hosted_zone(f"z{k}.bench.example.com") for k in range(N_ZONES)]
    return zones, external_chains(pkg, aws, n_egb)


def external_chains(pkg, aws, n_egb: int) -> list[str]:
    """Build ``n_egb`` out-of-band accelerator chains, each behind a load
    balancer of its own, with the cluster tag ``external`` (so the
    controllers never touch them); their endpoint groups' ARNs."""
    driver = pkg.aws.AWSDriver(aws, aws, aws)
    o = pkg.objects
    group_arns = []
    for k in range(n_egb):
        name = f"ext{k:04d}"
        host = f"{name}-fedcba9876543210.elb.{REGION}.amazonaws.com"
        aws.add_load_balancer(name, REGION, host)
        svc = o.Service(
            metadata=o.ObjectMeta(name=name, namespace="external"),
            spec=o.ServiceSpec(
                type="LoadBalancer", ports=[o.ServicePort(name="http", port=80, protocol="TCP")]
            ),
        )
        svc.status.load_balancer.ingress.append(o.LoadBalancerIngress(hostname=host))
        arn, _, _ = driver.ensure_global_accelerator_for_service(
            svc, svc.status.load_balancer.ingress[0], "external", name, REGION
        )
        listener = driver.get_listener(arn)
        group_arns.append(driver.get_endpoint_group(listener.listener_arn).endpoint_group_arn)
    return group_arns


class Fleet:
    """One fleet's world: the fake apiserver, the fake AWS backend and
    the convergence odometer over them."""

    def __init__(self, pkg, n: int):
        self.pkg, self.n = pkg, n
        self.n_ing, self.n_egb = scaled_counts(n)
        self.cluster = pkg.cluster.FakeCluster()
        # n Services + n_ing Ingresses by the controllers, n_egb
        # out-of-band chains, and bench.py's headroom of 50
        self.aws = pkg.aws.FakeAWSBackend(quota_accelerators=n + self.n_ing + self.n_egb + 50)
        self.zones, self.group_arns = prepare_aws(pkg, self.aws, n, self.n_ing, self.n_egb)
        self.base_chain = self.aws.chain_counts()
        self.binding_keys: list[tuple[str, str]] = []

    @property
    def n_objects(self) -> int:
        return self.n + self.n_ing + self.n_egb

    def create_objects(self) -> None:
        for i in range(self.n):
            self.cluster.create("Service", make_service(self.pkg, i))
        for j in range(self.n_ing):
            self.cluster.create("Ingress", make_ingress(self.pkg, j))
        for k in range(self.n_egb):
            binding = make_binding(self.pkg, k, self.group_arns[k])
            self.cluster.create("EndpointGroupBinding", binding)
            self.binding_keys.append((binding.metadata.namespace, binding.metadata.name))

    def progress(self) -> tuple:
        """((accelerators, listeners, endpoint groups), records, bound
        bindings), read from the backend's own tables."""
        bound = sum(
            1
            for ns, name in self.binding_keys
            if len(self.cluster.get("EndpointGroupBinding", ns, name).status.endpoint_ids) == 1
        )
        records = sum(len(self.aws.records_in_zone(z.id)) for z in self.zones)
        return self.aws.chain_counts(), records, bound

    def activity(self) -> tuple[int, int]:
        """(AWS calls, Events) so far."""
        return len(self.aws.calls), len(self.cluster.list("Event")[0])

    def converged(self) -> bool:
        """``bench.py``'s criterion: every chain complete, every TXT+A
        pair written, every binding bound to exactly one endpoint."""
        chain, records, bound = self.progress()
        target = self.n + self.n_ing
        return (
            all(have >= base + target for have, base in zip(chain, self.base_chain))
            and records >= 2 * target
            and bound == len(self.binding_keys)
        )


def converge(
    pkg,
    n: int,
    accelerator_missing_retry: float = ACCELERATOR_MISSING_RETRY,
    chaos: dict | None = None,
) -> tuple[Fleet, float]:
    """Converge a fleet of ``n`` Services through ``pkg``'s Manager, then
    stop the Manager and join every thread it started.  ``chaos`` holds
    the arguments of the fake backend's seeded chaos fault plan,
    installed once the out-of-band chains are built.  Returns the fleet
    and the seconds from the objects' creation to convergence."""
    controllers, manager_mod = pkg.controllers, pkg.manager
    fleet = Fleet(pkg, n)
    if chaos is not None:
        # this thread, which reads the odometer, stays exempt
        fleet.aws.install_fault_plan().chaos(**chaos)
    config = manager_mod.ControllerConfig(
        global_accelerator=controllers.GlobalAcceleratorConfig(
            workers=WORKERS, queue_qps=QUEUE_QPS, queue_burst=QUEUE_BURST
        ),
        route53=controllers.Route53Config(
            workers=WORKERS, queue_qps=QUEUE_QPS, queue_burst=QUEUE_BURST
        ),
        endpoint_group_binding=controllers.EndpointGroupBindingConfig(
            workers=WORKERS, queue_qps=QUEUE_QPS, queue_burst=QUEUE_BURST
        ),
    )
    aws = fleet.aws
    stop = threading.Event()
    before = set(threading.enumerate())
    manager = manager_mod.Manager(resync_period=RESYNC_PERIOD)
    try:
        manager.run(
            fleet.cluster,
            config,
            stop,
            cloud_factory=lambda region: pkg.aws.AWSDriver(
                aws, aws, aws, accelerator_missing_retry=accelerator_missing_retry
            ),
            block=False,
        )
        fleet.create_objects()
        start = time.monotonic()
        last, last_change = fleet.progress(), start
        while not fleet.converged():
            now = time.monotonic()
            cur = fleet.progress()
            if cur != last:
                last, last_change = cur, now
            if now - start > CONVERGE_DEADLINE or now - last_change > STALL_AFTER:
                raise PhaseError(
                    f"fleet did not converge: (chains, records, bound)={cur!r}, "
                    f"base chains {fleet.base_chain}, target +{n + fleet.n_ing} chains, "
                    f"{2 * (n + fleet.n_ing)} records, {len(fleet.binding_keys)} bound"
                )
            time.sleep(0.05)
        elapsed = time.monotonic() - start
        # let in-flight reconciles finish their trailing writes and
        # events before stopping: quiet = no new AWS call or Event
        quiet_since, seen = time.monotonic(), fleet.activity()
        while time.monotonic() - quiet_since < QUIET:
            time.sleep(0.05)
            if fleet.activity() != seen:
                quiet_since, seen = time.monotonic(), fleet.activity()
            if time.monotonic() - start > CONVERGE_DEADLINE:
                raise PhaseError("fleet converged but never went quiet")
    finally:
        stop.set()
        stragglers = _join_new_threads(before)
    if stragglers:
        raise PhaseError(f"threads still running after stop: {stragglers}")
    return fleet, elapsed


def _join_new_threads(before: set) -> list[str]:
    """Join every thread started since ``before``; the names of the
    controller threads and reconcile workers that did not end."""
    end = time.monotonic() + JOIN_TIMEOUT
    for thread in set(threading.enumerate()) - before:
        thread.join(timeout=max(0.0, end - time.monotonic()))
    return sorted(
        t.name
        for t in set(threading.enumerate()) - before
        if "-worker-" in t.name or t.name.endswith("-controller")
    )


# ---------------------------------------------------------------------------
# the process drills: a package's command line against an HTTP apiserver
# ---------------------------------------------------------------------------

def make_process_service(pkg, i: int):
    """``make_service``'s NLB Service, hostname-annotated (in
    ``SERVICE_ZONE``) only when ``i`` is a multiple of 20."""
    svc = make_service(pkg, i)
    annotations = svc.metadata.annotations
    del annotations[pkg.apis.ROUTE53_HOSTNAME_ANNOTATION]
    if i % 20 == 0:
        annotations[pkg.apis.ROUTE53_HOSTNAME_ANNOTATION] = f"{svc.metadata.name}.{SERVICE_ZONE}"
    return svc


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http(url: str, review: dict | None = None, timeout: float = 10.0) -> bytes:
    data = None if review is None else json.dumps(review).encode()
    request = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=timeout) as response:
        return response.read()


def _get_json(url: str):
    """A JSON endpoint's body, also when it answers 503 (``/readyz``
    does while a circuit is open)."""
    try:
        return json.loads(_http(url))
    except urllib.error.HTTPError as err:
        return json.loads(err.read())


def family_sums(maps) -> dict[str, float]:
    """Per-key sums over ``maps`` (AWS calls or AIMD ceilings by service
    family, calls by operation)."""
    out: dict[str, float] = {}
    for counts in maps:
        for key, value in counts.items():
            out[key] = out.get(key, 0.0) + value
    return out


def scrape_replica(port: int, metrics: bool = True) -> dict:
    """One replica as an operator scrapes it, ``bench.py``'s reads: AWS
    calls per service family and per operation off ``/metrics`` (``at``:
    the monotonic second it answered), AIMD ceilings per family off
    ``/readyz`` and the ``sharding`` and ``gc`` blocks of ``/healthz``.
    Without ``metrics``, the last two only."""
    out: dict = {}
    if metrics:
        text = _http(f"http://127.0.0.1:{port}/metrics").decode()
        out["at"] = time.monotonic()
        calls: dict[str, float] = {}
        ops: dict[str, float] = {}
        for line in text.splitlines():
            if line.startswith("agac_aws_api_calls_total{"):
                labels, _, value = line.rpartition(" ")
                # elbv2[region] folds into elbv2: the budget is per family
                family = labels.split('service="')[1].split('"')[0].split("[", 1)[0]
                calls[family] = calls.get(family, 0.0) + float(value)
                op = labels.split('op="')[1].split('"')[0]
                ops[op] = ops.get(op, 0.0) + float(value)
        out.update(calls=calls, ops=ops, metrics=text)
    ceilings: dict[str, float] = {}
    for service, snap in _get_json(f"http://127.0.0.1:{port}/readyz").get("services", {}).items():
        if "aimd_ceiling" in snap:
            family = service.split("[", 1)[0]
            ceilings[family] = ceilings.get(family, 0.0) + snap["aimd_ceiling"]
    health = _get_json(f"http://127.0.0.1:{port}/healthz")
    return {**out, "ceilings": ceilings, "sharding": health["sharding"], "gc": health.get("gc")}


def stage_catalog(pkg, texts: list[str]) -> list[str]:
    """The stages the stage accountant charged in replicas' ``/metrics``
    texts (``observability.profile.attribution_from_exposition``)."""
    rows = pkg.profile.attribution_from_exposition("\n".join(texts))
    return sorted(row["stage"] for row in rows)


def cpu_seconds(pid: int) -> float:
    """User and system CPU seconds process ``pid`` has used so far."""
    fields = pathlib.Path(f"/proc/{pid}/stat").read_text().rpartition(")")[2].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class Child:
    """One command-line process of the package.  Its output goes to
    files: a pipe that nobody drains would fill and block it."""

    def __init__(self, name: str, argv: list[str], env: dict, workdir: pathlib.Path):
        self.name = name
        self.err_path = workdir / f"{name}.stderr"
        with open(workdir / f"{name}.stdout", "w") as out, open(self.err_path, "w") as err:
            self.popen = subprocess.Popen(
                argv, cwd=REPO, env=env, stdin=subprocess.DEVNULL, stdout=out, stderr=err
            )

    def stderr(self) -> str:
        return self.err_path.read_text(errors="replace")

    def check_alive(self) -> None:
        """Fail when the process has exited."""
        if self.popen.poll() is not None:
            raise PhaseError(
                f"{self.name} exited early with {self.popen.returncode}: {self.stderr()[-3000:]}"
            )

    def terminate(self) -> int:
        """SIGTERM, then the exit status within ``EXIT_DEADLINE``."""
        self.check_alive()
        self.popen.send_signal(signal.SIGTERM)
        try:
            return self.popen.wait(timeout=EXIT_DEADLINE)
        except subprocess.TimeoutExpired:
            raise PhaseError(f"{self.name} still running {EXIT_DEADLINE} s after SIGTERM") from None

    def kill(self) -> None:
        if self.popen.poll() is None:
            self.popen.kill()
            self.popen.wait(timeout=EXIT_DEADLINE)


def write_kubeconfig(workdir: pathlib.Path, server_url: str) -> pathlib.Path:
    """A kubeconfig in ``workdir`` whose one context is ``server_url``."""
    path = workdir / "kubeconfig"
    path.write_text(json.dumps({
        "current-context": "smoke",
        "contexts": [{"name": "smoke", "context": {"cluster": "smoke", "user": "smoke"}}],
        "clusters": [{"name": "smoke", "cluster": {"server": server_url}}],
        "users": [{"name": "smoke", "user": {}}],
    }))
    return path


class BudgetWatch:
    """A fleet's AWS call rates and summed AIMD ceilings, held to
    ``SHARD_BUDGET_QPS`` per service family at every read: each rate is
    a replica's calls since its previous read (since its start, at its
    first), summed over the replicas read, and the ceilings are summed
    over them.  A read less than ``BUDGET_WINDOW`` s after the previous
    one of a replica leaves that replica's window open to its next read:
    two reads back to back would divide a few calls by milliseconds.
    Keeps the largest of each seen (``rates_max``, ``ceilings_max``)."""

    def __init__(self, phase: str):
        self.phase = phase
        self.rates_max: dict[str, float] = {}
        self.ceilings_max: dict[str, float] = {}
        self._last: dict[int, tuple[float, dict]] = {}

    def started(self, replica: int, at: float) -> None:
        """Replica ``replica`` started at ``at`` (monotonic s): its
        counters are 0 there."""
        self._last[replica] = (at, {})

    def hold(self, scrapes: dict[int, dict]) -> None:
        """Hold one read: ``scrapes``, ``scrape_replica`` per replica (a
        read without ``/metrics`` holds the ceilings only)."""
        rates: dict[str, float] = {}
        for r, scrape in scrapes.items():
            then, before = self._last[r]
            if "calls" not in scrape or scrape["at"] - then < BUDGET_WINDOW:
                continue
            for family, count in scrape["calls"].items():
                delta = count - before.get(family, 0.0)
                rates[family] = rates.get(family, 0.0) + delta / (scrape["at"] - then)
            self._last[r] = (scrape["at"], scrape["calls"])
        ceilings = family_sums(scrape["ceilings"] for scrape in scrapes.values())
        for most, values in ((self.rates_max, rates), (self.ceilings_max, ceilings)):
            for family, value in values.items():
                most[family] = max(most.get(family, 0.0), value)
        if any(v > SHARD_BUDGET_QPS * 1.001 for v in [*rates.values(), *ceilings.values()]):
            raise PhaseError(
                f"{self.phase}: call rates {rates} or summed AIMD ceilings {ceilings} exceed "
                f"{SHARD_BUDGET_QPS}/s per service"
            )


class ProcessFleet:
    """The lifecycle every process drill shares, as a context manager:
    an in-process ``TestApiServer`` with a kubeconfig (``kubeconfig``)
    and a client (``client``) for it; the package's command-line
    children (``spawn`` for the replicas, ``start`` for any other);
    waits that fail as soon as a child exits that was not killed here,
    or the account holds more than ``chains`` complete chains, or a
    deadline passes; reads of the live replicas that hold the fleet's
    AWS budget (``BudgetWatch``); a SIGKILL to one replica and the
    survivor's takeover; and SIGTERM at the end, with every exit status
    and every child's stderr checked.  Leaving it kills every child and
    stops the server.

    With ``owners_only`` the AIMD ceilings are summed over shard owners
    alone, where replicas outnumber shards: ``docs/operations.md``
    ("Quota division") states the fleet bound over them, and a replica
    that holds no shard idles at its limiter's 0.5/s floor with no key
    to call AWS for."""

    def __init__(self, pkg, phase: str, workdir: pathlib.Path, env: dict,
                 chains: int | None = None, owners_only: bool = False):
        self.pkg, self.phase, self.workdir, self.env = pkg, phase, workdir, env
        self.limit, self.owners_only = chains, owners_only
        state = env.get("AGAC_FAKE_STATE")
        self.aws = pkg.fake_backend.FileBackedFakeAWSBackend(state) if state else None
        self.budget = BudgetWatch(phase)
        self.children: list[Child] = []
        self.killed: list[Child] = []
        self.ports: list[int] = []
        self.live: list[int] = []  # the replicas not killed
        self.killed_at = 0.0

    def __enter__(self) -> "ProcessFleet":
        self.server = self.pkg.testserver.TestApiServer().start()
        try:
            self.kubeconfig = write_kubeconfig(self.workdir, self.server.url)
            self.client = self.pkg.rest.RestClusterClient(self.server.url)
        except BaseException:
            self.server.stop()
            raise
        return self

    def __exit__(self, *exc) -> None:
        for child in self.children:
            child.kill()
        self.server.stop()

    def start(self, name: str, argv: list[str]) -> Child:
        child = Child(name, argv, self.env, self.workdir)
        self.children.append(child)
        return child

    def spawn(self, count: int, argv) -> float:
        """Start ``count`` replicas, each as ``argv(port)`` with a free
        health port; the monotonic second they started."""
        self.ports = [_free_port() for _ in range(count)]
        self.live = list(range(count))
        spawned = time.monotonic()
        for replica, port in enumerate(self.ports):
            self.budget.started(replica, spawned)
            self.start(f"controller-{replica}", argv(port))
        return spawned

    def chains(self) -> tuple[int, int, int]:
        """The account's complete chains; more than ``chains`` fails."""
        counts = self.aws.chain_counts()
        if self.limit is not None and max(counts) > self.limit:
            raise PhaseError(f"{self.phase}: chain counts {counts} exceed {self.limit}: duplicates")
        return counts

    def wait(self, what: str, probe, start: float, every: float = 0.25,
             deadline: float = PROCESS_DEADLINE):
        """Poll ``probe`` every ``every`` s until it returns a true value,
        and return that; fail when a child not killed here has exited,
        when the account holds too many chains, and once ``deadline`` s
        have passed since ``start``."""
        while True:
            if time.monotonic() - start > deadline:
                raise PhaseError(f"{self.phase}: no {what} within {deadline} s")
            for child in self.children:
                if child not in self.killed:
                    child.check_alive()
            if self.limit is not None:
                self.chains()
            value = probe()
            if value:
                return value
            time.sleep(every)

    def placement(self, shards: set, balanced: bool = False) -> dict | None:
        """The shards each live replica holds by its ``/healthz`` once
        every one of ``shards`` is held (with ``balanced``, one by each
        replica), else None.  With no key placed yet, placement has
        nothing to balance: a replica that started first may claim every
        shard before the other is up, and sheds one only once the
        fleet's keys weigh."""
        try:
            owned = {
                r: set(_get_json(f"http://127.0.0.1:{self.ports[r]}/healthz")["sharding"].get("owned", ()))
                for r in self.live
            }
        except OSError:
            return None
        if set().union(*owned.values()) != shards:
            return None
        return owned if not balanced or all(len(o) == 1 for o in owned.values()) else None

    def read(self, metrics: bool = True) -> dict[int, dict] | None:
        """Every live replica as ``scrape_replica`` reads it, the budget
        held; None while one does not answer."""
        try:
            before = {
                r: _get_json(f"http://127.0.0.1:{self.ports[r]}/healthz")["sharding"].get("owned")
                for r in (self.live if self.owners_only else ())
            }
            scrapes = {r: scrape_replica(self.ports[r], metrics) for r in self.live}
        except OSError:
            return None
        held = scrapes
        if self.owners_only:
            # an owner held a shard both before and after its ceilings
            # were read: a replica that claims its first shard in between
            # was read at the floor, not at its slice
            held = {
                r: {**s, "ceilings": s["ceilings"] if before[r] and s["sharding"].get("owned") else {}}
                for r, s in scrapes.items()
            }
        self.budget.hold(held)
        return scrapes

    def create(self, kind: str, objects: list, before=None) -> None:
        """Create ``objects`` of ``kind``, ``RESIZE_BATCH`` at a time,
        calling ``before()`` ahead of each; a reset connection is tried
        again (the test apiserver's accept backlog overflows under the
        replicas' own requests), and an object a lost answer created
        counts."""
        def one(obj) -> None:
            if before is not None:
                before()
            for attempt in range(3):
                try:
                    self.client.create(kind, obj)
                    return
                except self.pkg.errors.AlreadyExistsError:
                    if not attempt:
                        raise
                    return
                except ConnectionError:
                    if attempt == 2:
                        raise
                    time.sleep(0.1)

        with concurrent.futures.ThreadPoolExecutor(max_workers=RESIZE_BATCH) as pool:
            list(pool.map(one, objects))

    def holder(self, shard: int, shards: set) -> tuple[int, list[int]]:
        """The live replica holding ``shard`` once all of ``shards`` are
        held, and the shards it holds."""
        owned = self.wait(
            f"read of shards {sorted(shards)} held", lambda: self.placement(shards), time.monotonic()
        )
        (replica,) = [r for r in self.live if shard in owned[r]]
        return replica, sorted(owned[replica])

    def kill(self, replica: int) -> dict:
        """SIGKILL live replica ``replica`` after one last read of it (the
        budget held); that read."""
        last = scrape_replica(self.ports[replica])
        self.budget.hold({replica: last})
        child = self.children[replica]
        child.popen.send_signal(signal.SIGKILL)
        child.popen.wait(timeout=EXIT_DEADLINE)
        self.killed_at = time.monotonic()
        self.killed.append(child)
        self.live.remove(replica)
        return last

    def takeover(self, done) -> float:
        """Wait until ``done`` holds for the survivor's ``/healthz``
        sharding block, each read holding the budget; the seconds since
        the kill."""
        (survivor,) = self.live

        def probe() -> bool:
            views = self.read()
            return views is not None and done(views[survivor]["sharding"])

        self.wait("takeover by the survivor", probe, self.killed_at)
        return time.monotonic() - self.killed_at

    def explained(self, keys):
        """A probe: true once every one of ``keys`` has been answered
        ``converged`` by some live replica's ``/debug/explain`` (a donor
        may still hold the journey of a key it stopped serving at its
        drain; the owner's answer is the one that counts)."""
        pending = set(keys)

        def probe() -> bool:
            for key in sorted(pending):
                for r in self.live:
                    answer = json.loads(_http(f"http://127.0.0.1:{self.ports[r]}/debug/explain?key={key}"))
                    if answer["verdict"] == "converged":
                        pending.discard(key)
                        break
            return not pending

        return probe

    def idle(self, within: float = PROCESS_DEADLINE) -> dict[int, dict]:
        """Wait, at most ``within`` s, until no live replica has a
        journey in flight (count and oldest age 0); that read."""
        def probe() -> dict | None:
            views = self.read()
            if views is None or any(replica_journeys(v["metrics"]) != (0, 0.0) for v in views.values()):
                return None
            return views

        return self.wait("live replica free of journeys in flight", probe, time.monotonic(),
                         deadline=within)

    def terminate(self, order: list[Child] | None = None, want: dict | None = None) -> dict:
        """SIGTERM ``order`` (the live replicas), each within
        ``EXIT_DEADLINE``; each must exit as ``want`` says (0 by
        default), and no child's stderr may hold a traceback.  The exit
        statuses."""
        order = [self.children[r] for r in self.live] if order is None else order
        exits = {child.name: child.terminate() for child in order}
        want = {child.name: 0 for child in order} if want is None else want
        tracebacks = [child.name for child in self.children if "Traceback" in child.stderr()]
        if exits != want or tracebacks:
            raise PhaseError(
                f"{self.phase}: exit statuses {exits} (want {want}), tracebacks from {tracebacks}"
            )
        return exits

    def snapshot(self) -> dict:
        """The account's state as last saved."""
        return self.pkg.fake_backend.FileBackedFakeAWSBackend(self.env["AGAC_FAKE_STATE"]).snapshot_state()


def _watch_reads(state_path: str, view, plan, shared: dict, stop, ready, out_path: str) -> None:
    """``StateWatch``'s loop, in a process of its own: read the state
    file every ``RESIZE_POLL`` s until ``stop``, each read through
    ``view``; then write its faults (at most 20), the read count, the
    longest gap between reads and what ``view`` kept to ``out_path``."""
    path = pathlib.Path(state_path)
    kept: dict = {}
    faults: list[str] = []
    polls, max_gap, previous = 0, 0.0, None
    while True:
        began = time.monotonic()
        data = json.loads(path.read_text()) if path.exists() else {}
        now = time.monotonic()
        if previous is not None:
            max_gap = max(max_gap, now - previous)
        previous, polls = now, polls + 1
        for fault in view(data, plan, kept, shared, began, now):
            if len(faults) < 20:
                faults.append(f"read {polls}: {fault}")
        ready.set()
        if stop.wait(RESIZE_POLL):
            break
    pathlib.Path(out_path).write_text(
        json.dumps({**kept, "faults": faults, "polls": polls, "max_gap_s": max_gap})
    )


class StateWatch:
    """Reads the shared account's state file every ``RESIZE_POLL`` s for
    as long as the drill lasts, in a process of its own (a thread would
    share this process's interpreter with the apiserver, which can stall
    it).  Each read goes to ``view(data, plan, kept, shared, began,
    now)``, a module-level function (spawn pickles it by name), with the
    saved state, the drill's ``plan``, a dict the view keeps across
    reads (handed back in ``result``), the values shared with the drill
    and the read's start and end (monotonic s); it returns the read's
    faults.  ``shared`` maps a name to a typecode and an initial value
    (a list for an array); the drill reads them with ``read`` and writes
    them with ``set`` and ``add``, the view under ``shared["lock"]``.
    ``check`` raises a fault of any read, or a gap between reads over
    ``RESIZE_POLL_BOUND``."""

    def __init__(self, name: str, state_path: str, view, workdir: pathlib.Path,
                 plan=None, shared: dict | None = None):
        context = multiprocessing.get_context("spawn")
        self.name = name
        self._arrays = {key for key, (_, init) in (shared or {}).items() if isinstance(init, list)}
        self._shared = {
            key: (context.Array if key in self._arrays else context.Value)(code, init, lock=False)
            for key, (code, init) in (shared or {}).items()
        }
        self._shared["lock"] = context.Lock()
        self._stop, self._ready = context.Event(), context.Event()
        self._out = workdir / f"{name}-watch.json"
        self._process = context.Process(
            target=_watch_reads, name=f"{name}-watch", daemon=True,
            args=(state_path, view, plan, self._shared, self._stop, self._ready, str(self._out)),
        )
        self.result: dict = {}

    def read(self) -> dict:
        with self._shared["lock"]:
            return {
                key: value[:] if key in self._arrays else value.value
                for key, value in self._shared.items() if key != "lock"
            }

    def set(self, key: str, value, index: int | None = None) -> None:
        with self._shared["lock"]:
            if index is None:
                self._shared[key].value = value
            else:
                self._shared[key][index] = value

    def add(self, key: str, amount: int = 1) -> None:
        with self._shared["lock"]:
            self._shared[key].value += amount

    def __enter__(self) -> "StateWatch":
        self._process.start()
        if not self._ready.wait(PROCESS_DEADLINE):
            self._process.kill()
            raise PhaseError(f"the {self.name} watch never read the state file")
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._process.join(JOIN_TIMEOUT)
        if self._process.is_alive():
            self._process.kill()
            self._process.join(JOIN_TIMEOUT)
        if self._out.exists():
            self.result = json.loads(self._out.read_text())

    def check(self) -> None:
        result = self.result
        if self._process.exitcode != 0 or not result.get("polls"):
            raise PhaseError(f"the {self.name} watch exited {self._process.exitcode}")
        if result["faults"]:
            raise PhaseError(f"the {self.name} watch: {result['faults']}")
        if result["max_gap_s"] > RESIZE_POLL_BOUND:
            raise PhaseError(
                f"the {self.name} watch went {result['max_gap_s']} s between reads "
                f"(bound {RESIZE_POLL_BOUND} s)"
            )


def owner_tag(entry: dict) -> str | None:
    """The owner tag of an accelerator entry of the state file."""
    return dict(map(tuple, entry["tags"])).get("aws-global-accelerator-owner")


def repeated_owners(accelerators: list[dict]) -> list[str]:
    """The owner tags that more than one accelerator entry carries."""
    counts = collections.Counter(owner_tag(entry) for entry in accelerators)
    return sorted(owner for owner, count in counts.items() if owner and count > 1)


def duplicate_view(data: dict, plan, kept: dict, shared: dict, began: float, now: float) -> list[str]:
    """``StateWatch``'s duplicate check: an owner tag that repeats, or
    more accelerators, listeners or endpoint groups than Services whose
    create was sent (``shared["sent"]``, read after the state: every
    accelerator in it belongs to a Service counted before)."""
    accelerators = data.get("accelerators", [])
    chains = (
        len(accelerators),
        sum(len(entry["listeners"]) for entry in accelerators),
        len(data.get("endpoint_groups", [])),
    )
    created = shared["sent"].value
    repeated = repeated_owners(accelerators)
    if repeated or max(chains) > created:
        return [f"chains {chains} for {created} Services created, owners repeated {repeated}"]
    return []


# ---------------------------------------------------------------------------
# the process phase
# ---------------------------------------------------------------------------

def _review(pkg, operation: str, old, new) -> dict:
    wire = pkg.serde.to_wire
    request = {
        "uid": f"{operation.lower()}-1",
        "kind": {"group": "operator.h3poteto.dev", "version": "v1alpha1",
                 "kind": "EndpointGroupBinding"},
        "operation": operation,
        "object": wire(new),
    }
    if old is not None:
        request["oldObject"] = wire(old)
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview", "request": request}


def _check_webhook(pkg, package: str, fleet: ProcessFleet) -> dict:
    """``python -m <package> webhook``: an ``EndpointGroupArn`` change is
    denied and a create allowed."""
    port = _free_port()
    fleet.start("webhook", [sys.executable, "-m", package, "webhook", "--ssl=false", "--port", str(port)])

    def healthy() -> bool:
        try:
            return _http(f"http://127.0.0.1:{port}/healthz") == b"ok"
        except OSError:
            return False

    fleet.wait("webhook /healthz", healthy, time.monotonic())
    url = f"http://127.0.0.1:{port}/validate-endpointgroupbinding"
    group = "arn:aws:globalaccelerator::123456789012:accelerator/a/listener/l/endpoint-group/"
    old, new = make_binding(pkg, 0, group + "1"), make_binding(pkg, 0, group + "2")
    update = json.loads(_http(url, _review(pkg, "UPDATE", old, new)))["response"]
    create = json.loads(_http(url, _review(pkg, "CREATE", None, new)))["response"]
    if update["allowed"] or update["status"]["code"] != 403 or not create["allowed"]:
        raise PhaseError(f"webhook: ARN change answered {update}, create answered {create}")
    return {"update": update["status"], "create": create["status"]}


def process(pkg, package: str, n: int, workdir: pathlib.Path) -> dict:
    """Seed an HTTP apiserver with ``n`` Services and ``n // 10``
    Ingresses, run two ``python -m <package> controller`` replicas and
    the webhook against it, require convergence read over the wire, and
    stop every child with SIGTERM.  Returns the Events as (reason, kind,
    namespace/name) triples, every object's explain verdict, and each
    child's exit status."""
    n_ing = scaled_counts(n)[0]
    services = [make_process_service(pkg, i) for i in range(n)]
    ingresses = [make_ingress(pkg, j) for j in range(n_ing)]
    objects = [("Service", s) for s in services] + [("Ingress", i) for i in ingresses]
    keys = {(kind, f"{o.metadata.namespace}/{o.metadata.name}") for kind, o in objects}
    hostname = pkg.apis.ROUTE53_HOSTNAME_ANNOTATION
    expected = {("GlobalAcceleratorCreated", kind, key) for kind, key in keys} | {
        ("Route53RecordCreated", kind, f"{o.metadata.namespace}/{o.metadata.name}")
        for kind, o in objects
        if hostname in o.metadata.annotations
    }
    lbs = [service_lb(i) for i in range(n)] + [alb(j) for j in range(n_ing)]
    zones = [SERVICE_ZONE] + [f"z{k}.bench.example.com" for k in range(N_ZONES)]
    env = dict(
        os.environ,
        AGAC_CLOUD="fake",
        AGAC_FAKE_LBS=",".join(f"{name}={host}" for name, host in lbs),
        AGAC_FAKE_ZONES=",".join(zones),
        # the controllers' n + n_ing accelerators and bench.py's headroom of 50
        AGAC_FAKE_QUOTA_ACCELERATORS=str(n + n_ing + 50),
        POD_NAMESPACE=LEASE_NAMESPACE,
    )
    with ProcessFleet(pkg, "process", workdir, env) as fleet:
        for kind, obj in objects:  # in storage, before any controller starts
            fleet.server.cluster.create(kind, obj)
        start = fleet.spawn(2, lambda port: [
            sys.executable, "-m", package, *CHART_ARGS, "--kubeconfig", str(fleet.kubeconfig),
            "--health-port", str(port),
        ])
        client = fleet.client

        def holder() -> str:
            try:
                return client.get("Lease", LEASE_NAMESPACE, LEASE_NAME).spec.holder_identity or ""
            except pkg.errors.NotFoundError:
                return ""

        leader_id = fleet.wait("Lease holder", holder, start)

        def logged_by() -> list[int]:  # each replica logs its elector identity
            line = f"leader election id: {leader_id}"
            return [replica for replica, c in enumerate(fleet.children) if line in c.stderr()]

        (leader,) = fleet.wait("leader's identity in a replica's log", logged_by, start)

        def events() -> set:
            return {
                (e.reason, e.involved_object.kind,
                 f"{e.involved_object.namespace}/{e.involved_object.name}")
                for e in client.list("Event")[0]
            }

        fleet.wait("full set of Events", lambda: expected <= events(), start)

        pending = {key for _, key in keys}
        verdicts: dict[str, str] = {}

        def converged() -> bool:
            for key in sorted(pending):
                answer = json.loads(_http(
                    f"http://127.0.0.1:{fleet.ports[leader]}/debug/explain?key={key}"
                ))
                verdicts[key] = answer["verdict"]
                if answer["verdict"] == "converged":
                    pending.discard(key)
            return not pending

        fleet.wait("converged verdict for every object", converged, start)
        seen = events()
        if holder() != leader_id:
            raise PhaseError(f"the Lease moved from {leader_id} to {holder()} during the run")
        standby = 1 - leader
        calls = [sum(scrape_replica(port)["calls"].values()) for port in fleet.ports]
        if calls[standby] != 0 or calls[leader] == 0:
            raise PhaseError(f"AWS calls per replica {calls}: the standby (replica {standby}) called AWS")
        webhook = _check_webhook(pkg, package, fleet)
        # the standby first: stopped after the leader, it may take the
        # lease the leader released and be stopped while its controllers
        # wait for their caches.  The controllers return 0 from their
        # signal handler; the webhook, like the reference's, installs
        # none and ends by SIGTERM itself
        controllers = [fleet.children[standby], fleet.children[leader]]
        exits = fleet.terminate(
            [*controllers, *fleet.children[2:]],
            {c.name: 0 for c in controllers} | {"webhook": -signal.SIGTERM},
        )
    return {
        "services": n,
        "ingresses": n_ing,
        "aws_calls": calls,
        "leader": leader,
        "webhook": webhook,
        "exits": exits,
        "events": sorted(seen),
        "verdicts": verdicts,
    }


# ---------------------------------------------------------------------------
# the shard phase: a package's sharded fleet over one durable fake account
# ---------------------------------------------------------------------------

def make_shard_service(pkg, i: int):
    """``bench.py``'s sharded-fleet Service: a managed NLB Service in
    ``default``, every one behind the one load balancer ``SHARD_LB``."""
    o, apis = pkg.objects, pkg.apis
    svc = o.Service(
        metadata=o.ObjectMeta(
            name=f"shard{i:04d}",
            namespace="default",
            annotations={
                apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
                apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external",
            },
        ),
        spec=o.ServiceSpec(
            type="LoadBalancer", ports=[o.ServicePort(name="http", port=80, protocol="TCP")]
        ),
    )
    svc.status.load_balancer.ingress.append(o.LoadBalancerIngress(hostname=SHARD_LB[1]))
    return svc


def journey_counts(pkg, texts: list[str]) -> dict:
    """Journeys closed, by trigger, and still in flight over the
    fleet-merged exposition of ``texts``."""
    families, _ = pkg.fleet.merge_expositions({f"replica-{i}": t for i, t in enumerate(texts)})
    empty = pkg.fleet.Family("")
    closed = {"spec": 0, "handoff": 0, "resize": 0}
    for sample, value in families.get("agac_journey_converge_seconds", empty).samples.items():
        for trigger in closed:
            if "_count{" in sample and f'trigger="{trigger}"' in sample:
                closed[trigger] += int(value)
    inflight = sum(families.get("agac_journey_inflight", empty).samples.values())
    return {**closed, "inflight": int(inflight)}


def shard_env(n: int, latency: float, workdir: pathlib.Path) -> dict:
    """The sharded fleet's environment (``bench.py:1389-1411``): the
    chart's no-credentials fake AWS, one durable account for every
    replica in ``workdir``, ``latency`` s per call, room for ``n``
    accelerators, the bench's AIMD budget and lease timing."""
    return dict(
        os.environ,
        AGAC_CLOUD="fake",
        AGAC_FAKE_STATE=str(workdir / "aws-state.json"),
        AGAC_FAKE_LBS="=".join(SHARD_LB),
        AGAC_FAKE_LATENCY=str(latency),
        AGAC_FAKE_QUOTA_ACCELERATORS=str(n + 20),
        AGAC_API_HEALTH_AIMD_QPS=str(SHARD_BUDGET_QPS),
        POD_NAMESPACE=LEASE_NAMESPACE,
        **SHARD_ENV,
    )


def shard_controller_argv(
    package: str,
    kubeconfig: pathlib.Path,
    port: int,
    shard_count: int,
    placement: list[str],
    queue: tuple[str, str] = ("1000", "1000"),
) -> list[str]:
    """One replica of ``bench.py``'s sharded fleet (``bench.py:1414-1427``);
    ``queue`` is its workqueues' (qps, burst)."""
    return [
        sys.executable, "-m", package, "controller", "--kubeconfig", str(kubeconfig),
        "-c", "bench-shard", "-w", str(SHARD_WORKERS),
        "--queue-qps", queue[0], "--queue-burst", queue[1],
        "--health-port", str(port), "--shard-count", str(shard_count), *placement,
    ]


def shard_fleet(
    pkg,
    package: str,
    n: int,
    width: int,
    latency: float,
    workdir: pathlib.Path,
    kill_at: float | None = None,
) -> dict:
    """``bench.py``'s sharded deployment at one width: ``width``
    ``python -m <package> controller`` replicas, one shard lease each
    (``--shard-count width``; at width 1 one replica without leader
    election), share one flock-arbitrated fake account
    (``AGAC_FAKE_STATE``) and one HTTP apiserver.  Once every shard
    lease is held, ``n`` Services on one NLB are created in parallel,
    and the fleet must converge to exactly ``n`` complete chains.

    With ``kill_at``, the replica holding shard 0 gets SIGKILL once that
    share of the chains is complete; each replica may then hold every
    shard (``--shards-per-replica width``), so the survivor can steal
    the dead replica's lease and finish the fleet.

    Hard bounds (``PhaseError``): every shard lease held by one replica;
    never more than ``n`` complete chains, and ``(n, n, n)`` at the end;
    the fleet's call rate and summed AIMD ceilings per service family
    within ``SHARD_BUDGET_QPS`` at every read (before the creates, at
    the kill, through the takeover, at the last chain and through the
    settle); ``n`` spec journeys over the fleet-merged metrics (after a
    kill: the survivor closes a journey for every Service, and none is
    counted twice as spec); after a kill, the survivor owns every shard;
    every live replica exits 0 on SIGTERM and no stderr holds a
    traceback.  Returns the run's placement, calls, journeys, kill and
    the final AWS state."""
    if width == 1:
        placement = ["--disable-leader-election"]
    else:
        placement = ["--shards-per-replica", str(width if kill_at is not None else 1)]
    shards = set(range(width))
    env = shard_env(n, latency, workdir)
    with ProcessFleet(pkg, f"{width} shards", workdir, env, chains=n) as fleet:
        spawned = fleet.spawn(
            width, lambda port: shard_controller_argv(package, fleet.kubeconfig, port, width, placement)
        )
        # one replica without leader election holds no lease: it is up once it answers
        owned = fleet.wait(
            "every shard lease held",
            lambda: fleet.placement(shards) if width > 1 else fleet.read(metrics=False) and {0: shards},
            spawned,
        )
        if sum(map(len, owned.values())) != width:
            raise PhaseError(f"{width} shards: replicas hold overlapping sets {owned}")
        start = time.monotonic()
        fleet.read()  # each read ends a window the budget holds the call rate over
        fleet.create("Service", [make_shard_service(pkg, i) for i in range(n)])
        kill, killed = None, []
        if kill_at is not None:
            chains = fleet.wait(
                f"{kill_at:g} of the chains complete",
                lambda: (counts := fleet.chains())[2] >= kill_at * n and counts, start, every=0.1,
            )
            victim, victim_owned = fleet.holder(0, shards)
            killed.append(fleet.kill(victim))
            kill = {"victim": victim, "owned": victim_owned, "chains": list(chains)}
            fleet.takeover(lambda block: set(block.get("owned", ())) == shards)
        fleet.wait(f"{n} complete chains", lambda: fleet.chains() == (n, n, n), start, every=0.1)
        fleet.read()

        def settled() -> dict | None:
            # the live replicas close a journey per Service, none in flight
            views = fleet.read()
            if views is None:
                return None
            journeys = journey_counts(pkg, [v["metrics"] for v in views.values()])
            return None if journeys["inflight"] or journeys["spec"] + journeys["handoff"] < n else views

        views = fleet.wait("every journey closed", settled, start)
        if fleet.chains() != (n, n, n):
            raise PhaseError(f"{width} shards: chain counts {fleet.chains()} after settling")
        # the victim's journeys as last read before the kill; its
        # journeys in flight then died with it, and the survivor's
        # takeover resync closes them as handoff journeys
        scrapes = [*views.values(), *killed]
        journeys = journey_counts(pkg, [s["metrics"] for s in scrapes])
        journeys["inflight"] = 0  # on the live replicas, as settled() waited for
        if not (journeys["spec"] == n if kill is None else journeys["spec"] <= n):
            raise PhaseError(f"{width} shards: {journeys['spec']} spec journeys for {n} Services")
        if kill is not None:
            (survivor,) = fleet.live
            kill["survivor_owned"] = sorted(views[survivor]["sharding"]["owned"])
            if set(kill["survivor_owned"]) != shards:
                raise PhaseError(f"after the kill the survivor owns {kill['survivor_owned']}")
        exits = fleet.terminate()
    return {
        "width": width,
        "services": n,
        "latency_s": latency,
        "owned": [sorted(owned[r]) for r in sorted(owned)],
        "aws_calls": {f: int(c) for f, c in sorted(family_sums(s["calls"] for s in scrapes).items())},
        "aimd_ceiling_sums": dict(sorted(family_sums(v["ceilings"] for v in views.values()).items())),
        "call_rates_max": dict(sorted(fleet.budget.rates_max.items())),
        "journeys": journeys,
        "kill": kill,
        "exits": exits,
        "aws_state": fleet.snapshot(),
    }


# ---------------------------------------------------------------------------
# the resize phase: the live elastic resize over a package's controller processes
# ---------------------------------------------------------------------------

def resize_cli(package: str, kubeconfig: pathlib.Path, count: int, epoch: int, env: dict) -> str:
    """``python -m <package> resize-shards -n count``, as the runbook
    runs it; it must exit 0 and name the new ``epoch``."""
    run = subprocess.run(
        [sys.executable, "-m", package, "resize-shards", "-n", str(count),
         "--kubeconfig", str(kubeconfig)],
        cwd=REPO, env=env, stdin=subprocess.DEVNULL, capture_output=True, text=True,
        timeout=120,
    )
    if run.returncode != 0 or f"epoch {epoch}" not in run.stdout:
        raise PhaseError(
            f"resize-shards -n {count}: exit {run.returncode}, stdout {run.stdout!r}, "
            f"stderr {run.stderr[-2000:]!r} (want exit 0 and epoch {epoch})"
        )
    return run.stdout


def moved_keys(pkg, n: int, old: int, new: int) -> int:
    """How many of the fleet's ``n`` keys the ring re-homes from
    ``old`` to ``new`` shards."""
    rings = pkg.ring.HashRing(old), pkg.ring.HashRing(new)
    keys = [f"default/{make_shard_service(pkg, i).metadata.name}" for i in range(n)]
    return sum(rings[0].shard_for_key(k) != rings[1].shard_for_key(k) for k in keys)


def resize_fleet(pkg, package: str, n: int, latency: float, workdir: pathlib.Path) -> dict:
    """The runbook's live elastic resize (``docs/operations.md:466-475``)
    on ``bench.py``'s sharded fleet: two ``python -m <package>
    controller`` replicas at ``--shard-count 2``, each allowed four
    shards (the runbook raises ``--shards-per-replica`` before growing),
    one apiserver and one flock-arbitrated fake account at ``latency``
    s per call, and ``n`` Services on one NLB.

    (a) Three quarters of the Services are created, 8 at a time, once
    shards 0 and 1 are held; when three eighths of the chains are
    complete, ``resize-shards -n 4`` runs and the rest are created
    during the transition.  (b) Both replicas must then report the new
    ring stable (``4x64``, epoch 1, no handoff pending) and own {0..3}
    between them, disjointly.  (c) ``resize-shards -n 2`` runs, and as
    soon as a replica reports ``draining`` or ``adopting`` the holder
    of shard 0 gets SIGKILL; the survivor must steal its leases and
    finish alone: stable at ``2x64``, epoch 2, owning {0, 1}.  (d) The
    survivor must exit 0 on SIGTERM.

    Hard bounds (``PhaseError``): the state file, read every
    ``RESIZE_POLL`` s through the run, never shows an owner tag twice
    or more accelerators than Services created; never more than ``n``
    complete chains, ``(n, n, n)`` after (b) and after (c); over (a) and
    (b) the fleet's ``create_accelerator`` calls equal ``n``; summed
    AIMD ceilings (at every read of the replicas) and the call rate
    since the previous read of ``/metrics`` within ``SHARD_BUDGET_QPS``
    per service; every Service's owner answering ``converged`` (no
    journey in flight) after (b) and after (c), and ``trigger=resize``
    journeys closed after (b).  Returns the run's placements, journeys,
    kill, budget maxima, the grow and shrink times (read by
    ``hack/resize_audit.py``) and the watch's reads."""
    env = shard_env(n, latency, workdir)
    first, resize_at = round(n * RESIZE_FIRST), round(n * RESIZE_AT)
    placement = ["--shards-per-replica", str(RESIZE_CAPACITY)]
    services = [make_shard_service(pkg, i) for i in range(n)]
    keys = [f"default/{svc.metadata.name}" for svc in services]
    with ProcessFleet(pkg, "resize", workdir, env, chains=n) as fleet:
        spawned = fleet.spawn(2, lambda port: shard_controller_argv(
            package, fleet.kubeconfig, port, RESIZE_FROM, placement
        ))

        def blocks() -> list[dict] | None:
            """The live replicas' ``/healthz`` sharding blocks; the
            summed AIMD ceilings are held to the budget at every read."""
            views = fleet.read(metrics=False)
            return None if views is None else [views[r]["sharding"] for r in fleet.live]

        def stable(count: int, epoch: int) -> list[dict] | None:
            seen = blocks()
            if seen is None:
                return None
            want = ("stable", f"{count}x64", 0, epoch)
            for block in seen:
                resize = block["resize"]
                if (resize["state"], resize["ring"], resize["handoff_pending"], resize["epoch"]) != want:
                    return None
            owned = [set(block["owned"]) for block in seen]
            if set().union(*owned) != set(range(count)):
                return None
            if sum(map(len, owned)) != count:
                raise PhaseError(f"resize: replicas hold overlapping sets {owned}")
            return seen

        def held() -> list[dict] | None:
            seen = blocks()
            if seen is None or set().union(*(b["owned"] for b in seen)) != {0, 1}:
                return None
            return seen

        def settled(explained):
            """A probe: once ``explained`` (every Service converged on its
            owner), the live replicas' reads and journeys."""
            def probe():
                views = fleet.read() if explained() else None
                return views and (views, journey_counts(pkg, [v["metrics"] for v in views.values()]))
            return probe

        start_blocks = fleet.wait("shard leases {0, 1} held", held, spawned)
        with StateWatch("duplicate", env["AGAC_FAKE_STATE"], duplicate_view, workdir,
                        shared={"sent": ("i", 0)}) as watch:
            def create(part: list) -> None:
                fleet.create("Service", part, before=lambda: watch.add("sent"))

            # (a) grow under load
            start = time.monotonic()
            creator = threading.Thread(target=create, args=(services[:first],), name="creator")
            creator.start()
            chains_at_grow = fleet.wait(
                f"{resize_at} complete chains",
                lambda: (counts := fleet.chains())[2] >= resize_at and counts, start,
            )
            creator.join()
            grow_at = time.monotonic()
            grow_out = resize_cli(package, fleet.kubeconfig, RESIZE_TO, 1, env)
            create(services[first:])
            # (b) the new ring, stable everywhere, and every chain complete
            grown = fleet.wait(f"ring {RESIZE_TO}x64 stable", lambda: stable(RESIZE_TO, 1), grow_at)
            grow_s = time.monotonic() - grow_at
            fleet.wait(f"{n} complete chains", lambda: fleet.chains() == (n, n, n), grow_at)
            grow_views, grow_journeys = fleet.wait(
                "Service left unconverged after the grow", settled(fleet.explained(keys)), grow_at
            )
            creates = family_sums(v["ops"] for v in grow_views.values()).get("create_accelerator", 0.0)
            if creates != n:
                raise PhaseError(f"resize: {creates} create_accelerator calls for {n} Services")
            if grow_journeys["resize"] == 0:
                trail = [
                    f"{c.name}: {line}" for c in fleet.children for line in c.stderr().splitlines()
                    if re.search(r"resize epoch|resync|shed|lease (acquired|lost|stolen)", line)
                ]
                raise PhaseError(
                    f"resize: no trigger=resize journey after the grow: {grow_journeys}; "
                    f"the replicas' placement log: {trail[-40:]}"
                )
            if fleet.chains() != (n, n, n):
                raise PhaseError(f"resize: chain counts {fleet.chains()} after the grow")

            # (c) shrink, and kill the holder of shard 0 mid-transition
            shrink_at = time.monotonic()
            resize_cli(package, fleet.kubeconfig, RESIZE_FROM, 2, env)

            def mid_transition() -> list[dict] | None:
                seen = blocks()
                if seen is None:
                    return None
                # the kill's victim holds shard 0, which is free for a moment
                # while it moves
                if any(b["resize"]["state"] in RESIZE_STATES for b in seen) and any(
                    0 in b["owned"] for b in seen
                ):
                    return seen
                if all(b["resize"]["epoch"] == 2 for b in seen):
                    raise PhaseError(f"resize: the shrink completed before the kill: {seen}")
                return None

            seen = fleet.wait("replica in the shrink", mid_transition, shrink_at, every=0.02)
            (victim,) = [r for r, b in zip(fleet.live, seen) if 0 in b["owned"]]
            kill = {
                "victim": victim,
                "states": [b["resize"]["state"] for b in seen],
                "owned": sorted(seen[fleet.live.index(victim)]["owned"]),
            }
            fleet.kill(victim)
            fleet.takeover(lambda block: stable(RESIZE_FROM, 2) is not None or all(
                block["holders"].get(str(s)) == block["identity"] for s in kill["owned"]
            ))
            shrunk = fleet.wait(
                f"survivor stable at {RESIZE_FROM}x64", lambda: stable(RESIZE_FROM, 2), fleet.killed_at
            )
            shrink_s = time.monotonic() - shrink_at
            if sorted(shrunk[0]["owned"]) != [0, 1]:
                raise PhaseError(f"resize: the survivor owns {shrunk[0]['owned']}")
            fleet.wait(f"{n} complete chains after the kill", lambda: fleet.chains() == (n, n, n),
                       fleet.killed_at)
            _, survivor_journeys = fleet.wait(
                "Service left unconverged on the survivor", settled(fleet.explained(keys)),
                fleet.killed_at,
            )
            time.sleep(2 * RESIZE_POLL)  # the watch reads the settled state once more
        watch.check()
        if fleet.chains() != (n, n, n):
            raise PhaseError(f"resize: chain counts {fleet.chains()} after the kill")
        (exit_status,) = fleet.terminate().values()
    return {
        "services": n,
        "latency_s": latency,
        "start_owned": [sorted(b["owned"]) for b in start_blocks],
        "chains_at_grow": list(chains_at_grow),
        "grow_stdout": grow_out.strip().splitlines()[-1],
        "grow_s": grow_s,
        "grown_owned": [sorted(b["owned"]) for b in grown],
        "create_accelerator": int(creates),
        "grow_journeys": grow_journeys,
        "moved_keys_grow": {"ring": moved_keys(pkg, n, RESIZE_FROM, RESIZE_TO),
                            "resize_journeys": grow_journeys["resize"]},
        "kill": kill,
        "shrink_s": shrink_s,
        "moved_keys_shrink": {
            "ring": moved_keys(pkg, n, RESIZE_TO, RESIZE_FROM),
            "survivor_resize_journeys": survivor_journeys["resize"],
        },
        "survivor_journeys": survivor_journeys,
        "call_rates_max": dict(sorted(fleet.budget.rates_max.items())),
        "aimd_ceiling_sums_max": dict(sorted(fleet.budget.ceilings_max.items())),
        "watch": {"polls": watch.result["polls"], "max_gap_s": watch.result["max_gap_s"]},
        "exit": exit_status,
    }


# ---------------------------------------------------------------------------
# the autoscale phase: the SLO autoscaler over a package's controller processes
# ---------------------------------------------------------------------------

def tree_cpu_seconds() -> float:
    """CPU seconds of this process and of its live child processes (a
    card host's ``/proc/stat`` need not move)."""
    total = sum(os.times()[:2])
    me = str(os.getpid())
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rpartition(")")[2].split()
        except OSError:
            continue  # exited meanwhile
        if fields[1] == me:
            total += (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    return total


def metric_samples(text: str, name: str) -> dict[str, float]:
    """The samples of metric ``name`` in exposition ``text``: labels -> value."""
    out = {}
    for line in text.splitlines():
        if line.startswith((name + "{", name + " ")):
            labels, _, value = line.rpartition(" ")
            out[labels[len(name):]] = float(value)
    return out


def replica_journeys(metrics: str) -> tuple[int, float]:
    """One replica's journeys in flight and its oldest one's age, s."""
    inflight = sum(metric_samples(metrics, "agac_journey_inflight").values())
    ages = metric_samples(metrics, "agac_journey_oldest_unconverged_age_seconds").values()
    return int(inflight), max(ages, default=0.0)


def autoscale_fleet(
    pkg,
    package: str,
    n_base: int,
    n_wave: int,
    latency: float,
    workdir: pathlib.Path,
    observe_only: bool,
) -> dict:
    """The reference's autoscaler canary as processes: ``AUTOSCALE_REPLICAS``
    ``python -m <package> controller --autoscale`` replicas at ``--shard-count
    2 --shards-per-replica 1`` with admission at ``AUTOSCALE_QUEUE`` (qps,
    burst), one apiserver and the shard phase's flock-arbitrated fake
    account at ``latency`` s per call.  ``n_base`` Services are created 8 at
    a time once shards 0 and 1 are held and converge; then a wave of
    ``n_wave`` more is created by 8 parallel creators, and the run goes on
    with no operator action.  ``observe_only`` arms every replica with
    ``--autoscale-observe-only``.

    Hard bounds (``PhaseError``).  Acting run: ring epoch 1 (2 -> 4 shards)
    appears within ``AUTOSCALE_REACTION_BOUND`` s of the wave's first
    create, and some replica's ``/debug/autoscaler`` holds the executed
    scale-out (target 4 from 2, reason ``age-growth`` or ``burn``); every
    replica then reports ring ``4x64`` stable at epoch 1 with {0..3} owned
    disjointly; the only other epoch allowed is 2 (4 -> 2), seen no sooner
    than ``AUTOSCALE_COOLDOWN_IN`` s after epoch 1 and only after every
    replica reported epoch 1 stable; no epoch 3.  The run ends
    ``AUTOSCALE_TAIL_S`` s after epoch 2 is stable everywhere, or
    ``AUTOSCALE_HOLD_S`` s after epoch 1 when no epoch 2 came.
    Observe-only run: the epoch stays 0, some replica records a
    scale-out suppressed by ``observe-only``, and a replica's
    ``agac_autoscaler_target_shards`` reads 4 during the wave.  Both: the
    state file, read every ``RESIZE_POLL`` s, never shows an owner tag
    twice or more accelerators than Services sent; never more than
    ``n`` complete chains, ``(n, n, n)`` at the end and ``n``
    ``create_accelerator`` calls; at every read the AIMD ceilings summed
    over shard owners, and the fleet's call rate since the previous
    read, within ``SHARD_BUDGET_QPS`` per service; every Service
    ``converged`` on its owner's ``/debug/explain``; within
    ``AUTOSCALE_SETTLE_S`` s of the last chain completing with the ring
    stable, every replica's ``agac_journey_inflight`` and oldest
    unconverged age read 0; every child exits 0 on SIGTERM.

    Times are this process's clock: ring epochs as a watch on the
    apiserver's Leases delivers them, the rest at the phase's reads
    (each replica's decision stamps are its own process's clock, and are
    not compared).  Returns the run's times and telemetry."""
    n = n_base + n_wave
    name = "observe-only" if observe_only else "acting"
    env = shard_env(n, latency, workdir)
    placement = [
        "--shards-per-replica", "1", "--autoscale",
        "--autoscale-min-shards", str(AUTOSCALE_FROM),
        "--autoscale-max-shards", str(AUTOSCALE_TO),
        "--autoscale-interval", f"{AUTOSCALE_INTERVAL:g}",
        "--slo-eval-interval", f"{AUTOSCALE_INTERVAL:g}",
        "--autoscale-cooldown-out", f"{AUTOSCALE_COOLDOWN_OUT:g}",
        "--autoscale-cooldown-in", f"{AUTOSCALE_COOLDOWN_IN:g}",
        *(["--autoscale-observe-only"] if observe_only else []),
    ]
    services = [make_shard_service(pkg, i) for i in range(n)]
    epochs: dict[int, float] = {}  # ring epoch -> this process's clock when first seen
    stable_at: dict[int, float] = {}
    target_max = 0.0
    scale_out = drained_at = calm_since = settle_s = end_at = None
    ring_name = pkg.sharding.ring_lease_name()
    ring_stop = threading.Event()
    ring_watch = None

    def watch_ring(cluster) -> None:
        """Stamp each ring epoch as the apiserver stores it: the phase's
        reads of the replicas take a while, a watch on the Leases does not."""
        for event in cluster.watch("Lease", "0", ring_stop.is_set):
            lease = event.obj
            if lease.metadata.name == ring_name:
                anns = lease.metadata.annotations or {}
                epochs.setdefault(int(anns.get(pkg.sharding.membership.ANN_EPOCH, 0) or 0),
                                  time.monotonic())

    try:
        with ProcessFleet(pkg, f"autoscale {name}", workdir, env, chains=n, owners_only=True) as fleet:
            ring_watch = threading.Thread(
                target=watch_ring, args=(fleet.server.cluster,), name="ring-watch", daemon=True
            )
            ring_watch.start()
            spawned = fleet.spawn(AUTOSCALE_REPLICAS, lambda port: shard_controller_argv(
                package, fleet.kubeconfig, port, AUTOSCALE_FROM, placement, AUTOSCALE_QUEUE
            ))

            def read() -> dict[int, dict] | None:
                """One read of the ring lease and every replica (the
                budget held); the epoch bounds are held here."""
                nonlocal target_max
                try:
                    epoch = pkg.sharding.ring_status(fleet.server.cluster)["epoch"]
                except RuntimeError:
                    return None  # no replica has created the ring lease yet
                epochs.setdefault(epoch, time.monotonic())
                if (observe_only and epoch != 0) or epoch > 2:
                    raise PhaseError(f"autoscale {name}: ring epoch {epoch} (epochs seen {sorted(epochs)})")
                views = fleet.read()
                if views is None or any("owned" not in v["sharding"] for v in views.values()):
                    return None  # a replica serves /healthz before its membership exists
                for view in views.values():
                    targets = metric_samples(view["metrics"], "agac_autoscaler_target_shards")
                    target_max = max(target_max, *targets.values(), 0.0)
                return views

            def stable(views: dict[int, dict], count: int, epoch: int) -> bool:
                want = ("stable", f"{count}x64", 0, epoch)
                for view in views.values():
                    resize = view["sharding"]["resize"]
                    if (resize["state"], resize["ring"], resize["handoff_pending"], resize["epoch"]) != want:
                        return False
                owned = [set(view["sharding"]["owned"]) for view in views.values()]
                if set().union(*owned) != set(range(count)):
                    return False
                if sum(map(len, owned)) != count:
                    raise PhaseError(f"autoscale {name}: replicas hold overlapping sets {owned}")
                return True

            def decisions(port: int) -> list[dict]:
                return _get_json(f"http://127.0.0.1:{port}/debug/autoscaler")["decisions"]

            fleet.wait("shard leases {0, 1} held",
                       lambda: (views := read()) is not None and stable(views, AUTOSCALE_FROM, 0), spawned)
            with StateWatch("duplicate", env["AGAC_FAKE_STATE"], duplicate_view, workdir,
                            shared={"sent": ("i", 0)}) as watch:
                def create(part: list) -> None:
                    fleet.create("Service", part, before=lambda: watch.add("sent"))

                base_at = time.monotonic()
                create(services[:n_base])
                fleet.wait(f"{n_base} baseline chains", lambda: fleet.chains() == (n_base,) * 3, base_at)
                pids = [child.popen.pid for child in fleet.children]
                cpu = -sum(map(cpu_seconds, pids))

                # the wave, and the run with no operator action
                wave_at = time.monotonic()
                creator = threading.Thread(target=create, args=(services[n_base:],), name="creator")
                creator.start()

                def step() -> bool:
                    """One read of the run; true at its end."""
                    nonlocal scale_out, drained_at, calm_since, settle_s, end_at
                    now = time.monotonic()
                    views = read()
                    counts = fleet.chains()
                    if views is None:
                        return False
                    epoch = max(epochs)
                    if drained_at is None and counts == (n, n, n) and not creator.is_alive():
                        drained_at = now
                    if not observe_only:
                        if 1 not in epochs and now - wave_at > AUTOSCALE_REACTION_BOUND:
                            raise PhaseError(
                                f"autoscale: no scale-out within {AUTOSCALE_REACTION_BOUND} s of the wave"
                            )
                        if 1 in epochs and scale_out is None:
                            scale_out = next((
                                {"replica": replica, **d}
                                for replica, port in enumerate(fleet.ports) for d in decisions(port)
                                if d["executed"] and d["action"] == "scale-out"
                                and d["target_shards"] == AUTOSCALE_TO
                                and d["current_shards"] == AUTOSCALE_FROM
                            ), None)
                            if scale_out is None and now - epochs[1] > 6 * AUTOSCALE_INTERVAL:
                                raise PhaseError("autoscale: ring epoch 1 without an executed scale-out")
                            if scale_out is not None and scale_out["reason"] not in ("age-growth", "burn"):
                                raise PhaseError(f"autoscale: scale-out for reason {scale_out['reason']}")
                        if 2 in epochs and not (
                            1 in stable_at and epochs[2] - epochs[1] >= AUTOSCALE_COOLDOWN_IN
                            and epochs[2] > stable_at[1]
                        ):
                            raise PhaseError(
                                f"autoscale: epoch 2 {epochs[2] - epochs.get(1, wave_at)} s after "
                                f"epoch 1 (cooldown-in {AUTOSCALE_COOLDOWN_IN} s), epoch 1 stable "
                                f"everywhere {'at ' + str(stable_at[1] - epochs[1]) if 1 in stable_at else 'never'}"
                            )
                    ring_stable = stable(views, AUTOSCALE_TO if epoch == 1 else AUTOSCALE_FROM, epoch)
                    if ring_stable and epoch not in stable_at:
                        stable_at[epoch] = now
                    # the fault-1 bound: from the first read at which the last
                    # chain is complete and the ring stable, every replica's
                    # journeys in flight reach 0 within AUTOSCALE_SETTLE_S
                    if settle_s is None and drained_at is not None and ring_stable:
                        calm_since = calm_since or now
                        journeys = [replica_journeys(v["metrics"]) for v in views.values()]
                        if all(j == (0, 0.0) for j in journeys):
                            settle_s = now - calm_since
                        elif now - calm_since > AUTOSCALE_SETTLE_S:
                            raise PhaseError(
                                f"autoscale {name}: journeys in flight (count, oldest age s) per "
                                f"replica {journeys} {now - calm_since} s after the last chain "
                                f"completed with the ring stable"
                            )
                    elif settle_s is None:
                        calm_since = None
                    if observe_only:
                        end_at = now
                    elif 2 in stable_at:
                        end_at = stable_at[2] + AUTOSCALE_TAIL_S
                    elif 2 not in epochs and 1 in epochs:
                        end_at = epochs[1] + AUTOSCALE_HOLD_S
                    return end_at is not None and now >= end_at and settle_s is not None

                fleet.wait("end of the wave's run", step, wave_at, every=AUTOSCALE_READ)
                elapsed = time.monotonic() - wave_at
                cpu += sum(map(cpu_seconds, pids))
                fleet.wait("Service left unconverged", fleet.explained(
                    f"default/{svc.metadata.name}" for svc in services
                ), time.monotonic())
                # and every replica ends with no journey in flight (after a
                # scale-in the adopters' resync runs on past the tail)
                scrapes = fleet.idle()
                histories = [decisions(port) for port in fleet.ports]
                time.sleep(2 * RESIZE_POLL)  # the watch reads the settled state once more
            watch.check()
            if fleet.chains() != (n, n, n):
                raise PhaseError(f"autoscale {name}: chain counts {fleet.chains()} at the end")
            creates = family_sums(s["ops"] for s in scrapes.values()).get("create_accelerator", 0.0)
            if creates != n:
                raise PhaseError(f"autoscale {name}: {creates} create_accelerator calls for {n} Services")
            if observe_only:
                suppressed = [
                    (r, d) for r, history in enumerate(histories) for d in history
                    if d["action"] == "scale-out" and "observe-only" in d["rails"]
                ]
                if not suppressed or target_max != AUTOSCALE_TO:
                    raise PhaseError(
                        f"autoscale observe-only: {len(suppressed)} scale-outs held by observe-only, "
                        f"target-shards gauge at most {target_max}"
                    )
            exits = fleet.terminate()
    finally:
        ring_stop.set()
        if ring_watch is not None:
            ring_watch.join(JOIN_TIMEOUT)
    per_replica = []
    for r, history in enumerate(histories):
        tally: dict[str, int] = {}
        rails: dict[str, int] = {}
        for d in history:
            tally[f"{d['action']}/{d['reason']}"] = tally.get(f"{d['action']}/{d['reason']}", 0) + 1
            for rail in d["rails"]:
                rails[rail] = rails.get(rail, 0) + 1
        per_replica.append({
            "owned": scrapes[r]["sharding"]["owned"],
            "decisions": tally,
            "suppressed": rails,
            "executed": [
                {k: d[k] for k in ("action", "reason", "current_shards", "target_shards")}
                for d in history if d["executed"]
            ],
        })
    scale_in = None
    if 2 in epochs:
        scale_in = {"after_epoch1_s": epochs[2] - epochs[1]}
        for replica, history in enumerate(histories):
            for d in history:
                if d["executed"] and d["action"] == "scale-in":
                    scale_in.update({"replica": replica, "reason": d["reason"],
                                     "evidence": d["evidence"]})
    evidence = scale_out["evidence"] if scale_out is not None else {}
    return {
        "run": name,
        "services": {"base": n_base, "wave": n_wave},
        "latency_s": latency,
        "epochs_s": {str(e): t - wave_at for e, t in sorted(epochs.items())},
        "stable_s": {str(e): t - wave_at for e, t in sorted(stable_at.items())},
        "scale_out": None if scale_out is None else {
            "replica": scale_out["replica"],
            "reason": scale_out["reason"],
            "reaction_s": epochs[1] - wave_at,
            "burn": evidence.get("burn"),
            "oldest_unconverged_age_s": evidence.get("oldest_unconverged_age_s"),
            "transition_stable_s": stable_at[1] - epochs[1] if 1 in stable_at else None,
        },
        "scale_in": scale_in,
        "drain_s": drained_at - wave_at,
        "settle_s": settle_s,
        "create_accelerator": int(creates),
        "journeys": journey_counts(pkg, [s["metrics"] for s in scrapes.values()]),
        "replicas": per_replica,
        "target_shards_max": target_max,
        "aimd_ceiling_sums_max": dict(sorted(fleet.budget.ceilings_max.items())),
        "call_rates_max": dict(sorted(fleet.budget.rates_max.items())),
        "watch": {"polls": watch.result["polls"], "max_gap_s": watch.result["max_gap_s"]},
        "replica_cores_busy": cpu / elapsed,
        "exits": exits,
    }


def autoscale_runs(
    pkg, package: str, n_base: int, n_wave: int, latency: float, workdir: pathlib.Path
) -> dict:
    """``autoscale_fleet``'s acting run and its observe-only twin side by
    side, the twin ``AUTOSCALE_TWIN_DELAY`` s behind, each on its own
    apiserver, account and ports (any failure of either is raised).
    Beside the runs, the most cores that this process and its children
    kept busy over ``AUTOSCALE_BUSY_READ`` s: the two runs share the
    host, and more than half its cores busy would make them measure
    each other."""
    def run(observe_only: bool) -> dict:
        rundir = workdir / ("observe-only" if observe_only else "acting")
        rundir.mkdir(parents=True, exist_ok=True)
        if observe_only:
            time.sleep(AUTOSCALE_TWIN_DELAY)
        return autoscale_fleet(pkg, package, n_base, n_wave, latency, rundir, observe_only)

    busy: list[float] = []
    done = threading.Event()

    def sample() -> None:
        last = (time.monotonic(), tree_cpu_seconds())
        while not done.wait(AUTOSCALE_BUSY_READ):
            now = (time.monotonic(), tree_cpu_seconds())
            busy.append(max(0.0, now[1] - last[1]) / (now[0] - last[0]))
            last = now

    sampler = threading.Thread(target=sample, name="busy-cores", daemon=True)
    sampler.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
            futures = {"acting": pool.submit(run, False), "observe-only": pool.submit(run, True)}
            runs = {k: f.result() for k, f in futures.items()}
    finally:
        done.set()
        sampler.join(JOIN_TIMEOUT)
    return {**runs, "busy_cores_max": max(busy, default=0.0)}


# ---------------------------------------------------------------------------
# the teardown phase: deletes, a kill mid-teardown and the orphan sweeper
# ---------------------------------------------------------------------------

def teardown_hostname(i: int, every: int) -> str | None:
    """Service ``i``'s hostname, or None: the first Service of each
    block of ``every`` whose parity is the block's, so that deleting the
    even-numbered Services deletes every other block's hostname."""
    block = i // every
    if i % every != (block * (1 - every)) % 2:
        return None
    return f"svc{i:04d}.{TEARDOWN_ZONE}"


def make_teardown_service(pkg, i: int, every: int):
    """``make_shard_service``'s Service, hostname-annotated where
    ``teardown_hostname`` gives it one.  An annotated Service sits behind
    an NLB of its own (``service_lb``): the Route53 controller finds the
    accelerator by its load balancer, so it must be the only one there."""
    svc = make_shard_service(pkg, i)
    hostname = teardown_hostname(i, every)
    if hostname is not None:
        svc.metadata.annotations[pkg.apis.ROUTE53_HOSTNAME_ANNOTATION] = hostname
        svc.status.load_balancer.ingress[0] = pkg.objects.LoadBalancerIngress(hostname=service_lb(i)[1])
    return svc


def teardown_view(data: dict, plan: dict, kept: dict, shared: dict, began: float, now: float) -> list[str]:
    """``StateWatch``'s teardown check over ``plan`` (``kept``: owner tag
    -> ARN of each kept Service, ``kept_hosts``: their record names;
    ``doomed``, ``doomed_hosts``: the deleted Services'): a kept
    Service's accelerator gone or disabled or its records missing, and a
    second disable of one accelerator (a start of ``IN_PROGRESS`` on it
    disabled, after it was enabled or settled or had fewer reads
    pending).  Publishes in ``shared`` what the deleted owners still
    hold: their accelerators disabled (``disabled``) and gone
    (``gone``), the resources left (``left``: accelerators, listeners,
    endpoint groups, records) and the first read with none left
    (``cleared_at``); keeps the disables started per ARN (``starts``)
    and the deleted owners' accelerators disabled at the first read
    begun after ``shared["killed_at"]`` (``disabled_at_kill``)."""
    doomed, doomed_hosts = set(plan["doomed"]), set(plan["doomed_hosts"])
    accels = {entry["accelerator"]["accelerator_arn"]: entry for entry in data.get("accelerators", [])}
    owner_of = {arn: owner_tag(entry) for arn, entry in accels.items()}
    records = {
        (r["name"], r["type"]) for table in data.get("records", {}).values() for r in table
    }
    faults = []
    for owner, arn in plan["kept"].items():
        entry = accels.get(arn)
        if entry is None or owner_of[arn] != owner:
            faults.append(f"kept {owner}'s accelerator {arn} is gone")
        elif not entry["accelerator"]["enabled"]:
            faults.append(f"kept {owner}'s accelerator {arn} is disabled")
    for host in plan["kept_hosts"]:
        missing = [t for t in ("TXT", "A") if (host, t) not in records]
        if missing:
            faults.append(f"kept hostname {host} lacks {missing}")
    starts, last = kept.setdefault("starts", {}), kept.setdefault("settle", {})
    for arn, entry in accels.items():
        enabled, status = entry["accelerator"]["enabled"], entry["accelerator"]["status"]
        pending = entry.get("pending_describes", 0)
        before = last.get(arn)
        if not enabled and status == "IN_PROGRESS" and (
            before is None or before[0] or before[1] != "IN_PROGRESS" or pending > before[2]
        ):
            starts[arn] = starts.get(arn, 0) + 1
            if starts[arn] > 1:
                faults.append(f"accelerator {arn} disabled {starts[arn]} times")
        last[arn] = (enabled, status, pending)
    doomed_arns = {arn for arn, owner in owner_of.items() if owner in doomed}
    listener_of = {
        listener["listener_arn"]: arn
        for arn in doomed_arns for listener in accels[arn]["listeners"]
    }
    groups = sum(1 for eg in data.get("endpoint_groups", []) if eg["parent"] in listener_of)
    host_records = sum(1 for name, _ in records if name in doomed_hosts)
    disabled = sorted(arn for arn in doomed_arns if not accels[arn]["accelerator"]["enabled"])
    left = len(doomed_arns) + len(listener_of) + groups + host_records
    with shared["lock"]:
        shared["disabled"].value = len(disabled)
        shared["gone"].value = len(doomed) - len(doomed_arns)
        shared["left"].value = left
        if left == 0 and shared["cleared_at"].value == 0.0:
            shared["cleared_at"].value = now
        killed_at = shared["killed_at"].value
    if "disabled_at_kill" not in kept and killed_at and began > killed_at:
        kept["disabled_at_kill"] = disabled
    return faults


DISABLE_LINE = re.compile(r"Disabling Global Accelerator (\S+)")
SWEEP_LINE = re.compile(r"gc sweep (\d+): deleted (\d+) accelerators, (\d+) record owners")


def teardown_fleet(
    pkg,
    package: str,
    n: int,
    latency: float,
    workdir: pathlib.Path,
    hostname_every: int = TEARDOWN_HOSTNAME_EVERY,
    victim_shard: int = 0,
) -> dict:
    """Teardown and the orphan sweeper over processes
    (``docs/operations.md:153-233``, and its failure table's "leader
    killed mid-mutation" row): two ``python -m <package> controller
    --shard-count 2 --shards-per-replica 2`` replicas with the sweeper on
    (``TEARDOWN_GC``), one apiserver and the shard phase's
    flock-arbitrated fake account at ``latency`` s per call, with the
    hosted zone ``TEARDOWN_ZONE`` and every accelerator settling
    through ``TEARDOWN_SETTLE`` reads.

    (a) Once each replica holds one shard, ``n`` Services on one NLB are
    created (hostnames per ``teardown_hostname``) and converge: ``n``
    complete chains and every TXT+A pair.  (b) The even-numbered half
    is deleted in one burst while a ``StateWatch`` (``teardown_view``)
    reads the account every 0.1 s.  (c) Once a deleted owner's
    accelerator is disabled and not yet deleted, with at most
    ``TEARDOWN_KILL_GONE`` of them gone, the holder of shard
    ``victim_shard`` gets SIGKILL.  (d) The survivor steals its lease one
    lease duration later; the delete events of the dead replica's keys
    died with it, so its sweeper must find those orphans from ownership
    tags and TXT heritage alone.

    Hard bounds (``PhaseError``): never more than ``n`` complete chains;
    at the end exactly the kept half's accelerators remain, each with
    its ARN from before the deletes and a complete chain, every kept
    hostname keeps its TXT and A and no deleted owner keeps an
    accelerator, listener, endpoint group or record; at every watch read
    every kept Service's accelerator is there, enabled, with its
    records; orphans of the dead replica's shards were left at the
    kill, and the survivor's ``/healthz`` gc block counts at least that
    many deletions; no sweep deletes more than ``--gc-max-deletes``; the
    last orphan is gone within ``takeover + (grace - 1 + ceil(K /
    max_deletes) + 1) x interval + 2 x settle + TEARDOWN_SLACK_S`` s of
    the kill (K: orphans left at the steal); no accelerator is disabled
    twice, neither in the watch's reads nor in the replicas' logs; the
    fleet's call rate and summed AIMD ceilings within
    ``SHARD_BUDGET_QPS`` per service at every read; every kept Service
    ``converged`` on the survivor's ``/debug/explain`` and no journey in
    flight there within ``AUTOSCALE_SETTLE_S`` s; the survivor exits 0
    on SIGTERM.  Returns the run's kill, mop-up time and bound,
    counters and final AWS state."""
    env = shard_env(n, latency, workdir)
    lbs = [SHARD_LB] + [service_lb(i) for i in range(n) if teardown_hostname(i, hostname_every)]
    env.update(
        AGAC_FAKE_LBS=",".join("=".join(lb) for lb in lbs),
        AGAC_FAKE_ZONES=TEARDOWN_ZONE,
        AGAC_FAKE_SETTLE=str(TEARDOWN_SETTLE),
    )
    gc = TEARDOWN_GC
    placement = [
        "--shards-per-replica", "2", "--gc-interval", f"{gc['interval']:g}",
        "--gc-grace-sweeps", str(gc["grace_sweeps"]), "--gc-max-deletes", str(gc["max_deletes"]),
    ]
    shards = {0, 1}
    names = [make_shard_service(pkg, i).metadata.name for i in range(n)]
    owner_of = {i: f"service/default/{name}" for i, name in enumerate(names)}
    doomed_i = [i for i in range(n) if i % 2 == 0]
    kept_i = [i for i in range(n) if i % 2 == 1]
    hosts = {i: f"{h}." for i in range(n) if (h := teardown_hostname(i, hostname_every))}
    ring = pkg.ring.HashRing(2)
    shard_of = {i: ring.shard_for_key(f"default/{names[i]}") for i in range(n)}
    with ProcessFleet(pkg, "teardown", workdir, env, chains=n) as fleet:
        spawned = fleet.spawn(2, lambda port: shard_controller_argv(
            package, fleet.kubeconfig, port, 2, placement
        ))
        fleet.wait("every shard lease held", lambda: fleet.placement(shards), spawned)
        aws = fleet.aws

        def record_names() -> set:
            # the zone is seeded by the replicas' first use of the account
            zone_id = aws.zone_id_by_name(TEARDOWN_ZONE)
            return {(r.name, r.type) for r in aws.records_in_zone(zone_id)} if zone_id else set()

        start = time.monotonic()
        fleet.create("Service", [make_teardown_service(pkg, i, hostname_every) for i in range(n)])

        def converged() -> bool:
            have = record_names()
            return fleet.chains() == (n, n, n) and all(
                (h, t) in have for h in hosts.values() for t in ("TXT", "A")
            )

        fleet.wait(f"{n} complete chains and {len(hosts)} TXT+A pairs", converged, start)
        start_owned = fleet.wait(
            "one shard lease held by each replica", lambda: fleet.placement(shards, True), start
        )
        arn_of = {owner: arn for arn, owner in aws.accelerator_owners().items()}
        if sorted(arn_of) != sorted(owner_of.values()):
            raise PhaseError(f"teardown: accelerator owners {sorted(arn_of)} after converging")
        plan = {
            "kept": {owner_of[i]: arn_of[owner_of[i]] for i in kept_i},
            "doomed": [owner_of[i] for i in doomed_i],
            "kept_hosts": sorted(hosts[i] for i in kept_i if i in hosts),
            "doomed_hosts": sorted(hosts[i] for i in doomed_i if i in hosts),
        }
        doomed_arns = {arn_of[owner_of[i]]: i for i in doomed_i}

        def left_by_shard() -> dict[int, int]:
            """The deleted owners' accelerators and hostnames with a
            record still there, per shard of their keys."""
            owners = set(aws.accelerator_owners().values())
            names_left = {name for name, _ in record_names()}
            out = {0: 0, 1: 0}
            for i in doomed_i:
                out[shard_of[i]] += (owner_of[i] in owners) + (hosts.get(i) in names_left)
            return out

        fleet.wait("read of the replicas", fleet.read, start)  # the budget's window to the deletes
        with StateWatch("teardown", env["AGAC_FAKE_STATE"], teardown_view, workdir, plan=plan, shared={
            "disabled": ("i", 0), "gone": ("i", 0), "left": ("i", -1),
            "cleared_at": ("d", 0.0), "killed_at": ("d", 0.0),
        }) as watch:
            # (b) the burst of deletes
            deleted_at = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
                list(pool.map(lambda i: fleet.client.delete("Service", "default", names[i]), doomed_i))

            # (c) the kill, mid-teardown: the watch is polled alone here, so
            # the kill lands within a read of the first disable
            def disabled() -> dict | None:
                seen = watch.read()
                if seen["gone"] > TEARDOWN_KILL_GONE * len(doomed_i):
                    raise PhaseError(
                        f"teardown: {seen['gone']} of {len(doomed_i)} accelerators gone before "
                        f"one was seen disabled (watch {seen})"
                    )
                return seen if seen["disabled"] >= 1 else None

            seen = fleet.wait("accelerator disabled", disabled, deleted_at, every=0.02)
            victim, victim_shards = fleet.holder(victim_shard, shards)
            fleet.kill(victim)
            watch.set("killed_at", fleet.killed_at)
            (survivor,) = fleet.live
            left = left_by_shard()
            kill = {
                "victim": victim,
                "owned": victim_shards,
                "watch": seen,
                "left_by_shard": left,
                "victim_orphans": sum(left[s] for s in victim_shards),
            }
            if not kill["victim_orphans"]:
                raise PhaseError(f"teardown: no orphan of shards {victim_shards} at the kill: {kill}")
            # (d) the steal and the mop-up
            kill["takeover_s"] = fleet.takeover(lambda block: set(block.get("owned", ())) == shards)
            kill["orphans_at_steal"] = sum(left_by_shard().values())
            cleared_at = fleet.wait(
                "orphan-free account",
                lambda: fleet.read() is not None and watch.read()["cleared_at"],
                fleet.killed_at, every=TEARDOWN_READ,
            )
            mop_up_s = cleared_at - fleet.killed_at
            bound_s = kill["takeover_s"] + (
                gc["grace_sweeps"] - 1 + -(-kill["orphans_at_steal"] // gc["max_deletes"]) + 1
            ) * gc["interval"] + 2 * TEARDOWN_SETTLE + TEARDOWN_SLACK_S
            if mop_up_s > bound_s:
                raise PhaseError(
                    f"teardown: the last orphan went {mop_up_s} s after the kill (bound {bound_s} s: "
                    f"takeover {kill['takeover_s']} s, {kill['orphans_at_steal']} orphans at the steal)"
                )
            fleet.wait("kept Service left unconverged on the survivor",
                       fleet.explained(f"default/{names[i]}" for i in kept_i), cleared_at)
            calm = time.monotonic()
            final = fleet.idle(AUTOSCALE_SETTLE_S)
            settle_s = time.monotonic() - calm
            time.sleep(2 * RESIZE_POLL)  # the watch reads the settled state once more
        watch.check()
        # the end state
        half = len(kept_i)
        snap_owners = aws.accelerator_owners()
        if fleet.chains() != (half, half, half) or sorted(snap_owners) != sorted(plan["kept"].values()):
            raise PhaseError(
                f"teardown: chain counts {fleet.chains()}, owners {sorted(snap_owners.values())} "
                f"at the end (want the {half} kept Services' accelerators)"
            )
        have = record_names()
        want = {(hosts[i], t) for i in kept_i if i in hosts for t in ("TXT", "A")}
        if have != want:
            raise PhaseError(f"teardown: records {sorted(have ^ want)} differ from the kept pairs")
        # disables, as the replicas logged them: once per accelerator per
        # process, and never by the survivor for one the dead replica
        # disabled and committed (seen disabled at the watch's first read
        # after the kill)
        logged = {r: DISABLE_LINE.findall(fleet.children[r].stderr()) for r in (0, 1)}
        repeated = {
            r: sorted({a for a in arns if arns.count(a) > 1}) for r, arns in logged.items()
        }
        again = sorted(
            set(logged[survivor]) & set(logged[victim])
            & set(watch.result.get("disabled_at_kill") or ())
        )
        if any(repeated.values()) or again:
            raise PhaseError(
                f"teardown: second disables: repeated in one log {repeated}, by the survivor "
                f"after the dead replica's {again}"
            )
        over = [
            (r, match[0]) for r in (0, 1) for match in SWEEP_LINE.finditer(fleet.children[r].stderr())
            if int(match[2]) + int(match[3]) > gc["max_deletes"]
        ]
        gc_final = final[survivor]["gc"]
        if over or gc_final["deleted_total"] < kill["victim_orphans"]:
            raise PhaseError(
                f"teardown: sweeps over budget {over}; the survivor's sweeper deleted "
                f"{gc_final['deleted_total']} for {kill['victim_orphans']} orphans of the dead "
                f"replica's shards"
            )
        (exit_status,) = fleet.terminate().values()
    return {
        "services": n,
        "deleted": len(doomed_i),
        "hostnames": {"kept": len(plan["kept_hosts"]), "deleted": len(plan["doomed_hosts"])},
        "latency_s": latency,
        "start_owned": [sorted(start_owned[r]) for r in sorted(start_owned)],
        "kill": kill,
        "mop_up_s": mop_up_s,
        "mop_up_bound_s": bound_s,
        "journeys_settle_s": settle_s,
        "gc_survivor": {
            k: gc_final[k] for k in ("sweeps_total", "deleted_total", "adopted_total", "pending")
        },
        "disables": {
            "watch_starts": sum(watch.result["starts"].get(a, 0) for a in doomed_arns),
            "logged": {r: len(arns) for r, arns in logged.items()},
            "disabled_at_kill": len(watch.result.get("disabled_at_kill") or ()),
        },
        "call_rates_max": dict(sorted(fleet.budget.rates_max.items())),
        "aimd_ceiling_sums_max": dict(sorted(fleet.budget.ceilings_max.items())),
        "watch": {"polls": watch.result["polls"], "max_gap_s": watch.result["max_gap_s"]},
        "exit": exit_status,
        "aws_state": fleet.snapshot(),
    }


# ---------------------------------------------------------------------------
# the drift phase: drift resync over a package's controller processes
# ---------------------------------------------------------------------------

def drift_state(data: dict) -> dict:
    """One read of the fake account's state file (``data``, as saved):
    the accelerators (enabled, listeners), endpoint groups (parent and
    endpoint weights) and records a tamper's repair is judged by, and
    the owner tags that repeat."""
    accelerators = {
        entry["accelerator"]["accelerator_arn"]: (
            entry["accelerator"]["enabled"], [listener["listener_arn"] for listener in entry["listeners"]]
        )
        for entry in data.get("accelerators", [])
    }
    groups = {
        eg["endpoint_group_arn"]: (eg["parent"], {d["endpoint_id"]: d["weight"] for d in eg["endpoints"]})
        for eg in data.get("endpoint_groups", [])
    }
    records = {
        (r["name"], r["type"]): r for table in data.get("records", {}).values() for r in table
    }
    return {
        "accelerators": accelerators,
        "groups": groups,
        "records": records,
        "repeated": repeated_owners(data.get("accelerators", [])),
    }


def tamper_repaired(view: dict, tamper: dict) -> bool:
    """Whether ``view`` (``drift_state``) shows ``tamper`` repaired."""
    kind = tamper["kind"]
    if kind == "disable":
        accel = view["accelerators"].get(tamper["accelerator"])
        return accel is not None and accel[0]
    if kind == "listener":
        accel = view["accelerators"].get(tamper["accelerator"])
        return accel is not None and any(
            parent in accel[1] and tamper["endpoint"] in endpoints
            for parent, endpoints in view["groups"].values()
        )
    if kind in ("weight", "endpoint"):
        endpoints = view["groups"].get(tamper["group"], (None, {}))[1]
        return endpoints.get(tamper["endpoint"], -1) == tamper["weight"]
    return view["records"].get(tuple(tamper["record"])) == tamper["want"]


def drift_view(data: dict, plan: list[dict], kept: dict, shared: dict, began: float, now: float) -> list[str]:
    """``StateWatch``'s drift check over ``plan``, the drill's tampers: a
    repeated accelerator owner tag is a fault; each tamper's repair is
    stamped in ``shared["repaired"]`` at the first read (monotonic s)
    begun after ``shared["applied"]`` stamped it that shows it repaired;
    keeps the tampers seen open (``open``)."""
    view = drift_state(data)
    seen_open = kept.setdefault("open", [])
    with shared["lock"]:
        applied, repaired = shared["applied"], shared["repaired"]
        for i, tamper in enumerate(plan):
            if not applied[i] or began < applied[i] or repaired[i]:
                continue
            if tamper_repaired(view, tamper):
                repaired[i] = now
            elif i not in seen_open:
                seen_open.append(i)
    return [f"owners repeated {view['repeated']}"] if view["repeated"] else []


def drift_journeys(metrics: str) -> tuple[int, int, int]:
    """One replica's journeys in flight, its drift journeys closed and
    its reconciles."""
    closed = sum(
        value for labels, value in metric_samples(metrics, "agac_journey_converge_seconds_count").items()
        if 'trigger="drift"' in labels
    )
    reconciles = sum(metric_samples(metrics, "agac_reconcile_results_total").values())
    return replica_journeys(metrics)[0], int(closed), int(reconciles)


def drift_ceilings(owned: dict[str, int], accelerators: int) -> dict[str, int]:
    """One replica's read ceilings per tick: ``DRIFT_READS`` scaled from
    the runbook's fleet to ``owned`` (its share of the fleet by the same
    parts), plus one refresh of the discovery snapshot over the
    account's ``accelerators`` (a drain at 100 a page and a tag read
    each) and one drain of the hosted zones."""
    ceilings = {
        op: -(-value * owned[part] // DRIFT_TABLE_FLEET[part]) for op, (value, part) in DRIFT_READS.items()
    }
    ceilings["list_accelerators"] = -(-accelerators // 100)
    ceilings["list_tags_for_resource"] += accelerators
    ceilings["list_hosted_zones"] = 1
    return ceilings


SYNCED_LINE = re.compile(r"Successfully synced '([^']+)'")
SHARD_LINE = re.compile(
    r"shard (\d+) (lease acquired|lease stolen|lease lost|shed for rebalance)"
)


def foreign_syncs(stderr: str, shard_of_key) -> list[str]:
    """The reconciles a replica logged for keys its shards did not own
    at that point of its log: ownership follows its own ``shard N
    lease ...`` lines in order, so no clock is compared."""
    owned: set[int] = set()
    foreign = []
    for line in stderr.splitlines():
        match = SHARD_LINE.search(line)
        if match:
            shard = int(match[1])
            if match[2] in ("lease acquired", "lease stolen"):
                owned.add(shard)
            else:
                owned.discard(shard)
            continue
        match = SYNCED_LINE.search(line)
        if match and shard_of_key(match[1]) not in owned:
            foreign.append(f"{match[1]} (owned {sorted(owned)})")
    return foreign


def time_ticks(fleet: ProcessFleet, parts: dict[int, dict], period: float):
    """Time drift ticks on each live replica of ``fleet`` until one
    re-verified at least half its chains (a tick inside the verify
    window reads little): from the last read with no journey in flight
    and no drift journey closed to the first read with none in flight
    again, with the reads by operation in between.  A window where other
    reconciles ran too (the informers' 30 s resync re-reconciles every
    binding) is not counted.  ``parts`` holds each replica's
    accelerators.  Returns the timed ticks and the windows skipped, per
    replica."""
    ticks: dict[int, dict] = {r: {"phase": "quiet"} for r in parts}
    timed: dict[int, list[dict]] = {r: [] for r in parts}
    shared = {r: 0 for r in parts}

    def step() -> bool:
        views = fleet.read()
        now = time.monotonic()
        for r, scrape in (views or {}).items():
            tick = ticks[r]
            inflight, closed, reconciles = drift_journeys(scrape["metrics"])
            if tick["phase"] in ("quiet", "armed") and not inflight and closed == tick.get("closed"):
                # quiet still: the window (and the tick's time, an upper
                # bound) starts at the last quiet read
                tick.update(phase="armed", ops=scrape["ops"], start=now, reconciles=reconciles)
            elif tick["phase"] == "quiet" and not inflight:
                tick.update(closed=closed)
            elif tick["phase"] == "armed":
                tick.update(phase="ticking")
            elif tick["phase"] == "ticking" and not inflight and closed > tick["closed"]:
                if reconciles - tick["reconciles"] > closed - tick["closed"]:
                    tick.update(phase="quiet", closed=closed)
                    shared[r] += 1
                    continue
                reads = {
                    op: int(count - tick["ops"].get(op, 0.0))
                    for op, count in sorted(scrape["ops"].items())
                    if count > tick["ops"].get(op, 0.0)
                }
                timed[r].append({
                    "tick_s": now - tick["start"], "journeys": closed - tick["closed"], "reads": reads,
                })
                verified = 2 * reads.get("list_endpoint_groups", 0) >= parts[r]["accelerators"]
                tick.update(phase="done" if verified else "quiet", closed=closed)
        return all(t["phase"] == "done" for t in ticks.values())

    fleet.wait("verifying tick timed on every replica", step, time.monotonic(),
               every=DRIFT_TICK_READ, deadline=4 * period + PROCESS_DEADLINE / 10)
    return timed, shared


def apply_tamper(pkg, aws, state_path: str, zone_id: str, records: dict, tamper: dict) -> None:
    """Commit ``tamper`` (a plan entry of ``drift_fleet``) to the
    account through ``aws``; ``records`` maps (name, type) to the zone's
    record sets as they were before any tamper."""
    types_ = pkg.awstypes
    kind = tamper["kind"]
    if kind == "disable":
        aws.update_accelerator(tamper["accelerator"], enabled=False)
    elif kind == "listener":
        for eg, (parent, _) in drift_state(account_state(state_path))["groups"].items():
            if parent == tamper["listener"]:
                aws.delete_endpoint_group(eg)
        aws.delete_listener(tamper["listener"])
    elif kind == "weight":
        group = aws.describe_endpoint_group(tamper["group"])
        aws.update_endpoint_group(tamper["group"], [
            types_.EndpointConfiguration(
                endpoint_id=d.endpoint_id,
                weight=DRIFT_WEIGHT if d.endpoint_id == tamper["endpoint"] else d.weight,
                client_ip_preservation_enabled=d.client_ip_preservation_enabled,
            )
            for d in group.endpoint_descriptions
        ])
    elif kind == "endpoint":
        aws.remove_endpoints(tamper["group"], [tamper["endpoint"]])
    else:
        record = records[tuple(tamper["record"])]
        if kind == "record-edit":
            edited = types_.ResourceRecordSet(
                name=record.name, type=record.type, ttl=record.ttl,
                alias_target=types_.AliasTarget(
                    dns_name="tampered.example.net.",
                    hosted_zone_id=record.alias_target.hosted_zone_id,
                ),
            )
            change = types_.Change("UPSERT", edited)
        else:
            change = types_.Change("DELETE", record)
        aws.change_resource_record_sets(zone_id, [change])


def account_state(state_path: str) -> dict:
    """The fake account's state file as last saved."""
    return json.loads(pathlib.Path(state_path).read_text())


def make_drift_binding(pkg, k: int, service: str, endpoint_group_arn: str):
    """Binding ``k`` in ``default``: the load balancer of ``service``
    into the out-of-band endpoint group ``endpoint_group_arn``."""
    egb = pkg.egb
    return egb.EndpointGroupBinding(
        metadata=pkg.objects.ObjectMeta(name=f"binding{k:04d}", namespace="default"),
        spec=egb.EndpointGroupBindingSpec(
            endpoint_group_arn=endpoint_group_arn,
            weight=100,
            service_ref=egb.ServiceReference(name=service),
        ),
    )


def external_state(data: dict, group_arns: list[str]) -> dict:
    """The out-of-band chains' accelerators, listeners and groups in
    ``data`` (a state snapshot): each group's parent and endpoints."""
    groups = {eg["endpoint_group_arn"]: eg for eg in data["endpoint_groups"]}
    parents = {groups[arn]["parent"] for arn in group_arns}
    return {
        "accelerators": sorted(
            (e["accelerator"]["accelerator_arn"], e["accelerator"]["enabled"],
             tuple(sorted(listener["listener_arn"] for listener in e["listeners"])))
            for e in data["accelerators"]
            if any(listener["listener_arn"] in parents for listener in e["listeners"])
        ),
        "groups": {
            arn: (groups[arn]["parent"], sorted(map(json.dumps, groups[arn]["endpoints"])))
            for arn in group_arns
        },
    }


def drift_fleet(
    pkg,
    package: str,
    n: int,
    latency: float,
    workdir: pathlib.Path,
    period: float = DRIFT_PERIOD,
    hostname_every: int = TEARDOWN_HOSTNAME_EVERY,
    tampers: tuple[str, ...] = DRIFT_TAMPERS,
    victim_shard: int = 0,
    n_bindings: int | None = None,
) -> dict:
    """Drift resync over processes (``docs/operations.md:560-640``): two
    ``python -m <package> controller --shard-count 2 --shards-per-replica
    2 --drift-resync-period <period>`` replicas on the teardown phase's
    fleet settings (one apiserver, the flock-arbitrated fake account at
    ``latency`` s per call, the zone ``TEARDOWN_ZONE``), with the
    discovery snapshot's TTL at the period.

    (a) Once each replica holds one shard, ``bench.py``'s mixed fleet is
    created: ``n`` Services (hostnames per ``teardown_hostname``, each
    such one behind its own NLB), n/10 ALB Ingresses and ``n_bindings``
    (default n/10) EndpointGroupBindings, binding k putting the NLB of
    the k-th hostname-annotated Service into the endpoint group of an
    out-of-band chain this process built first (cluster tag
    ``external``); it converges: every chain, every TXT+A pair, every
    binding bound to one endpoint.  (b) One tick is timed on each
    replica, from its drift journeys opening to none in flight, with its
    reads by operation.  (c) At once, in both shards, ``tampers`` are
    applied out of band (``DRIFT_WINDOWS``); a ``StateWatch``
    (``drift_view``) reads the account every 0.1 s.  (d) As soon as the
    first tamper of shard ``victim_shard`` is repaired, its holder gets
    SIGKILL; the survivor steals its lease one lease duration later and
    adopts its keys.  (e) Once every tamper is repaired, every binding
    is deleted, so that its finalizer removes its endpoint.

    Hard bounds (``PhaseError``): each tamper repaired within ``period``
    + its window (one discovery TTL for a disable) + the longest tick,
    plus the takeover for the victim's shard; some of the victim shard's
    tampers still open at the kill; each replica's reads in the timed
    tick within ``drift_ceilings``; no accelerator owner repeated at any
    read, and never more complete chains than the fleet's; no reconcile
    logged by a replica for a key its shards did not own then; the
    fleet's call rate and summed AIMD ceilings within
    ``SHARD_BUDGET_QPS`` per service at every read; no journey in flight
    on the survivor within ``period`` + ``AUTOSCALE_SETTLE_S`` s of the
    bindings' finalizers; every binding gone, its endpoint out of its
    group and the out-of-band chains otherwise as built; exactly the
    fleet's chains and pairs at the end; the survivor exits 0 on
    SIGTERM.  Returns the run's repairs against their bounds, tick
    reads, kill, stage catalog and final AWS state."""
    n_ing = max(1, n // 10)
    n_egb = n_bindings if n_bindings is not None else max(1, n // 10)
    hosted = [i for i in range(n) if teardown_hostname(i, hostname_every)]
    if n_egb > len(hosted):
        raise PhaseError(f"drift: {n_egb} bindings for {len(hosted)} hostname-annotated Services")
    total = n + n_ing + n_egb
    env = shard_env(n, latency, workdir)
    lbs = [SHARD_LB] + [service_lb(i) for i in hosted] + [alb(j) for j in range(n_ing)]
    env.update(
        AGAC_FAKE_LBS=",".join("=".join(lb) for lb in lbs),
        AGAC_FAKE_ZONES=TEARDOWN_ZONE,
        AGAC_FAKE_QUOTA_ACCELERATORS=str(total + 20),
        AGAC_DISCOVERY_CACHE_TTL=f"{period:g}",
    )
    state_path = env["AGAC_FAKE_STATE"]
    aws = pkg.fake_backend.FileBackedFakeAWSBackend(state_path, quota_accelerators=total + 20)
    lb_arn = {name: aws.add_load_balancer(name, REGION, host).load_balancer_arn for name, host in lbs}
    zone_id = aws.add_hosted_zone(TEARDOWN_ZONE).id
    group_arns = external_chains(pkg, aws, n_egb)
    external_before = external_state(account_state(state_path), group_arns)
    services = [make_teardown_service(pkg, i, hostname_every) for i in range(n)]
    ingresses = [make_ingress(pkg, j) for j in range(n_ing)]
    bindings = [
        make_drift_binding(pkg, k, services[hosted[k]].metadata.name, group_arns[k])
        for k in range(n_egb)
    ]
    bound_lb = {k: lb_arn[service_lb(hosted[k])[0]] for k in range(n_egb)}
    hosts = {f"{h}." for i in hosted if (h := teardown_hostname(i, hostname_every))}
    hosts |= {f"ing{j:04d}.z{j % N_ZONES}.bench.example.com." for j in range(n_ing)}
    ring = pkg.ring.HashRing(2)

    def key_of(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    shard_of = {key_of(obj): ring.shard_for_key(key_of(obj)) for obj in services + ingresses + bindings}
    shards = {0, 1}
    placement = ["--shards-per-replica", "2", "--drift-resync-period", f"{period:g}"]
    with ProcessFleet(pkg, "drift", workdir, env, chains=total) as fleet:
        spawned = fleet.spawn(2, lambda port: shard_controller_argv(
            package, fleet.kubeconfig, port, 2, placement
        ))
        fleet.wait("every shard lease held", lambda: fleet.placement(shards), spawned)
        client = fleet.client

        def record_map() -> dict:
            return {(r.name, r.type): r for r in aws.records_in_zone(zone_id)}

        def bound_ids() -> list[list[str]]:
            return [
                list(client.get("EndpointGroupBinding", "default", b.metadata.name).status.endpoint_ids)
                for b in bindings
            ]

        start = time.monotonic()
        for kind, objects in (("Service", services), ("Ingress", ingresses),
                              ("EndpointGroupBinding", bindings)):
            fleet.create(kind, objects)

        def converged() -> bool:
            have = record_map()
            return (
                fleet.chains() == (total, total, total)
                and all((h, t) in have for h in hosts for t in ("TXT", "A"))
                and all(len(ids) == 1 for ids in bound_ids())
            )

        fleet.wait(
            f"{total} complete chains, {len(hosts)} TXT+A pairs and {n_egb} bindings bound",
            converged, start,
        )
        start_owned = fleet.wait(
            "one shard lease held by each replica", lambda: fleet.placement(shards, True), start
        )

        # (b) ticks on each replica, timed from its drift journeys opening
        # until none is in flight, with their reads by operation, until
        # one re-verified the chains (a tick inside the verify window
        # reads little)
        owner_of_shard = {next(iter(o)): r for r, o in start_owned.items()}
        parts = {}
        for r in fleet.live:
            mine = [key for key, shard in shard_of.items() if owner_of_shard[shard] == r]
            parts[r] = {
                "accelerators": sum(1 for k in mine if not k.startswith("default/binding")),
                "bindings": sum(1 for k in mine if k.startswith("default/binding")),
                "objects": len(mine),
                "zones": 1,
            }
        timed, shared = time_ticks(fleet, parts, period)
        accelerators_in_account = len(aws.all_accelerator_arns())
        ceilings = {r: drift_ceilings(parts[r], accelerators_in_account) for r in timed}
        read_faults = {}
        for r, runs in timed.items():
            for tick in runs:
                over = {
                    op: (count, ceilings[r].get(op, 0))
                    for op, count in tick["reads"].items()
                    if count > ceilings[r].get(op, 0)
                }
                if over:
                    read_faults.setdefault(r, []).append(over)
        ticks = {r: {"timed": timed[r], "ceilings": ceilings[r], "shared": shared[r]} for r in timed}
        if read_faults:
            raise PhaseError(
                f"drift: reads per tick over their ceilings (reads, ceiling): {read_faults}; "
                f"ticks {ticks}"
            )
        tick_s = max(t["tick_s"] for runs in timed.values() for t in runs)

        # (c) the tamper plan: in each shard, each kind on an object of its own
        snap = account_state(state_path)
        accel_of = {owner_tag(e): e for e in snap["accelerators"]}
        records = record_map()
        plan: list[dict] = []
        for shard in sorted(shards):
            plain = [i for i in range(n) if i not in hosted and shard_of[key_of(services[i])] == shard]
            named = [i for i in hosted if shard_of[key_of(services[i])] == shard]
            bound = [k for k in range(n_egb) if shard_of[key_of(bindings[k])] == shard]
            pools = {"disable": plain, "listener": plain, "record-edit": named,
                     "record-delete": named, "weight": bound, "endpoint": bound}
            used: set[tuple[int, int]] = set()
            for kind in tampers:
                free = [i for i in pools[kind] if (id(pools[kind]), i) not in used]
                if not free:
                    raise PhaseError(f"drift: no object of shard {shard} left for the {kind} tamper")
                target = free[0]
                used.add((id(pools[kind]), target))
                tamper = {"kind": kind, "shard": shard}
                if kind in ("disable", "listener"):
                    entry = accel_of[f"service/{key_of(services[target])}"]
                    tamper.update(
                        key=key_of(services[target]), accelerator=entry["accelerator"]["accelerator_arn"],
                        endpoint=lb_arn[SHARD_LB[0]],
                        listener=entry["listeners"][0]["listener_arn"],
                    )
                elif kind in ("weight", "endpoint"):
                    tamper.update(
                        key=key_of(bindings[target]), group=group_arns[target],
                        endpoint=bound_lb[target], weight=100,
                    )
                else:
                    name = f"{teardown_hostname(target, hostname_every)}."
                    record = records[(name, "A" if kind == "record-edit" else "TXT")]
                    tamper.update(
                        key=key_of(services[target]), record=[record.name, record.type],
                        want=next(
                            r for r in snap["records"][zone_id]
                            if (r["name"], r["type"]) == (record.name, record.type)
                        ),
                    )
                plan.append(tamper)
        stamps = [0.0] * len(plan)
        with StateWatch("drift", state_path, drift_view, workdir, plan=plan,
                        shared={"applied": ("d", stamps), "repaired": ("d", stamps)}) as watch:
            tampered_at = time.monotonic()
            for i, tamper in enumerate(plan):
                apply_tamper(pkg, aws, state_path, zone_id, records, tamper)
                watch.set("applied", time.monotonic(), i)
            # (d) the kill, at the victim shard's first repair: the watch
            # is polled alone here, so the kill lands within a read of it
            victims = [i for i, t in enumerate(plan) if t["shard"] == victim_shard]
            fleet.wait(f"repair of a tamper of shard {victim_shard}",
                       lambda: any(watch.read()["repaired"][i] for i in victims), tampered_at, every=0.02)
            victim, victim_owned = fleet.holder(victim_shard, shards)
            victim_metrics = fleet.kill(victim)["metrics"]
            (survivor,) = fleet.live
            # what the victim committed is in the file now, and it
            # commits nothing more
            at_kill = drift_state(account_state(state_path))
            kill = {
                "victim": victim,
                "owned": victim_owned,
                "open": [plan[i]["kind"] for i in victims if not tamper_repaired(at_kill, plan[i])],
            }
            by_victim = {i for i in victims if tamper_repaired(at_kill, plan[i])}
            if not kill["open"]:
                raise PhaseError(f"drift: every tamper of shard {victim_shard} repaired at the kill: {kill}")
            # the steal, every tamper repaired, and the survivor's resync
            # of the adopted keys (trigger=handoff) drained: its tick
            # over them, with the read plane dropped at the adoption
            kill["takeover_s"] = fleet.takeover(lambda block: set(block.get("owned", ())) == shards)
            taken_at = fleet.killed_at + kill["takeover_s"]
            handoff: list[tuple[float, int]] = []
            windows = {
                kind: period if DRIFT_WINDOWS[kind] is None else DRIFT_WINDOWS[kind] for kind in tampers
            }

            def repaired_and_drained() -> bool:
                views = fleet.read()
                if views is not None:
                    closed = sum(
                        value for labels, value in metric_samples(
                            views[survivor]["metrics"], "agac_journey_converge_seconds_count"
                        ).items() if 'trigger="handoff"' in labels
                    )
                    handoff.append((time.monotonic(), int(closed)))
                drained = len(handoff) > 3 and len({c for _, c in handoff[-4:]}) == 1 and handoff[-1][1]
                return all(watch.read()["repaired"]) and bool(drained)

            fleet.wait(
                "repair of every tamper with the handoff journeys drained", repaired_and_drained,
                tampered_at, every=TEARDOWN_READ,
                deadline=period + max(windows.values()) + 2 * float(SHARD_ENV["AGAC_LEASE_DURATION"]) + 60,
            )
            kill["adoption_tick_s"] = next(t for t, c in handoff if c == handoff[-1][1]) - taken_at
            kill["handoff_journeys"] = handoff[-1][1]
            times = watch.read()
            repairs = []
            for i, (tamper, at, done) in enumerate(zip(plan, times["applied"], times["repaired"])):
                # one tick of the replica that repairs: after the takeover
                # the survivor's queue holds its adoption's resync too
                tick = max(tick_s, kill["adoption_tick_s"]) if done > taken_at else tick_s
                bound = period + windows[tamper["kind"]] + tick + (
                    kill["takeover_s"] if tamper["shard"] == victim_shard else 0.0
                )
                repairs.append({"kind": tamper["kind"], "shard": tamper["shard"], "key": tamper["key"],
                                "repair_s": done - at, "bound_s": bound,
                                "by": "victim" if i in by_victim else "survivor"})
            late = [repair for repair in repairs if repair["repair_s"] > repair["bound_s"]]
            if late:
                raise PhaseError(f"drift: tampers repaired past their bounds {late}")
            # (e) the bindings' finalizers
            unbound_at = time.monotonic()
            for binding in bindings:
                client.delete("EndpointGroupBinding", "default", binding.metadata.name)

            def unbound() -> bool:
                for binding in bindings:
                    try:
                        client.get("EndpointGroupBinding", "default", binding.metadata.name)
                        return False
                    except pkg.errors.NotFoundError:
                        pass
                return external_state(account_state(state_path), group_arns) == external_before

            fleet.wait("binding left unfinalized or its endpoint left", unbound, unbound_at)
            calm = time.monotonic()
            final = fleet.idle(period + AUTOSCALE_SETTLE_S)
            settle_s = time.monotonic() - calm
            time.sleep(2 * RESIZE_POLL)  # the watch reads the settled state once more
        watch.check()
        # the end state: the fleet's chains and pairs, every repair standing
        view = drift_state(account_state(state_path))
        fleet_owners = {f"service/{key_of(s)}" for s in services} | {
            f"ingress/{key_of(i)}" for i in ingresses
        }
        owners_now = set(aws.accelerator_owners().values())
        # the bindings' groups are judged by the out-of-band chains above
        undone = [
            t["kind"] for t in plan
            if t["kind"] not in ("weight", "endpoint") and not tamper_repaired(view, t)
        ]
        if undone:
            raise PhaseError(f"drift: repairs undone at the end: {undone}")
        if fleet.chains() != (total, total, total) or not fleet_owners <= owners_now or len(owners_now) != total:
            raise PhaseError(
                f"drift: chain counts {fleet.chains()}, {len(owners_now)} owners at the end "
                f"(want the fleet's {n + n_ing} and {n_egb} out-of-band chains)"
            )
        have = set(record_map())
        want = {(h, t) for h in hosts for t in ("TXT", "A")}
        if have != want:
            raise PhaseError(f"drift: records {sorted(have ^ want)} differ from the fleet's pairs")
        foreign = {
            r: foreign_syncs(fleet.children[r].stderr(), lambda key: shard_of.get(key))
            for r in (0, 1)
        }
        if any(foreign.values()):
            raise PhaseError(f"drift: reconciles of keys the replica's shards did not own: {foreign}")
        (exit_status,) = fleet.terminate().values()
    return {
        "services": n,
        "ingresses": n_ing,
        "bindings": n_egb,
        "hostnames": len(hosts),
        "latency_s": latency,
        "period_s": period,
        "start_owned": {r: sorted(o) for r, o in start_owned.items()},
        "ticks": ticks,
        "tick_s": tick_s,
        "repairs": repairs,
        "kill": kill,
        "journeys_settle_s": settle_s,
        "call_rates_max": dict(sorted(fleet.budget.rates_max.items())),
        "aimd_ceiling_sums_max": dict(sorted(fleet.budget.ceilings_max.items())),
        "watch": {"polls": watch.result["polls"], "max_gap_s": watch.result["max_gap_s"],
                  "never_open": [t["kind"] for i, t in enumerate(plan) if i not in watch.result["open"]]},
        "stages": {"catalog": stage_catalog(pkg, [victim_metrics, final[survivor]["metrics"]])},
        "exit": exit_status,
        "aws_state": fleet.snapshot(),
    }


# ---------------------------------------------------------------------------
# the sim: fuzz scenarios and the rollout, through a given package
# ---------------------------------------------------------------------------

def run_fuzz(pkg, scenario: str, seed: int, profile: str):
    """One seeded scenario of ``pkg``'s fuzzer, played as its CLI plays
    it with ``--scenario``."""
    fuzz = pkg.fuzz
    runners = {
        "standard": fuzz.run_scenario,
        "resize": fuzz.run_resize_scenario,
        "autoscale": fuzz.run_autoscale_scenario,
        "autoscale-brownout": fuzz.run_autoscale_brownout_scenario,
    }
    return runners[scenario](seed, profile=profile)


def rollout_config(pkg, n: int):
    """The 7-virtual-day soak's harness configuration for ``n``
    Services: two replicas and production-shaped resync, drift, GC,
    snapshot, health and lease periods."""
    return pkg.harness.SimHarnessConfig(
        replicas=2,
        resync_period=6 * 3600.0,
        drift_tick_period=6 * 3600.0,
        gc_sweep_period=12 * 3600.0,
        settle_poll_interval=30.0,
        discovery_ttl=300.0,
        quota_accelerators=n + 50,
        health=pkg.health.HealthConfig(
            window=60.0,
            min_calls=6,
            failure_ratio=0.5,
            open_duration=30.0,
            probe_budget=1,
            aimd_qps=200.0,
        ),
        lease=pkg.leaderelection.LeaderElectionConfig(
            lease_duration=120.0, renew_deadline=60.0, retry_period=30.0
        ),
    )


def incomplete_chains(aws, lb_arns: list[str]) -> list[str]:
    """The Services ``svc{i}`` whose accelerator -> listener ->
    endpoint-group chain is missing, doubled, or not pointed at their
    own NLB ``lb_arns[i]``."""
    by_owner: dict = {}
    for arn, owner in aws.accelerator_owners().items():
        by_owner.setdefault(owner, []).append(arn)
    bad = []
    for i, lb_arn in enumerate(lb_arns):
        arns = by_owner.get(f"service/default/svc{i}", [])
        if len(arns) != 1:
            bad.append(f"svc{i}: {len(arns)} accelerators")
            continue
        listeners, _ = aws.list_listeners(arns[0], 100, None)
        if len(listeners) != 1:
            bad.append(f"svc{i}: {len(listeners)} listeners")
            continue
        groups, _ = aws.list_endpoint_groups(listeners[0].listener_arn, 100, None)
        endpoints = [d.endpoint_id for g in groups for d in g.endpoint_descriptions]
        if len(groups) != 1 or endpoints != [lb_arn]:
            bad.append(f"svc{i}: {len(groups)} endpoint groups, endpoints {endpoints}")
    return bad


def missing_records(aws, zone_id: str, n: int) -> list[str]:
    """The hostnames of annotated Services (every 20th) that lack their
    A record or its owner TXT twin."""
    have = {(r.name, r.type) for r in aws.records_in_zone(zone_id)}
    return [
        f"app{i}.example.com"
        for i in range(0, n, 20)
        if not {(f"app{i}.example.com.", "A"), (f"app{i}.example.com.", "TXT")} <= have
    ]


def rollout(pkg, n: int) -> dict:
    """A fleet of ``n`` Services arrives through ``pkg``'s sim harness:
    one NLB each, one hosted zone, every 20th Service hostname-
    annotated, the Services created evenly over ``ROLLOUT_SECONDS`` of
    virtual time.  The world then runs to quiescence (no queued,
    delayed or parked work and ``SETTLE_WINDOW`` virtual seconds
    without an AWS call).  Returns the run's numbers and the findings
    of the oracle battery and the chain and record checks (empty lists
    when clean)."""
    fuzz = pkg.fuzz
    wall_start = time.monotonic()
    with pkg.harness.SimHarness(config=rollout_config(pkg, n)) as harness:
        lb_arns = [
            harness.aws.add_load_balancer(f"lb{i}", REGION, fuzz._nlb_hostname(i)).load_balancer_arn
            for i in range(n)
        ]
        zone = harness.aws.add_hosted_zone("example.com")

        def creator():
            for i in range(n):
                harness.cluster.create("Service", fuzz._make_service(f"svc{i}", i, i % 20 == 0))
                yield ROLLOUT_SECONDS / n

        harness.spawn(creator(), "creator")
        harness.run_for(ROLLOUT_SECONDS)
        quiescent = harness.run_until_quiescent(QUIESCE_TIMEOUT, settle_window=SETTLE_WINDOW)
        wall = time.monotonic() - wall_start
        # read before the checks below, whose backend reads are calls
        stats, trace_hash = harness.stats(), harness.trace_hash()
        violations = pkg.oracles.standard_oracles(harness)
        incomplete = incomplete_chains(harness.aws, lb_arns)
        missing = missing_records(harness.aws, zone.id, n)
    return {
        "services": n,
        "quiescent": quiescent,
        "wall_s": wall,
        "stats": stats,
        "trace_hash": trace_hash,
        "violations": violations,
        "incomplete_chains": incomplete,
        "missing_records": missing,
    }


def shard_soak_config(pkg, n: int):
    """The two-shard soak's harness configuration for ``n`` Services
    (``tests/test_sharding_sim.py``: ``sharded_config`` with
    ``TestTwoShardSoak``'s overrides): two live replicas over two
    shards, each able to hold both, production-shaped resync, settle
    and discovery periods, breakers armed at scale, the global AIMD
    budget of ``bench.py``'s shard phase."""
    return pkg.harness.SimHarnessConfig(
        replicas=2,
        shard_count=2,
        shards_per_replica=2,
        resync_period=6 * 3600.0,
        settle_poll_interval=30.0,
        discovery_ttl=300.0,
        quota_accelerators=n + 50,
        lease=pkg.leaderelection.LeaderElectionConfig(
            lease_duration=120.0, renew_deadline=60.0, retry_period=30.0
        ),
        health=pkg.health.HealthConfig(
            window=60.0,
            min_calls=1000,
            failure_ratio=0.5,
            open_duration=30.0,
            probe_budget=1,
            aimd_qps=400.0,
        ),
    )


def shard_soak(pkg, n: int) -> dict:
    """``n`` Services, one NLB each, arrive over ``ROLLOUT_SECONDS`` of
    virtual time at a two-shard fleet; one replica is killed at
    ``SHARD_SOAK_KILL_AT`` and the survivor must steal its lease and
    adopt its keyspace.  The world runs ``SHARD_SOAK_SECONDS``, then to
    quiescence.  Returns the run's numbers, the oracle battery's and
    the SLO oracle's findings, the journey totals, the accelerator
    count and the final shard ownership."""
    fuzz = pkg.fuzz
    wall_start = time.monotonic()
    with pkg.harness.SimHarness(config=shard_soak_config(pkg, n)) as harness:
        for i in range(n):
            harness.aws.add_load_balancer(f"lb{i}", REGION, fuzz._nlb_hostname(i))

        def creator():
            for i in range(n):
                harness.cluster.create("Service", fuzz._make_service(f"svc{i}", i, False))
                yield ROLLOUT_SECONDS / n

        harness.spawn(creator(), "creator")
        harness.after(SHARD_SOAK_KILL_AT, lambda: harness.kill_shard_replica(), "kill-replica")
        harness.run_for(SHARD_SOAK_SECONDS)
        quiescent = harness.run_until_quiescent(SHARD_SOAK_SECONDS, settle_window=SETTLE_WINDOW)
        wall = time.monotonic() - wall_start
        stats, trace_hash = harness.stats(), harness.trace_hash()
        result = {
            "services": n,
            "quiescent": quiescent,
            "wall_s": wall,
            "stats": stats,
            "trace_hash": trace_hash,
            "violations": pkg.oracles.standard_oracles(harness),
            "slo_violations": pkg.oracles.check_slo(harness),
            "converged_total": harness.journey.converged_total,
            "inflight": harness.journey.inflight(),
            "accelerators": len(harness.aws.all_accelerator_arns()),
            "ownership": {k: sorted(v) for k, v in harness.shard_ownership().items()},
            "generations": harness.generations,
        }
    return result


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is false: this script runs on a CUDA card")
    card = card_line()
    print(card, flush=True)
    return card


def phase_converge(n: int, card: str) -> dict:
    pkg = load(PORT)
    fleet, _ = converge(pkg, n)
    (accels, listeners, groups), records, bound = fleet.progress()
    result = {
        "services": n,
        "ingresses": fleet.n_ing,
        "bindings": fleet.n_egb,
        "chains": [accels, listeners, groups],
        "records": records,
        "bound": bound,
        "aws_calls": len(fleet.aws.calls),
    }
    print(
        f"converge: {n} Services + {fleet.n_ing} Ingresses + {fleet.n_egb} bindings converged "
        f"({WORKERS} workers per controller, unshaped fake AWS): chains {result['chains']}, "
        f"{records} Route53 records, {bound} bindings bound, every thread joined (host-bound, "
        f"the card is idle in this phase) on {card}",
        flush=True,
    )
    print("converge " + json.dumps(result), flush=True)
    return result


def phase_process(n: int, card: str) -> dict:
    pkg = load(PORT)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-process-") as workdir:
        result = process(pkg, PORT, n, pathlib.Path(workdir))
    print(
        f"process: 2 controller replicas + webhook (python -m {PORT}), {n} Services + "
        f"{result['ingresses']} Ingresses over HTTP: one Lease holder, every Event, every object "
        f"converged on the leader's /debug/explain, AWS calls leader/standby "
        f"{result['aws_calls'][result['leader']]}/{result['aws_calls'][1 - result['leader']]}, "
        f"the webhook denied the ARN change and allowed the create, exits {result['exits']} "
        f"(host-bound, the card is idle in this phase) on {card}",
        flush=True,
    )
    summary = {k: v for k, v in result.items() if k not in ("events", "verdicts")}
    print("process " + json.dumps(summary), flush=True)
    return result


def phase_shard(n: int, card: str) -> dict:
    """The sharded fleet through the port's command line at
    ``SHARD_WIDTH``, at width 1 (one replica without leader election)
    and at width 2 with the holder of shard 0 killed (the plain width 2
    runs against the reference on the CPU,
    ``tests/test_torch_sharding_process.py``); ``shard_fleet`` holds
    each run to its hard bounds."""
    pkg = load(PORT)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-shard-") as workdir:
        for label, width, kill_at in (
            (str(SHARD_WIDTH), SHARD_WIDTH, None), ("1", 1, None), ("2-kill", 2, SHARD_KILL_AT)
        ):
            rundir = pathlib.Path(workdir) / label
            rundir.mkdir()
            run = shard_fleet(pkg, PORT, n, width, SHARD_LATENCY, rundir, kill_at=kill_at)
            del run["aws_state"]
            runs[label] = run
            kill = run["kill"]
            print(
                f"shard {label}: {width} x python -m {PORT} controller ({SHARD_WORKERS} workers, "
                f"{SHARD_LATENCY} s fake AWS latency): shards owned {run['owned']} disjointly, {n} "
                f"complete chains and never more, {run['journeys']['spec']} spec journeys, call "
                f"rates at most {run['call_rates_max']} /s and AIMD ceiling sums "
                f"{run['aimd_ceiling_sums']} /s per service (budget {SHARD_BUDGET_QPS}), exits "
                f"{run['exits']}"
                + ("" if kill is None else (
                    f"; SIGKILL to replica {kill['victim']} (shards {kill['owned']}) at chains "
                    f"{kill['chains']}, the survivor owned {kill['survivor_owned']}"
                ))
                + f" (host-bound, the card is idle in this phase) on {card}",
                flush=True,
            )
    print("shard " + json.dumps(runs), flush=True)
    return runs


def phase_resize(n: int, card: str) -> dict:
    """The runbook's live resize through the port's command line;
    ``resize_fleet`` holds it to its hard bounds."""
    pkg = load(PORT)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-resize-") as workdir:
        run = resize_fleet(pkg, PORT, n, SHARD_LATENCY, pathlib.Path(workdir))
    kill, watch = run["kill"], run["watch"]
    print(
        f"resize: 2 x python -m {PORT} controller --shard-count {RESIZE_FROM} "
        f"--shards-per-replica {RESIZE_CAPACITY} ({SHARD_WORKERS} workers, {SHARD_LATENCY} s fake "
        f"AWS latency), {n} Services: every replica stable at {RESIZE_TO}x64 after the grow "
        f"(owned {run['grown_owned']}), {run['create_accelerator']} create_accelerator calls, "
        f"{run['grow_journeys']['resize']} trigger=resize journeys for "
        f"{run['moved_keys_grow']['ring']} moved keys; SIGKILL to replica {kill['victim']} "
        f"(shards {kill['owned']}, states {kill['states']}) in the shrink, the survivor stable at "
        f"{RESIZE_FROM}x64; every Service converged after each resize; AIMD ceiling sums at most "
        f"{run['aimd_ceiling_sums_max']} /s, call rates at most {run['call_rates_max']} /s (budget "
        f"{SHARD_BUDGET_QPS}); duplicate watch {watch['polls']} reads, at most "
        f"{watch['max_gap_s']} s apart (bound {RESIZE_POLL_BOUND} s), no duplicate; survivor exit "
        f"{run['exit']} (host-bound, the card is idle in this phase) on {card}",
        flush=True,
    )
    print("resize " + json.dumps(run), flush=True)
    return run


def phase_autoscale(card: str) -> dict:
    """The autoscaler canary through the port's command line, the acting
    run and its observe-only twin side by side; ``autoscale_fleet``
    holds each to its hard bounds."""
    pkg = load(PORT)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-autoscale-") as workdir:
        runs = autoscale_runs(
            pkg, PORT, AUTOSCALE_BASE, AUTOSCALE_WAVE, SHARD_LATENCY, pathlib.Path(workdir)
        )
    acting, twin = runs["acting"], runs["observe-only"]
    out = acting["scale_out"]
    print(
        f"autoscale: {AUTOSCALE_REPLICAS} x python -m {PORT} controller --autoscale "
        f"--shard-count {AUTOSCALE_FROM} --shards-per-replica 1 (queue {AUTOSCALE_QUEUE[0]} qps / "
        f"burst {AUTOSCALE_QUEUE[1]}, {SHARD_WORKERS} workers, {SHARD_LATENCY} s fake AWS "
        f"latency, interval {AUTOSCALE_INTERVAL:g} s, cooldowns {AUTOSCALE_COOLDOWN_OUT:g}/"
        f"{AUTOSCALE_COOLDOWN_IN:g} s), {AUTOSCALE_BASE} Services then a wave of "
        f"{AUTOSCALE_WAVE}; acting: scale-out by replica {out['replica']} for {out['reason']} "
        f"{out['reaction_s']} s after the wave (bound {AUTOSCALE_REACTION_BOUND:g} s), ring epochs "
        f"{sorted(acting['epochs_s'])}, stable everywhere at {sorted(acting['stable_s'])}, "
        f"scale-in {acting['scale_in']}; observe-only twin: ring epochs {sorted(twin['epochs_s'])}, "
        f"target-shards gauge at most {twin['target_shards_max']}; create_accelerator "
        f"{acting['create_accelerator']}/{twin['create_accelerator']}, journeys in flight 0 on "
        f"every replica {acting['settle_s']} / {twin['settle_s']} s after calm (bound "
        f"{AUTOSCALE_SETTLE_S:g} s), AIMD ceiling sums over owners at most "
        f"{acting['aimd_ceiling_sums_max']} / {twin['aimd_ceiling_sums_max']} /s, call rates at "
        f"most {acting['call_rates_max']} / {twin['call_rates_max']} /s (budget "
        f"{SHARD_BUDGET_QPS}), no duplicate, exits {acting['exits']} / {twin['exits']} "
        f"(host-bound, the card is idle in this phase) on {card}",
        flush=True,
    )
    print("autoscale " + json.dumps(runs), flush=True)
    return runs


def phase_teardown(n: int, card: str) -> dict:
    """Half a sharded fleet deleted, the holder of shard 0 killed
    mid-teardown, the survivor's sweeper mopping up; ``teardown_fleet``
    holds the run to its hard bounds."""
    pkg = load(PORT)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-teardown-") as workdir:
        run = teardown_fleet(pkg, PORT, n, SHARD_LATENCY, pathlib.Path(workdir))
    del run["aws_state"]
    kill, gc, watch = run["kill"], TEARDOWN_GC, run["watch"]
    print(
        f"teardown: 2 x python -m {PORT} controller --shard-count 2 --shards-per-replica 2 "
        f"--gc-interval {gc['interval']:g} --gc-grace-sweeps {gc['grace_sweeps']} "
        f"--gc-max-deletes {gc['max_deletes']} ({SHARD_WORKERS} workers, {SHARD_LATENCY} s fake "
        f"AWS latency, accelerators settling through {TEARDOWN_SETTLE} reads), {n} Services "
        f"({run['hostnames']} hostnames), {run['deleted']} deleted; SIGKILL to replica "
        f"{kill['victim']} (shards {kill['owned']}) with {kill['victim_orphans']} orphans of its "
        f"shards left; the survivor's sweeper deleted {run['gc_survivor']['deleted_total']}, the "
        f"last orphan gone {run['mop_up_s']} s after the kill (bound {run['mop_up_bound_s']} s), "
        f"no sweep over {gc['max_deletes']} deletes, no second disable {run['disables']}; the "
        f"kept half untouched in {watch['polls']} watch reads, at most {watch['max_gap_s']} s "
        f"apart; journeys 0 on the survivor {run['journeys_settle_s']} s after calm (bound "
        f"{AUTOSCALE_SETTLE_S:g} s); AIMD ceiling sums at most {run['aimd_ceiling_sums_max']} /s, "
        f"call rates at most {run['call_rates_max']} /s (budget {SHARD_BUDGET_QPS}); survivor exit "
        f"{run['exit']} (host-bound, the card is idle in this phase) on {card}",
        flush=True,
    )
    print("teardown " + json.dumps(run), flush=True)
    return run


def phase_drift(n: int, card: str) -> dict:
    """Drift resync over the port's command line, with the holder of
    shard 0 killed mid-repair and the bindings' finalizers run;
    ``drift_fleet`` holds the run to its hard bounds."""
    pkg = load(PORT)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-drift-") as workdir:
        run = drift_fleet(pkg, PORT, n, SHARD_LATENCY, pathlib.Path(workdir))
    del run["aws_state"]
    kill, watch = run["kill"], run["watch"]
    reads = {r: t["timed"][-1]["reads"] for r, t in run["ticks"].items()}
    repairs = ", ".join(
        f"{r['kind']}@{r['shard']} {r['repair_s']} s (bound {r['bound_s']} s, by the {r['by']})"
        for r in run["repairs"]
    )
    print(
        f"drift: 2 x python -m {PORT} controller --shard-count 2 --shards-per-replica 2 "
        f"--drift-resync-period {run['period_s']:g} ({SHARD_WORKERS} workers, {SHARD_LATENCY} s fake "
        f"AWS latency, AGAC_DISCOVERY_CACHE_TTL={run['period_s']:g}), {n} Services + "
        f"{run['ingresses']} Ingresses + {run['bindings']} bindings ({run['hostnames']} TXT+A "
        f"pairs); a verifying tick's reads per replica {reads} within their ceilings; tampers "
        f"repaired: {repairs}; SIGKILL to replica {kill['victim']} (shards {kill['owned']}) with "
        f"{kill['open']} of its shard open, the survivor held both shards; bindings finalized, "
        f"the out-of-band chains as built, the fleet's chains and pairs at the end, no reconcile "
        f"of a key a replica's shards did not own; journeys 0 on the survivor "
        f"{run['journeys_settle_s']} s after the finalizers (bound "
        f"{run['period_s'] + AUTOSCALE_SETTLE_S:g} s); AIMD ceiling sums at most "
        f"{run['aimd_ceiling_sums_max']} /s, call rates at most {run['call_rates_max']} /s (budget "
        f"{SHARD_BUDGET_QPS}); watch {watch['polls']} reads, at most {watch['max_gap_s']} s apart, "
        f"no duplicate; survivor exit {run['exit']} (host-bound, the card is idle in this phase) "
        f"on {card}",
        flush=True,
    )
    print("drift " + json.dumps(run), flush=True)
    return run


def sim_replay(pkg, card: str) -> list[dict]:
    """Every checked-in capture replays byte-identically with clean
    oracles through ``pkg``'s replay harness."""
    paths = sorted(CAPTURES.glob("*.jsonl"))
    if not paths:
        raise PhaseError(f"no incident captures under {CAPTURES}")
    out = []
    for path in paths:
        start = time.monotonic()
        result = pkg.replay.replay_capture(path)
        wall = time.monotonic() - start
        if not result.identical or result.violations:
            where = result.divergence.describe() if result.divergence is not None else ""
            raise PhaseError(
                f"replay of {path.name}: identical={result.identical} "
                f"violations={result.violations} {where}"
            )
        print(
            f"sim replay: {path.name} ok events={result.recorded_events} "
            f"hash={result.recorded_hash[:16]} in {wall} s wall on the host of {card}",
            flush=True,
        )
        out.append(
            {
                "capture": path.name,
                "events": result.recorded_events,
                "hash": result.recorded_hash,
                "wall_s": wall,
            }
        )
    return out


def sim_fuzz(pkg, card: str) -> list[dict]:
    """The pinned scenarios: each clean, each with the port's pinned
    hash."""
    out = []
    for (scenario, seed, profile), pinned in PORT_FUZZ_PINS.items():
        start = time.monotonic()
        result = run_fuzz(pkg, scenario, seed, profile)
        wall = time.monotonic() - start
        stats = result.stats
        print(
            f"sim fuzz: {scenario} seed {seed} [{profile}] "
            f"{'ok' if result.ok else 'FAIL'} trace={result.trace_hash[:16]} "
            f"virtual={stats['virtual_time']}s calls={stats['aws_calls']} "
            f"in {wall} s wall on the host of {card}",
            flush=True,
        )
        if not result.ok:
            raise PhaseError(f"{scenario} seed {seed} [{profile}]: {result.violations}")
        if result.trace_hash != pinned:
            raise PhaseError(
                f"{scenario} seed {seed} [{profile}]: trace {result.trace_hash} != pinned {pinned}"
            )
        out.append(
            {
                "scenario": scenario,
                "seed": seed,
                "profile": profile,
                "trace_hash": result.trace_hash,
                "virtual_s": stats["virtual_time"],
                "aws_calls": stats["aws_calls"],
                "wall_s": wall,
            }
        )
    return out


def sim_rollout(pkg, n: int, card: str) -> dict:
    """The rollout of ``n`` Services: quiescent, clean, every chain and
    record pair in place, and the pinned hash where one is pinned."""
    result = rollout(pkg, n)
    stats = result["stats"]
    print(
        f"sim rollout: {n} Services in {result['wall_s']} s wall, "
        f"virtual {stats['virtual_time']} s "
        f"({stats['virtual_time'] / result['wall_s']} virtual s per wall s), "
        f"{stats['aws_calls']} AWS calls, trace={result['trace_hash'][:16]} "
        f"on the host of {card}",
        flush=True,
    )
    faults = {
        key: result[key][:10]
        for key in ("violations", "incomplete_chains", "missing_records")
        if result[key]
    }
    if not result["quiescent"] or faults:
        raise PhaseError(f"rollout of {n}: quiescent={result['quiescent']} {faults}")
    pinned = PORT_ROLLOUT_PINS.get(n)
    if pinned is not None and result["trace_hash"] != pinned:
        raise PhaseError(f"rollout of {n}: trace {result['trace_hash']} != pinned {pinned}")
    return {
        "services": n,
        "wall_s": result["wall_s"],
        "virtual_s": stats["virtual_time"],
        "virtual_per_wall": stats["virtual_time"] / result["wall_s"],
        "events": stats["events"],
        "aws_calls": stats["aws_calls"],
        "trace_hash": result["trace_hash"],
        "pinned": pinned is not None,
    }


def sim_shard_soak(pkg, n: int, card: str) -> dict:
    """The two-shard soak of ``n`` Services with its mid-run kill: every
    bound of ``TestTwoShardSoak``, and the pinned hash where one is
    pinned."""
    result = shard_soak(pkg, n)
    stats = result["stats"]
    print(
        f"sim shard-soak: {n} Services on 2 shards, replica killed at virtual hour 3, in "
        f"{result['wall_s']} s wall, virtual {stats['virtual_time']} s, "
        f"{stats['aws_calls']} AWS calls, {result['converged_total']} journeys converged, "
        f"ownership {result['ownership']}, generations {result['generations']}, "
        f"trace={result['trace_hash'][:16]} on the host of {card}",
        flush=True,
    )
    faults = {
        key: result[key][:10] for key in ("violations", "slo_violations") if result[key]
    }
    if not result["quiescent"] or faults:
        raise PhaseError(f"shard soak of {n}: quiescent={result['quiescent']} {faults}")
    if result["converged_total"] < n or result["inflight"] or result["accelerators"] != n:
        raise PhaseError(
            f"shard soak of {n}: {result['converged_total']} journeys converged, "
            f"{result['inflight']} in flight, {result['accelerators']} accelerators"
        )
    if list(result["ownership"].values()) != [[0, 1]] or result["generations"] < 2:
        raise PhaseError(
            f"shard soak of {n}: ownership {result['ownership']}, "
            f"{result['generations']} generations"
        )
    pinned = PORT_SHARD_SOAK_PINS.get(n)
    if pinned is not None and result["trace_hash"] != pinned:
        raise PhaseError(f"shard soak of {n}: trace {result['trace_hash']} != pinned {pinned}")
    return {
        "services": n,
        "wall_s": result["wall_s"],
        "virtual_s": stats["virtual_time"],
        "virtual_per_wall": stats["virtual_time"] / result["wall_s"],
        "events": stats["events"],
        "aws_calls": stats["aws_calls"],
        "converged_total": result["converged_total"],
        "ownership": result["ownership"],
        "generations": result["generations"],
        "trace_hash": result["trace_hash"],
        "pinned": pinned is not None,
    }


def phase_sim(n: int, card: str) -> dict:
    pkg = load(PORT)
    start = time.monotonic()
    result = {
        "replay": sim_replay(pkg, card),
        "fuzz": sim_fuzz(pkg, card),
        "rollout": sim_rollout(pkg, n, card),
        "shard_soak": sim_shard_soak(pkg, n, card),
    }
    result["wall_s"] = time.monotonic() - start
    print(
        f"sim: replay, fuzz, rollout and shard-soak in {result['wall_s']} s wall (host-bound, "
        f"the card is idle in this phase; stage attribution not measured: under the sim runtime "
        f"the accountant charges virtual time and the sampler does not start) on {card}",
        flush=True,
    )
    print("sim " + json.dumps(result), flush=True)
    return result


def analysis_static(card: str) -> dict:
    """The port's linter and whole-program analyses over the port."""
    lint = importlib.import_module(f"{PORT}.analysis.lint")
    program_mod = importlib.import_module(f"{PORT}.analysis.program")
    root = REPO / PORT
    start = time.monotonic()
    violations = lint.lint_paths([root], workflows_dir=WORKFLOWS)
    lint_s = time.monotonic() - start
    if violations:
        raise PhaseError("lint: " + "; ".join(v.render() for v in violations[:10]))
    start = time.monotonic()
    rules = program_mod._load_analyses()
    program = program_mod.Program.build([root], program_mod.shared_cache())
    findings, blocks = program_mod.run_analyses(program, rules)
    report = program_mod.build_report(
        program, findings, blocks, program_mod.Baseline.load(PORT_BASELINE)
    )
    program_s = time.monotonic() - start
    failures = program_mod.gate_failures(report)
    if failures:
        raise PhaseError("program gate: " + "; ".join(failures[:10]))
    files = [p for p in root.rglob("*.py") if "__pycache__" not in p.parts]
    if report["modules"] != len(files):  # a gate over fewer modules is vacuous
        raise PhaseError(f"the analyses saw {report['modules']} of {len(files)} modules")
    result = {
        "modules": report["modules"],
        "lint_violations": len(violations),
        "lint_s": lint_s,
        "findings": len(findings),
        "grandfathered": len(report["baseline"]["grandfathered"]),
        "gate_failures": len(failures),
        "program_s": program_s,
        "locks": len(blocks["lock-order"]["locks"]),
        "static_edges": len(blocks["lock-order"]["edges"]),
    }
    print(
        f"analysis static: lint over {report['modules']} modules, {len(violations)} "
        f"violations in {lint_s} s; program analyses {len(findings)} findings, "
        f"{result['grandfathered']} grandfathered, {len(failures)} gate failures in "
        f"{program_s} s (host, the card is idle) on {card}",
        flush=True,
    )
    return result


def analysis_crosscheck(pkg, n: int, card: str) -> dict:
    """Converge's fleet through the chaos fault plan under the racecheck
    watchdog, then the watchdog's lock edges and stage accesses against
    the static lock graph and footprint table of the port."""
    racecheck = importlib.import_module(f"{PORT}.analysis.racecheck")
    lockorder = importlib.import_module(f"{PORT}.analysis.lockorder")
    confinement = importlib.import_module(f"{PORT}.analysis.confinement")
    n_objects = n + sum(scaled_counts(n))
    chaos = dict(CHAOS, fault_budget=CHAOS_FAULTS_PER_OBJECT * n_objects)
    watchdog = racecheck.enable()  # before any lock of the fleet exists
    try:
        fleet, elapsed = converge(pkg, n, chaos=chaos)
        watchdog.assert_clean()
        edges, accesses = watchdog.edges(), watchdog.stage_accesses()
    finally:
        racecheck.disable()
    faults = fleet.aws.fault_plan.faults_served
    if faults == 0:
        raise PhaseError("the chaos plan injected no fault")
    lock_violations, unmapped = lockorder.runtime_crosscheck(edges)
    footprint_violations, unmapped_accesses = confinement.runtime_footprint_crosscheck(accesses)
    if lock_violations or footprint_violations:
        raise PhaseError("; ".join((lock_violations + footprint_violations)[:10]))
    result = {
        "services": n,
        "ingresses": fleet.n_ing,
        "bindings": fleet.n_egb,
        "faults_injected": faults,
        "elapsed_s": elapsed,
        "observed_edges": len(edges),
        "unmapped_edges": len(unmapped),
        "stage_accesses": len(accesses),
        "unmapped_accesses": len(unmapped_accesses),
        "lock_violations": len(lock_violations),
        "footprint_violations": len(footprint_violations),
    }
    print(
        f"analysis crosscheck: {n} Services + {fleet.n_ing} Ingresses + {fleet.n_egb} "
        f"bindings converged through {faults} injected faults under the racecheck watchdog; "
        f"{len(edges)} observed lock edges ({len(unmapped)} unmapped), {len(accesses)} "
        f"stage accesses ({len(unmapped_accesses)} unmapped), 0 violations "
        f"(host, the card is idle) on {card}",
        flush=True,
    )
    return result


def phase_analysis(n: int, card: str) -> dict:
    start = time.monotonic()
    result = {
        "static": analysis_static(card),
        "crosscheck": analysis_crosscheck(load(PORT), n, card),
    }
    result["wall_s"] = time.monotonic() - start
    print(f"analysis: static and cross-check in {result['wall_s']} s wall on {card}", flush=True)
    print("analysis " + json.dumps(result), flush=True)
    return result


def graft_dryrun(torch, ge, card: str) -> dict:
    """The data x model dry run on the CPU, held to the unsharded train
    step on the same weights (seed 0's, all-ones data)."""
    import contextlib
    import io

    params = ge.init_params(torch.Generator().manual_seed(0))
    out = io.StringIO()
    start = time.monotonic()
    with contextlib.redirect_stdout(out):
        loss, new = ge.dryrun_multichip(DRYRUN_DEVICES, params)
    wall = time.monotonic() - start
    line = out.getvalue().strip()
    data, model = ge.mesh_shape(DRYRUN_DEVICES)
    if f"dryrun_multichip OK: mesh=({data} data x {model} model), loss=" not in line:
        raise PhaseError(f"dry run printed {line!r}")
    batch = ge.dryrun_batch(data)
    ones = torch.ones(batch, ge.FEATURES, dtype=torch.bfloat16)
    single = ge.GraftMLP(params)
    ref_loss = float(ge.train_step(single, ones, ones))
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    if not loss_rel <= 1e-4:
        raise PhaseError(f"dry-run loss {loss} vs unsharded {ref_loss} (rel {loss_rel})")
    for name in ("w1", "w2"):
        torch.testing.assert_close(new[name], getattr(single, name).detach())
    print(
        f"graft dryrun: {line}; unsharded loss {ref_loss} (rel diff {loss_rel}); "
        f"{DRYRUN_DEVICES} gloo processes on the host CPU of {card} in {wall} s wall",
        flush=True,
    )
    return {"dryrun_loss": loss, "dryrun_unsharded_loss": ref_loss,
            "dryrun_loss_rel_diff": loss_rel, "dryrun_s": wall}


def _reference_forward(torch, params: dict, x):
    """The MLP in float32 on the CPU, rounding to bf16 where the bf16
    program stores: the hidden pre-activation, the activation and the
    output."""
    f32 = {k: v.detach().float().cpu() for k, v in params.items()}
    pre = (x.float().cpu() @ f32["w1"]).to(torch.bfloat16)
    hidden = torch.tanh(pre.float()).to(torch.bfloat16)
    return (hidden.float() @ f32["w2"]).to(torch.bfloat16)


def graft_bounds(ge) -> dict:
    """The least time the card could take for the MLP's forward and
    train step: the larger of the bytes each must move (every input
    read once, every output written once) over the memory rate and its
    matrix-product FLOPs over the bf16 rate."""
    b, f, h, bf16 = ge.BATCH, ge.FEATURES, ge.HIDDEN, 2
    weights = 2 * f * h * bf16
    matmul = 2 * b * f * h  # FLOPs of one (32, 64) x (64, 128) product
    steps = {
        # x, w1, w2 in; the output out
        "forward": (b * f * bf16 + weights + b * f * bf16, 2 * matmul),
        # x, y, w1, w2 in; w1, w2 and the f32 loss out; two products
        # forward, three backward (dW2, dH, dW1)
        "train_step": (2 * b * f * bf16 + 2 * weights + 4, 5 * matmul),
    }
    out = {}
    for name, (nbytes, flops) in steps.items():
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
        out[f"{name}_bound_ms"] = max(t_bytes, t_ops) * 1e3
        out[f"{name}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def _cuda_ms(torch, fn, iters: int = 200) -> float:
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, iters: int = 50) -> float:
    fn()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - start) * 1e3 / iters


def phase_graft(torch, seed: int, card: str) -> dict:
    from agac_tpu_torch import graft_entry as ge

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    params = ge.init_params(gen)
    x = torch.randn(ge.BATCH, ge.FEATURES, generator=gen).to(torch.bfloat16)
    y = torch.randn(ge.BATCH, ge.FEATURES, generator=gen).to(torch.bfloat16)

    # the entry point a user calls: (fn, (params, x)) on the card
    fn, (entry_params, entry_x) = ge.entry()
    entry_out = fn(entry_params, entry_x)
    torch.cuda.synchronize()
    if entry_out.device.type != "cuda" or tuple(entry_out.shape) != (ge.BATCH, ge.FEATURES):
        raise PhaseError(f"entry() gave {entry_out.shape} on {entry_out.device}")
    torch.testing.assert_close(entry_out.cpu(), _reference_forward(torch, entry_params, entry_x))

    model = ge.GraftMLP({k: v.to(cuda) for k, v in params.items()})
    xd, yd = x.to(cuda), y.to(cuda)
    with torch.no_grad():
        out = model(xd)
    torch.cuda.synchronize()
    ref_out = _reference_forward(torch, params, x)
    if not bool(torch.isfinite(out.float()).all()):
        raise PhaseError("forward output is not finite")
    torch.testing.assert_close(out.cpu(), ref_out)  # the bf16 defaults
    forward_err = float((out.float().cpu() - ref_out.float()).abs().max())

    # one train step on the card; the reference step runs the same
    # weights on the CPU (bf16 storage, float32 loss and update)
    loss = ge.train_step(model, xd, yd)
    torch.cuda.synchronize()
    cpu_model = ge.GraftMLP(params)
    ref_loss = ge.train_step(cpu_model, x, y)
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    if not (bool(torch.isfinite(loss)) and loss_rel <= 1e-3):
        raise PhaseError(f"train-step loss {float(loss)} vs CPU {float(ref_loss)} (rel {loss_rel})")
    for name in ("w1", "w2"):
        torch.testing.assert_close(
            getattr(model, name).detach().cpu(), getattr(cpu_model, name).detach()
        )

    with torch.no_grad():
        fwd_ms = _cuda_ms(torch, lambda: model(xd))
        cpu_fwd_ms = _host_ms(lambda: cpu_model(x))
    step_ms = _cuda_ms(torch, lambda: ge.train_step(model, xd, yd))
    cpu_step_ms = _host_ms(lambda: ge.train_step(cpu_model, x, y))
    dryrun = graft_dryrun(torch, ge, card)
    result = {
        "forward_max_abs_err": forward_err,
        "loss": float(loss),
        "cpu_loss": float(ref_loss),
        "loss_rel_diff": loss_rel,
        "forward_ms": fwd_ms,
        "train_step_ms": step_ms,
        "cpu_forward_ms": cpu_fwd_ms,
        "cpu_train_step_ms": cpu_step_ms,
        **graft_bounds(ge),
        **dryrun,
    }
    print(
        f"graft: forward (32, 64) bf16 {fwd_ms} ms (bound {result['forward_bound_ms']} ms), "
        f"train step {step_ms} ms (bound {result['train_step_bound_ms']} ms) on {card} "
        f"(CUDA events, mean of 200); host CPU forward {cpu_fwd_ms} ms, "
        f"train step {cpu_step_ms} ms",
        flush=True,
    )
    print("graft " + json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--services", type=int, default=200, help="Services in the fleet")
    parser.add_argument(
        "--sim-services", type=int, default=SIM_SERVICES,
        help="Services in the sim rollout and the shard soak",
    )
    parser.add_argument("--seed", type=int, default=0, help="seed of the graft MLP's weights")
    args = parser.parse_args(argv)
    try:
        import torch

        load(PORT)  # fails here, before any result, outside a checkout
        card = phase_device(torch)
        phase_converge(args.services, card)
        phase_process(PROCESS_SERVICES, card)
        phase_shard(SHARD_SERVICES, card)
        phase_resize(SHARD_SERVICES, card)
        phase_autoscale(card)
        phase_teardown(SHARD_SERVICES, card)
        # the sim is one thread on virtual time: it runs in a process of
        # its own beside drift and analysis, whose fleets wait on the
        # fake account's latency and the lease, on other cores
        context = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(1, mp_context=context) as pool:
            sim = pool.submit(phase_sim, args.sim_services, card)
            phase_drift(SHARD_SERVICES, card)
            phase_analysis(args.services, card)
            sim.result()
        phase_graft(torch, args.seed, card)
    except Exception as err:  # every phase's failure ends the run here
        print(f"chip_smoke FAILED: {type(err).__name__}: {err}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": []}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
