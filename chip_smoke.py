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
4. ``shard``: the sharded deployment, ``bench.py``'s scaling curve over
   the port's command line.  At widths 1, 2 and 4, that many ``python
   -m agac_tpu_torch controller --shard-count W`` replicas share one
   HTTP apiserver and one flock-arbitrated fake AWS account
   (``AGAC_FAKE_STATE``, 0.3 s per call) and converge 200 Services on
   one NLB, created once every shard lease is held; a fourth run at
   width 2 kills the holder of shard 0 with SIGKILL halfway, and the
   survivor must steal its lease and finish.  Read over the wire, each
   run must show disjoint lease ownership, exactly 200 complete
   chains, an aggregate call rate and summed AIMD ceilings within the
   400/s per-service budget, a journey closed per Service in the
   fleet-merged metrics and, after the kill, the survivor owning every
   shard.  Objects/s, speedup and efficiency per width print beside
   ``bench.py``'s gates, which measure the host and are not enforced.
   Host code: the card is idle in this phase.
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
   the 400/s per-service budget at every ring and answer
   ``converged`` for every Service.  Transition times, handoff
   windows, moved keys and the resize journeys' percentiles print
   beside the bounds.  Host code: the card is idle in this phase.
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
   journey in flight on any replica once the wave is done.  Reaction,
   drain times with and without the scale-out, decisions per replica
   and the journeys' percentiles print beside the bounds.  Host code:
   the card is idle in this phase.
7. ``sim``: the port's virtual-time runtime, which runs the whole
   Manager on one thread and folds every dispatch into a SHA-256
   event-trace hash.  ``replay`` replays every checked-in incident
   capture (``tests/captures/*.jsonl``) and requires a byte-identical
   hash chain and a clean oracle battery; ``fuzz`` plays the
   standard scenario's seeds 1-5 at ``quick`` and seed 1 of the
   resize, autoscale and autoscale-brownout scenarios at ``mini``, and
   requires clean oracles and the trace hashes pinned in
   ``FUZZ_PINS``; ``rollout`` brings a fleet of ``--sim-services``
   Services (default 10,000, the sim's documented scale) up over two
   virtual hours on two replicas, runs to quiescence and requires
   clean oracles, a complete accelerator chain per Service, the
   TXT+A pair per hostname-annotated Service and, where
   ``ROLLOUT_PINS`` holds one for N, the pinned trace hash;
   ``shard-soak`` brings the same number of Services up on two shards,
   kills a replica at virtual hour 3 and requires clean oracles and
   SLOs, every journey closed, one accelerator per Service, one owner
   of both shards and, where ``SHARD_SOAK_PINS`` holds one, the pinned
   hash.  The pins are what the reference package computes for the
   same runs.  Host code: the card is idle in this phase.
8. ``analysis``: the port's static analyses over its own tree, then
   their runtime cross-check at fleet scale.  The port's linter must
   find nothing and its whole-program analyses (lock order, census,
   determinism, confinement) must pass their gate with the port's
   baseline.  ``converge``'s fleet then converges again, through the
   chaos tier's seeded fault plan (every AWS call may fail, mutations
   may fail after committing) under the racecheck watchdog, and the
   watchdog's observed lock edges and stage-tagged writes must fall
   inside the static lock graph and footprint table.  Host code: the
   card is idle in this phase.
9. ``graft``: the torch twin of the MLP, forward and
   one train step on ``cuda``, held against the same weights run on
   the CPU in float32 with bf16 rounding at the same points; then the
   JAX program's multi-chip dry run, one train step over a 4 x 2 data x
   model mesh of 8 gloo processes on the CPU, held to the unsharded
   step.

The port has no hand-written kernel (the reference holds no Pallas
kernel), so the kernel line lists none.  The last line is
``{"ok": true, "device": {...}}``.

The fleet helpers, ``converge``, ``process``, ``shard_fleet``,
``resize_fleet``, ``autoscale_fleet``, ``rollout`` and ``shard_soak`` take the package as a parameter so that
tests can run the same fleet through the reference; this script itself
only ever loads the port.
"""

from __future__ import annotations

import argparse
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

# the shard phase: bench.py's scaling-curve sweep (bench.py:1255-1290),
# its fleet (SHARD_N Services on one NLB), workers, call latency and
# global per-service AWS budget.  Width 8 is cut: eight processes x 8
# workers beside the apiserver on the card host's 8 cores measure the
# host (bench.py:1260-1264)
SHARD_SERVICES = 200
SHARD_WIDTHS = (1, 2, 4)
SHARD_WORKERS = 8
SHARD_LATENCY = 0.3
SHARD_BUDGET_QPS = 400.0
SHARD_LB = ("shardlb", f"shardlb-0123456789abcdef.elb.{REGION}.amazonaws.com")
# the failover run kills the holder of shard 0 once this share of the
# fleet's chains is complete
SHARD_KILL_AT = 0.5
# the bench's gates, printed beside the curve but not enforced: they
# measure the host's cores
SHARD_MIN_SPEEDUP_2, SHARD_MIN_EFFICIENCY_4 = 1.7, 0.75
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
# the duplicate watch reads the state file every RESIZE_POLL s, and fails
# when two reads are more than RESIZE_POLL_BOUND s apart
RESIZE_POLL, RESIZE_POLL_BOUND = 0.1, 0.5
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
AUTOSCALE_COOLDOWN_OUT, AUTOSCALE_COOLDOWN_IN = 90.0, 120.0
AUTOSCALE_INTERVAL = 5.0
# ring epoch 1 must be requested within this many s of the wave's first create
AUTOSCALE_REACTION_BOUND = 180.0
# the run ends this long after epoch 1 when no scale-in came, or this long
# after the scale-in's ring is stable
AUTOSCALE_HOLD_S, AUTOSCALE_TAIL_S = 180.0, 30.0
# every replica's journeys in flight reach 0 within this long of the last
# chain completing with the ring stable
AUTOSCALE_SETTLE_S = 15.0
# seconds between the phase's reads of the replicas, and between its
# reads of the cores busy (longer: a container host's CPU accounting can
# be coarse over a second)
AUTOSCALE_READ, AUTOSCALE_BUSY_READ = 1.0, 5.0
# the observe-only twin starts this long after the acting run, so the two
# fleets' start-ups and waves do not land on the host's cores at once (it
# still ends before the acting run, which waits out cooldown-in)
AUTOSCALE_TWIN_DELAY = 30.0

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
# Services in the rollout -> the reference's event-trace hash
ROLLOUT_PINS = {
    10_000: "29dc7b0962778f0abe088d1b37bbe44a1a82873a15346f6924723883a9f98abd",
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
    return zones, group_arns


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
# the process phase: a package's command line against an HTTP apiserver
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


def scrape_replica(port: int) -> dict:
    """One replica as an operator scrapes it, ``bench.py``'s reads:
    AWS calls per service family and per operation off ``/metrics``,
    AIMD ceilings per family off ``/readyz`` and the shard block of
    ``/healthz``."""
    metrics = _http(f"http://127.0.0.1:{port}/metrics").decode()
    calls: dict[str, float] = {}
    ops: dict[str, float] = {}
    for line in metrics.splitlines():
        if line.startswith("agac_aws_api_calls_total{"):
            labels, _, value = line.rpartition(" ")
            # elbv2[region] folds into elbv2: the budget is per family
            family = labels.split('service="')[1].split('"')[0].split("[", 1)[0]
            calls[family] = calls.get(family, 0.0) + float(value)
            op = labels.split('op="')[1].split('"')[0]
            ops[op] = ops.get(op, 0.0) + float(value)
    ceilings: dict[str, float] = {}
    for service, snap in _get_json(f"http://127.0.0.1:{port}/readyz").get("services", {}).items():
        if "aimd_ceiling" in snap:
            family = service.split("[", 1)[0]
            ceilings[family] = ceilings.get(family, 0.0) + snap["aimd_ceiling"]
    sharding = _get_json(f"http://127.0.0.1:{port}/healthz")["sharding"]
    return {
        "calls": calls, "ops": ops, "ceilings": ceilings, "sharding": sharding, "metrics": metrics
    }


def cpu_seconds(pid: int) -> float:
    """User and system CPU seconds process ``pid`` has used so far."""
    fields = pathlib.Path(f"/proc/{pid}/stat").read_text().rpartition(")")[2].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class Child:
    """One command-line process of the package.  Its output goes to
    files: a pipe that nobody drains would fill and block it."""

    def __init__(self, name: str, argv: list[str], env: dict, workdir: pathlib.Path):
        self.name = name
        self.peak_rss_mib: float | None = None  # the largest sample so far
        self.err_path = workdir / f"{name}.stderr"
        with open(workdir / f"{name}.stdout", "w") as out, open(self.err_path, "w") as err:
            self.popen = subprocess.Popen(
                argv, cwd=REPO, env=env, stdin=subprocess.DEVNULL, stdout=out, stderr=err
            )

    def stderr(self) -> str:
        return self.err_path.read_text(errors="replace")

    def check_alive(self) -> None:
        """Fail when the process has exited; else sample its resident
        set (``/proc/<pid>/statm``; a kernel that keeps no peak per
        process leaves only sampling)."""
        if self.popen.poll() is not None:
            raise PhaseError(
                f"{self.name} exited early with {self.popen.returncode}: {self.stderr()[-3000:]}"
            )
        try:
            pages = int(pathlib.Path(f"/proc/{self.popen.pid}/statm").read_text().split()[1])
        except (OSError, IndexError, ValueError):
            return
        rss = pages * os.sysconf("SC_PAGE_SIZE") / 2**20
        self.peak_rss_mib = max(rss, self.peak_rss_mib or 0.0)

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


def _wait_for(what: str, probe, children: list[Child], start: float):
    """Poll ``probe`` until it returns a true value; fail at once when a
    child exits, and at ``PROCESS_DEADLINE`` seconds after ``start``."""
    while True:
        for child in children:
            child.check_alive()
        value = probe()
        if value:
            return value
        if time.monotonic() - start > PROCESS_DEADLINE:
            raise PhaseError(f"no {what} within {PROCESS_DEADLINE} s")
        time.sleep(0.25)


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


def _check_webhook(pkg, package: str, env: dict, workdir: pathlib.Path, children: list) -> dict:
    """``python -m <package> webhook``: an ``EndpointGroupArn`` change is
    denied and a create allowed."""
    port = _free_port()
    webhook = Child(
        "webhook", [sys.executable, "-m", package, "webhook", "--ssl=false", "--port", str(port)],
        env, workdir,
    )
    children.append(webhook)

    def healthy() -> bool:
        try:
            return _http(f"http://127.0.0.1:{port}/healthz") == b"ok"
        except OSError:
            return False

    _wait_for("webhook /healthz", healthy, [webhook], time.monotonic())
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
    stop every child with SIGTERM.  Returns the run's times, the Events
    as (reason, kind, namespace/name) triples, every object's explain
    verdict, and each child's exit status and peak RSS."""
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
    server = pkg.testserver.TestApiServer().start()
    children: list[Child] = []
    try:
        for kind, obj in objects:  # in storage, before any controller starts
            server.cluster.create(kind, obj)
        kubeconfig = write_kubeconfig(workdir, server.url)
        client = pkg.rest.RestClusterClient(server.url)
        ports = [_free_port(), _free_port()]
        start = time.monotonic()
        for replica, port in enumerate(ports):
            children.append(Child(
                f"controller-{replica}",
                [sys.executable, "-m", package, *CHART_ARGS, "--kubeconfig", str(kubeconfig),
                 "--health-port", str(port)],
                env, workdir,
            ))

        def holder() -> str:
            try:
                return client.get("Lease", LEASE_NAMESPACE, LEASE_NAME).spec.holder_identity or ""
            except pkg.errors.NotFoundError:
                return ""

        leader_id = _wait_for("Lease holder", holder, children, start)
        lease_s = time.monotonic() - start

        def logged_by() -> list[int]:  # each replica logs its elector identity
            line = f"leader election id: {leader_id}"
            return [replica for replica, c in enumerate(children) if line in c.stderr()]

        (leader,) = _wait_for("leader's identity in a replica's log", logged_by, children, start)

        def events() -> set:
            return {
                (e.reason, e.involved_object.kind,
                 f"{e.involved_object.namespace}/{e.involved_object.name}")
                for e in client.list("Event")[0]
            }

        _wait_for("full set of Events", lambda: expected <= events(), children, start)
        events_s = time.monotonic() - start

        pending = {key for _, key in keys}
        verdicts: dict[str, str] = {}

        def converged() -> bool:
            for key in sorted(pending):
                answer = json.loads(_http(
                    f"http://127.0.0.1:{ports[leader]}/debug/explain?key={key}"
                ))
                verdicts[key] = answer["verdict"]
                if answer["verdict"] == "converged":
                    pending.discard(key)
            return not pending

        _wait_for("converged verdict for every object", converged, children, start)
        converged_s = time.monotonic() - start
        seen = events()
        if holder() != leader_id:
            raise PhaseError(f"the Lease moved from {leader_id} to {holder()} during the run")
        standby = 1 - leader
        calls = [sum(scrape_replica(port)["calls"].values()) for port in ports]
        if calls[standby] != 0 or calls[leader] == 0:
            raise PhaseError(f"AWS calls per replica {calls}: the standby (replica {standby}) called AWS")
        webhook = _check_webhook(pkg, package, env, workdir, children)
        exits = {child.name: child.terminate() for child in children}
    finally:
        for child in children:
            child.kill()
        server.stop()
    tracebacks = [c.name for c in children if "Traceback" in c.stderr()]
    # the controllers return 0 from their signal handler; the webhook,
    # like the reference's, installs none and ends by SIGTERM itself
    want = {c.name: 0 for c in children if c.name != "webhook"} | {"webhook": -signal.SIGTERM}
    if exits != want or tracebacks:
        raise PhaseError(f"exit statuses {exits} (want {want}), tracebacks from {tracebacks}")
    return {
        "services": n,
        "ingresses": n_ing,
        "lease_s": lease_s,
        "events_s": events_s,
        "converged_s": converged_s,
        "objects_per_s": len(keys) / converged_s,
        "aws_calls": calls,
        "leader": leader,
        "webhook": webhook,
        "peak_rss_mib": {c.name: c.peak_rss_mib for c in children},
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
    fleet-merged exposition of ``texts``, with the GA controllers'
    converge percentiles."""
    families, _ = pkg.fleet.merge_expositions({f"replica-{i}": t for i, t in enumerate(texts)})
    empty = pkg.fleet.Family("")
    closed = {"spec": 0, "handoff": 0, "resize": 0}
    for sample, value in families.get("agac_journey_converge_seconds", empty).samples.items():
        for trigger in closed:
            if "_count{" in sample and f'trigger="{trigger}"' in sample:
                closed[trigger] += int(value)
    inflight = sum(families.get("agac_journey_inflight", empty).samples.values())
    ga = pkg.fleet.converge_percentiles(families)["ga"]
    ga_resize = trigger_percentiles(pkg, families, "resize")
    return {**closed, "inflight": int(inflight), "ga": ga, "ga_resize": ga_resize}


def trigger_percentiles(pkg, families: dict, trigger: str) -> dict:
    """The GA controllers' journey count and converge p50/p99 for one
    ``trigger``, read off the merged histogram as
    ``converge_percentiles`` reads the spec journeys."""
    family = families.get("agac_journey_converge_seconds")
    buckets: dict[float, float] = {}
    total = 0.0
    for sample, value in (family.samples.items() if family is not None else ()):
        if f'trigger="{trigger}"' not in sample or not any(
            f'controller="{c}"' in sample for c in pkg.slo.GA_CONTROLLERS
        ):
            continue
        if "_bucket{" in sample:
            le = sample.split('le="', 1)[1].split('"', 1)[0]
            if le != "+Inf":
                buckets[float(le)] = buckets.get(float(le), 0.0) + value
        elif "_count{" in sample:
            total += value
    ordered = sorted(buckets.items())
    return {
        "count": int(total),
        "p50_s": pkg.slo.estimate_quantile(ordered, total, 0.5),
        "p99_s": pkg.slo.estimate_quantile(ordered, total, 0.99),
    }


def flock_op_seconds(pkg, state_path: str, ops: int = 21) -> float:
    """One mutating call's time under the fake account's flock at the
    state file's current size, the median of ``ops``: two backends on
    the file take turns adding a hosted zone, so each reloads the
    other's write, applies and saves, as a replica's mutation does
    after another's."""
    writers = [pkg.fake_backend.FileBackedFakeAWSBackend(state_path) for _ in range(2)]
    times = []
    for i in range(ops):
        start = time.perf_counter()
        writers[i % 2].add_hosted_zone(f"flock-probe-{i}.example.com")
        times.append(time.perf_counter() - start)
    return sorted(times)[ops // 2]


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

    Beside the bounds it reports where a flattening curve loses its
    time: the host's cores in use over the run (the replicas' and this
    process's CPU seconds over the run's seconds), this process's alone
    (it serves the apiserver, one interpreter), and the share of the
    run the account's flock was held (mutating calls times
    ``flock_op_seconds`` at the final state size, an upper bound: the
    state grows over the run).

    Hard bounds (``PhaseError``): every shard lease held by one replica;
    ``chain_counts() == (n, n, n)``, never more; the fleet's aggregate
    call rate per service family and its summed AIMD ceilings within
    ``SHARD_BUDGET_QPS``; ``n`` spec journeys over the fleet-merged
    metrics (after a kill: the survivor closes a journey for every
    Service, and none is counted twice as spec); after a kill, the
    survivor owns every shard; every live replica exits 0 on SIGTERM.
    Returns the run's times, telemetry and the final AWS state."""
    env = shard_env(n, latency, workdir)
    if width == 1:
        placement = ["--disable-leader-election"]
    else:
        placement = ["--shards-per-replica", str(width if kill_at is not None else 1)]
    shards = set(range(width))
    server = pkg.testserver.TestApiServer().start()
    children: list[Child] = []
    try:
        kubeconfig = write_kubeconfig(workdir, server.url)
        ports = [_free_port() for _ in range(width)]
        spawned = time.monotonic()
        for replica, port in enumerate(ports):
            children.append(Child(
                f"controller-{replica}",
                shard_controller_argv(package, kubeconfig, port, width, placement),
                env, workdir,
            ))

        def owned_sets() -> list[set] | None:
            try:
                views = [_get_json(f"http://127.0.0.1:{p}/healthz")["sharding"] for p in ports]
            except OSError:
                return None
            if width == 1:
                return [shards]
            owned = [set(v.get("owned", ())) for v in views]
            return owned if set().union(*owned) == shards else None

        owned = _wait_for("every shard lease held", owned_sets, children, spawned)
        lease_s = time.monotonic() - spawned
        if sum(map(len, owned)) != width:
            raise PhaseError(f"{width} shards: replicas hold overlapping sets {owned}")

        client = pkg.rest.RestClusterClient(server.url)
        pids = {r: child.popen.pid for r, child in enumerate(children)}
        cpu = {r: -cpu_seconds(pid) for r, pid in pids.items()}
        own = os.times()
        start = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(lambda i: client.create("Service", make_shard_service(pkg, i)), range(n)))
        created_s = time.monotonic() - start
        aws = pkg.fake_backend.FileBackedFakeAWSBackend(env["AGAC_FAKE_STATE"])
        live = list(range(width))
        kill = None
        victim_metrics: list[str] = []
        victim_calls: dict[str, float] = {}
        victim_ops: dict[str, float] = {}
        while True:
            chains = aws.chain_counts()
            if max(chains) > n:
                raise PhaseError(f"{width} shards: chain counts {chains} exceed {n}: duplicates")
            if chains == (n, n, n) and (kill is None or "takeover_s" in kill):
                break
            now = time.monotonic()
            if now - start > PROCESS_DEADLINE:
                raise PhaseError(
                    f"{width} shards: chain counts {chains} of {n} after {now - start} s"
                )
            for replica in live:
                children[replica].check_alive()
            if kill_at is not None and kill is None and chains[2] >= kill_at * n:
                views = {r: scrape_replica(ports[r]) for r in live}
                (victim,) = [r for r, v in views.items() if 0 in v["sharding"]["owned"]]
                victim_metrics = [views[victim]["metrics"]]
                victim_calls, victim_ops = views[victim]["calls"], views[victim]["ops"]
                cpu[victim] += cpu_seconds(pids[victim])
                children[victim].popen.send_signal(signal.SIGKILL)
                children[victim].popen.wait(timeout=EXIT_DEADLINE)
                live.remove(victim)
                kill = {"victim": victim, "owned": sorted(views[victim]["sharding"]["owned"]),
                        "chains": list(chains), "at_s": time.monotonic() - start}
            elif kill is not None and "takeover_s" not in kill:
                (survivor,) = live
                view = _get_json(f"http://127.0.0.1:{ports[survivor]}/healthz")["sharding"]
                if set(view.get("owned", ())) == shards:
                    kill["takeover_s"] = time.monotonic() - start - kill["at_s"]
            time.sleep(0.1)
        elapsed = time.monotonic() - start
        for r in live:
            cpu[r] += cpu_seconds(pids[r])
        own_cpu = sum(os.times()[:2]) - sum(own[:2])

        def settled() -> list[dict] | None:
            # the live replicas close a journey per Service, none in flight
            scrapes = [scrape_replica(ports[r]) for r in live]
            journeys = journey_counts(pkg, [s["metrics"] for s in scrapes])
            if journeys["inflight"] or journeys["spec"] + journeys["handoff"] < n:
                return None
            return scrapes

        scrapes = _wait_for("every journey closed", settled, [children[r] for r in live], start)
        if aws.chain_counts() != (n, n, n):
            raise PhaseError(f"{width} shards: chain counts {aws.chain_counts()} after settling")
        # the victim's journeys as last scraped before the kill; its
        # journeys in flight then died with it, and the survivor's
        # takeover resync closes them as handoff journeys
        journeys = journey_counts(pkg, [s["metrics"] for s in scrapes] + victim_metrics)
        journeys["inflight"] = 0  # on the live replicas, as settled() waited for
        spec_ok = journeys["spec"] == n if kill is None else journeys["spec"] <= n
        if not spec_ok:
            raise PhaseError(f"{width} shards: {journeys['spec']} spec journeys for {n} Services")
        if kill is not None:
            kill["converged_after_s"] = elapsed - kill["at_s"]
            kill["survivor_owned"] = sorted(scrapes[0]["sharding"]["owned"])
            if set(kill["survivor_owned"]) != shards:
                raise PhaseError(f"after the kill the survivor owns {kill['survivor_owned']}")
        calls: dict[str, float] = dict(victim_calls)
        ops: dict[str, float] = dict(victim_ops)
        ceilings: dict[str, float] = {}
        for scrape in scrapes:
            for family, count in scrape["calls"].items():
                calls[family] = calls.get(family, 0.0) + count
            for op, count in scrape["ops"].items():
                ops[op] = ops.get(op, 0.0) + count
            for family, ceiling in scrape["ceilings"].items():
                ceilings[family] = ceilings.get(family, 0.0) + ceiling
        rates = {family: count / elapsed for family, count in sorted(calls.items())}
        over = {
            family: value
            for family, value in [*rates.items(), *ceilings.items()]
            if value > SHARD_BUDGET_QPS * 1.001
        }
        if over:
            raise PhaseError(
                f"{width} shards: call rates {rates} or summed AIMD ceilings {ceilings} "
                f"exceed the budget of {SHARD_BUDGET_QPS}/s per service"
            )
        exits = {children[r].name: children[r].terminate() for r in live}
    finally:
        for child in children:
            child.kill()
        server.stop()
    tracebacks = [children[r].name for r in live if "Traceback" in children[r].stderr()]
    if set(exits.values()) != {0} or tracebacks:
        raise PhaseError(f"{width} shards: exit statuses {exits}, tracebacks from {tracebacks}")
    aws_state = pkg.fake_backend.FileBackedFakeAWSBackend(env["AGAC_FAKE_STATE"]).snapshot_state()
    mutating = pkg.fake_backend._MUTATING_PREFIXES  # the calls that take the flock
    mutations = sum(count for op, count in ops.items() if op.startswith(mutating))
    flock_op_s = flock_op_seconds(pkg, env["AGAC_FAKE_STATE"])
    return {
        "width": width,
        "services": n,
        "latency_s": latency,
        "lease_s": lease_s,
        "create_s": created_s,
        "elapsed_s": elapsed,
        "objects_per_s": n / elapsed,
        "owned": [sorted(s) for s in owned],
        "aws_calls": {family: int(count) for family, count in sorted(calls.items())},
        "aggregate_calls_per_s": rates,
        "aimd_ceiling_sums": dict(sorted(ceilings.items())),
        "journeys": journeys,
        "kill": kill,
        "exits": exits,
        "peak_rss_mib": {c.name: c.peak_rss_mib for c in children},
        "host_cores_busy": (sum(cpu.values()) + own_cpu) / elapsed,
        "apiserver_cores_busy": own_cpu / elapsed,
        "mutations": int(mutations),
        "flock_op_ms": flock_op_s * 1e3,
        "flock_busy_share": mutations * flock_op_s / elapsed,
        "aws_state": aws_state,
    }


# ---------------------------------------------------------------------------
# the resize phase: the live elastic resize over a package's controller processes
# ---------------------------------------------------------------------------

def _watch_state(package: str, state_path: str, sent, stop, ready, out_path: str) -> None:
    """``DuplicateWatch``'s loop, in a process of its own: read the
    state every ``RESIZE_POLL`` s until ``stop``, then write the faults,
    the read count and the longest gap between reads to ``out_path``."""
    aws = importlib.import_module(f"{package}.cloudprovider.aws.fake_backend")
    account = aws.FileBackedFakeAWSBackend(state_path)
    faults: list[str] = []
    polls, max_gap, last = 0, 0.0, None
    while True:
        # the state first: every accelerator in it belongs to a Service
        # counted before this read of the count
        owners = [o for o in account.accelerator_owners().values() if o]
        chains = account.chain_counts()
        created = sent.value
        now = time.monotonic()
        if last is not None:
            max_gap = max(max_gap, now - last)
        last, polls = now, polls + 1
        repeated = sorted({o for o in owners if owners.count(o) > 1})
        if (repeated or max(chains) > created) and len(faults) < 20:
            faults.append(
                f"read {polls}: chains {chains} for {created} Services created, "
                f"owners repeated {repeated}"
            )
        ready.set()
        if stop.wait(RESIZE_POLL):
            break
    pathlib.Path(out_path).write_text(
        json.dumps({"faults": faults, "polls": polls, "max_gap_s": max_gap})
    )


class DuplicateWatch:
    """Reads the shared account's state file every ``RESIZE_POLL`` s for
    as long as the run lasts, in a process of its own (a thread would
    share this process's interpreter with the apiserver, which can
    stall it).  An accelerator owner tag that repeats, or more
    accelerators than Services whose create was sent, is a duplicate:
    ``check`` raises it, and a gap between reads over
    ``RESIZE_POLL_BOUND``."""

    def __init__(self, package: str, state_path: str, workdir: pathlib.Path):
        context = multiprocessing.get_context("spawn")
        self._sent = context.Value("i", 0)
        self._stop, self._ready = context.Event(), context.Event()
        self._out = workdir / "duplicate-watch.json"
        self._process = context.Process(
            target=_watch_state, name="duplicate-watch", daemon=True,
            args=(package, state_path, self._sent, self._stop, self._ready, str(self._out)),
        )
        self.faults: list[str] = []
        self.polls = 0
        self.max_gap_s = 0.0

    def sending(self) -> None:
        """Count one Service as created, before its create is sent."""
        with self._sent.get_lock():
            self._sent.value += 1

    def __enter__(self) -> "DuplicateWatch":
        self._process.start()
        if not self._ready.wait(PROCESS_DEADLINE):
            self._process.kill()
            raise PhaseError("the duplicate watch never read the state file")
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._process.join(JOIN_TIMEOUT)
        if self._process.is_alive():
            self._process.kill()
            self._process.join(JOIN_TIMEOUT)
        if self._out.exists():
            result = json.loads(self._out.read_text())
            self.faults, self.polls = result["faults"], result["polls"]
            self.max_gap_s = result["max_gap_s"]

    def check(self) -> None:
        if self._process.exitcode != 0 or not self.polls:
            raise PhaseError(f"the duplicate watch exited {self._process.exitcode}")
        if self.faults:
            raise PhaseError(f"duplicate accelerators: {self.faults}")
        if self.max_gap_s > RESIZE_POLL_BOUND:
            raise PhaseError(
                f"the duplicate watch went {self.max_gap_s} s between reads "
                f"(bound {RESIZE_POLL_BOUND} s)"
            )


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


HANDOFF_LINE = re.compile(
    r"^I\d{4} (\d\d):(\d\d):(\d\d)\.(\d{3}) \S+ resize epoch (\d+): shard (\d+) "
    r"(drained|adopting)\b"
)


def handoff_windows(stderr_texts: list[str], requested: dict[int, float]) -> dict:
    """Each replica's ``resize epoch E: shard S drained`` and ``...
    adopting`` log lines, in s after the epoch's request (``requested``:
    epoch -> local seconds of the day), keyed ``shard@replica``; and per
    epoch the window from the first drain to the last adoption."""
    out: dict[str, dict] = {}
    for replica, text in enumerate(stderr_texts):
        for line in text.splitlines():
            match = HANDOFF_LINE.match(line)
            if match is None:
                continue
            h, m, sec, ms, epoch, shard, what = match.groups()
            if int(epoch) not in requested:
                continue
            at = int(h) * 3600 + int(m) * 60 + int(sec) + int(ms) / 1e3
            entry = out.setdefault(epoch, {"drained": {}, "adopting": {}})
            entry[what][f"{shard}@{replica}"] = (at - requested[int(epoch)]) % 86400.0
    for entry in out.values():
        if entry["drained"] and entry["adopting"]:
            entry["window_s"] = max(entry["adopting"].values()) - min(entry["drained"].values())
    return out


def _local_seconds() -> float:
    """Seconds of the local day, the clock the children's log lines read."""
    now = time.time()
    local = time.localtime(now)
    return local.tm_hour * 3600 + local.tm_min * 60 + local.tm_sec + now % 1.0


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
    or more accelerators than Services created; ``(n, n, n)`` chains
    after (b) and after (c); over (a) and (b) the fleet's
    ``create_accelerator`` calls equal ``n``; summed AIMD ceilings (at
    every read of the replicas) and the aggregate call rate within
    ``SHARD_BUDGET_QPS`` per service; every Service's owner answering
    ``converged`` (no journey in flight) after (b) and after (c), and
    ``trigger=resize`` journeys closed after (b).  Returns the run's
    times and telemetry."""
    env = shard_env(n, latency, workdir)
    state_path = env["AGAC_FAKE_STATE"]
    first, resize_at = round(n * RESIZE_FIRST), round(n * RESIZE_AT)
    placement = ["--shards-per-replica", str(RESIZE_CAPACITY)]
    server = pkg.testserver.TestApiServer().start()
    children: list[Child] = []
    ceilings_seen: dict[str, float] = {}
    live = [0, 1]
    try:
        kubeconfig = write_kubeconfig(workdir, server.url)
        ports = [_free_port() for _ in live]
        spawned = time.monotonic()
        for replica, port in enumerate(ports):
            children.append(Child(
                f"controller-{replica}",
                shard_controller_argv(package, kubeconfig, port, RESIZE_FROM, placement),
                env, workdir,
            ))

        def views() -> list[dict] | None:
            """The live replicas' ``/healthz`` sharding blocks; the
            summed AIMD ceilings are held to the budget at every read."""
            try:
                blocks = [_get_json(f"http://127.0.0.1:{ports[r]}/healthz")["sharding"] for r in live]
                sums: dict[str, float] = {}
                for r in live:
                    ready = _get_json(f"http://127.0.0.1:{ports[r]}/readyz").get("services", {})
                    for service, snap in ready.items():
                        if "aimd_ceiling" in snap:
                            family = service.split("[", 1)[0]
                            sums[family] = sums.get(family, 0.0) + snap["aimd_ceiling"]
            except OSError:
                return None
            for family, total in sums.items():
                ceilings_seen[family] = max(ceilings_seen.get(family, 0.0), total)
            if any(total > SHARD_BUDGET_QPS * 1.001 for total in sums.values()):
                raise PhaseError(
                    f"resize: summed AIMD ceilings {sums} exceed {SHARD_BUDGET_QPS}/s "
                    f"(sharding {blocks})"
                )
            return blocks

        def stable(count: int, epoch: int) -> list[dict] | None:
            blocks = views()
            if blocks is None:
                return None
            want = ("stable", f"{count}x64", 0, epoch)
            for block in blocks:
                resize = block["resize"]
                if (resize["state"], resize["ring"], resize["handoff_pending"], resize["epoch"]) != want:
                    return None
            owned = [set(block["owned"]) for block in blocks]
            if set().union(*owned) != set(range(count)):
                return None
            if sum(map(len, owned)) != count:
                raise PhaseError(f"resize: replicas hold overlapping sets {owned}")
            return blocks

        def held() -> list[dict] | None:
            blocks = views()
            if blocks is None or set().union(*(b["owned"] for b in blocks)) != {0, 1}:
                return None
            return blocks

        start_views = _wait_for("shard leases {0, 1} held", held, children, spawned)
        lease_s = time.monotonic() - spawned
        client = pkg.rest.RestClusterClient(server.url)
        aws = pkg.fake_backend.FileBackedFakeAWSBackend(state_path)
        pids = {r: child.popen.pid for r, child in enumerate(children)}
        cpu = {r: -cpu_seconds(pid) for r, pid in pids.items()}
        own = os.times()

        def running() -> list[Child]:
            return [children[r] for r in live]

        def complete() -> bool:
            chains = aws.chain_counts()
            if max(chains) > n:
                raise PhaseError(f"resize: chain counts {chains} exceed {n}: duplicates")
            return chains == (n, n, n)

        keys = [f"default/{make_shard_service(pkg, i).metadata.name}" for i in range(n)]
        pending: set[str] = set()

        def settled():
            """Every Service's owner answers ``converged`` on
            ``/debug/explain``: it holds no journey in flight for the
            key (a donor may still hold the journey of a key it stopped
            serving at its drain; the owner's answer is the one that
            counts).  Returns the live replicas' scrapes and journeys."""
            for key in sorted(pending):
                verdicts = [
                    json.loads(_http(f"http://127.0.0.1:{ports[r]}/debug/explain?key={key}"))["verdict"]
                    for r in live
                ]
                if "converged" in verdicts:
                    pending.discard(key)
            if pending:
                return None
            scrapes = [scrape_replica(ports[r]) for r in live]
            return scrapes, journey_counts(pkg, [s["metrics"] for s in scrapes])

        with DuplicateWatch(package, state_path, workdir) as watch:
            def create(i: int) -> None:
                watch.sending()
                client.create("Service", make_shard_service(pkg, i))

            def create_all(indices) -> None:
                with concurrent.futures.ThreadPoolExecutor(max_workers=RESIZE_BATCH) as pool:
                    list(pool.map(create, indices))

            # (a) grow under load
            start = time.monotonic()
            creator = threading.Thread(target=create_all, args=(range(first),), name="creator")
            creator.start()

            def chains_at_least(count: int):
                chains = aws.chain_counts()
                return chains if chains[2] >= count else None

            chains_at_grow = _wait_for(
                f"{resize_at} complete chains", lambda: chains_at_least(resize_at), running(), start
            )
            creator.join()
            calls_before = sum(sum(scrape_replica(ports[r])["calls"].values()) for r in live)
            grow_local, grow_at = _local_seconds(), time.monotonic()
            grow_out = resize_cli(package, kubeconfig, RESIZE_TO, 1, env)
            create_all(range(first, n))
            after_creates = views() or []
            # (b) the new ring, stable everywhere, and every chain complete
            grown = _wait_for(
                f"ring {RESIZE_TO}x64 stable", lambda: stable(RESIZE_TO, 1), running(), grow_at
            )
            grow_s = time.monotonic() - grow_at
            _wait_for(f"{n} complete chains", complete, running(), grow_at)
            converged_s = time.monotonic() - start
            pending.update(keys)
            grow_scrapes, grow_journeys = _wait_for(
                "every Service converged on its owner after the grow", settled, running(), grow_at
            )
            grow_elapsed = time.monotonic() - start
            grow_calls: dict[str, float] = {}
            creates = 0.0
            for scrape in grow_scrapes:
                creates += scrape["ops"].get("create_accelerator", 0.0)
                for family, count in scrape["calls"].items():
                    grow_calls[family] = grow_calls.get(family, 0.0) + count
            if creates != n:
                raise PhaseError(f"resize: {creates} create_accelerator calls for {n} Services")
            if grow_journeys["resize"] == 0:
                trail = [
                    f"{c.name}: {line}" for c in children for line in c.stderr().splitlines()
                    if re.search(r"resize epoch|resync|shed|lease (acquired|lost|stolen)", line)
                ]
                raise PhaseError(
                    f"resize: no trigger=resize journey after the grow: {grow_journeys}; "
                    f"the replicas' placement log: {trail[-40:]}"
                )
            if aws.chain_counts() != (n, n, n):
                raise PhaseError(f"resize: chain counts {aws.chain_counts()} after the grow")
            grow_rates = {f: c / grow_elapsed for f, c in sorted(grow_calls.items())}

            # (c) shrink, and kill the holder of shard 0 mid-transition
            shrink_local, shrink_at = _local_seconds(), time.monotonic()
            resize_cli(package, kubeconfig, RESIZE_FROM, 2, env)

            def mid_transition() -> list[dict] | None:
                blocks = views()
                if blocks is None:
                    return None
                states = [b["resize"]["state"] for b in blocks]
                if any(s in RESIZE_STATES for s in states):
                    return blocks
                if all(b["resize"]["epoch"] == 2 for b in blocks):
                    raise PhaseError(f"resize: the shrink completed before the kill: {blocks}")
                return None

            while (seen := mid_transition()) is None:
                for child in running():
                    child.check_alive()
                if time.monotonic() - shrink_at > PROCESS_DEADLINE:
                    raise PhaseError("resize: no replica entered the shrink")
                time.sleep(0.02)
            (victim,) = [r for r, b in zip(live, seen) if 0 in b["owned"]]
            victim_scrape = scrape_replica(ports[victim])
            cpu[victim] += cpu_seconds(pids[victim])
            children[victim].popen.send_signal(signal.SIGKILL)
            children[victim].popen.wait(timeout=EXIT_DEADLINE)
            killed_at = time.monotonic()
            kill = {
                "victim": victim,
                "states": [b["resize"]["state"] for b in seen],
                "owned": sorted(seen[live.index(victim)]["owned"]),
                "at_s": killed_at - shrink_at,
            }
            live.remove(victim)
            (survivor,) = live

            def took_over() -> bool:
                blocks = views()
                if blocks is None:
                    return False
                identity, holders = blocks[0]["identity"], blocks[0]["holders"]
                return stable(RESIZE_FROM, 2) is not None or all(
                    holders.get(str(s)) == identity for s in kill["owned"]
                )

            _wait_for("the survivor's steal", took_over, running(), killed_at)
            kill["takeover_s"] = time.monotonic() - killed_at
            shrunk = _wait_for(
                f"the survivor stable at {RESIZE_FROM}x64", lambda: stable(RESIZE_FROM, 2),
                running(), killed_at,
            )
            kill["stable_after_kill_s"] = time.monotonic() - killed_at
            shrink_s = time.monotonic() - shrink_at
            if sorted(shrunk[0]["owned"]) != [0, 1]:
                raise PhaseError(f"resize: the survivor owns {shrunk[0]['owned']}")
            _wait_for(f"{n} complete chains after the kill", complete, running(), killed_at)
            pending.update(keys)
            survivor_scrapes, survivor_journeys = _wait_for(
                "every Service converged on the survivor", settled, running(), killed_at
            )
            elapsed = time.monotonic() - start
            time.sleep(2 * RESIZE_POLL)  # the watch reads the settled state once more
        watch.check()
        if aws.chain_counts() != (n, n, n):
            raise PhaseError(f"resize: chain counts {aws.chain_counts()} after the kill")
        calls = dict(victim_scrape["calls"])
        for family, count in survivor_scrapes[0]["calls"].items():
            calls[family] = calls.get(family, 0.0) + count
        rates = {f: c / elapsed for f, c in sorted(calls.items())}
        if any(v > SHARD_BUDGET_QPS * 1.001 for v in [*grow_rates.values(), *rates.values()]):
            raise PhaseError(f"resize: call rates {grow_rates}, {rates} exceed {SHARD_BUDGET_QPS}/s")
        cpu[survivor] += cpu_seconds(pids[survivor])
        own_cpu = sum(os.times()[:2]) - sum(own[:2])
        exit_status = children[survivor].terminate()
    finally:
        for child in children:
            child.kill()
        server.stop()
    tracebacks = [c.name for c in children if "Traceback" in c.stderr()]
    if exit_status != 0 or tracebacks:
        raise PhaseError(f"resize: the survivor exited {exit_status}, tracebacks from {tracebacks}")
    moved_grow = moved_keys(pkg, n, RESIZE_FROM, RESIZE_TO)
    return {
        "services": n,
        "latency_s": latency,
        "lease_s": lease_s,
        "start_owned": [sorted(b["owned"]) for b in start_views],
        "chains_at_grow": list(chains_at_grow),
        "grow_stdout": grow_out.strip().splitlines()[-1],
        "states_after_mid_creates": [b["resize"]["state"] for b in after_creates],
        "grow_s": grow_s,
        "grown_owned": [sorted(b["owned"]) for b in grown],
        "converged_s": converged_s,
        "create_accelerator": int(creates),
        "grow_journeys": grow_journeys,
        "grow_call_rates": grow_rates,
        "moved_keys_grow": {"ring": moved_grow, "resize_journeys": grow_journeys["resize"]},
        "grow_calls_per_moved_key": (sum(grow_calls.values()) - calls_before) / moved_grow,
        "kill": kill,
        "shrink_s": shrink_s,
        "moved_keys_shrink": {
            "ring": moved_keys(pkg, n, RESIZE_TO, RESIZE_FROM),
            "survivor_resize_journeys": survivor_journeys["resize"],
        },
        "survivor_journeys": survivor_journeys,
        "call_rates": rates,
        "aimd_ceiling_sums_max": dict(sorted(ceilings_seen.items())),
        "handoff_windows": handoff_windows(
            [c.stderr() for c in children], {1: grow_local, 2: shrink_local}
        ),
        "watch": {"polls": watch.polls, "max_gap_s": watch.max_gap_s},
        "elapsed_s": elapsed,
        "host_cores_busy": (sum(cpu.values()) + own_cpu) / elapsed,
        "apiserver_cores_busy": own_cpu / elapsed,
        "exit": exit_status,
        "peak_rss_mib": {c.name: c.peak_rss_mib for c in children},
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
    twice or more accelerators than Services sent; ``(n, n, n)`` chains
    at the end and ``n`` ``create_accelerator`` calls; at every read the
    summed AIMD ceilings, and the fleet's call rate since the previous
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
    state_path = env["AGAC_FAKE_STATE"]
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
    server = pkg.testserver.TestApiServer().start()
    children: list[Child] = []
    ceilings_seen: dict[str, float] = {}
    rates_seen: dict[str, float] = {}
    epochs: dict[int, float] = {}  # ring epoch -> this process's clock when first seen
    target_seen = {"max": 0.0}
    ring_name = pkg.sharding.ring_lease_name()
    ring_stop = threading.Event()

    def watch_ring() -> None:
        """Stamp each ring epoch as the apiserver stores it: the phase's
        reads of the replicas take a while, a watch on the Leases does not."""
        for event in server.cluster.watch("Lease", "0", ring_stop.is_set):
            lease = event.obj
            if lease.metadata.name == ring_name:
                anns = lease.metadata.annotations or {}
                epochs.setdefault(int(anns.get(pkg.sharding.membership.ANN_EPOCH, 0) or 0),
                                  time.monotonic())

    ring_watch = threading.Thread(target=watch_ring, name="ring-watch", daemon=True)
    ring_watch.start()
    try:
        kubeconfig = write_kubeconfig(workdir, server.url)
        ports = [_free_port() for _ in range(AUTOSCALE_REPLICAS)]
        spawned = time.monotonic()
        for replica, port in enumerate(ports):
            children.append(Child(
                f"controller-{replica}",
                shard_controller_argv(
                    package, kubeconfig, port, AUTOSCALE_FROM, placement, AUTOSCALE_QUEUE
                ),
                env, workdir,
            ))
        last_calls: list = []  # [time, {family: calls}] at the previous read

        def read() -> list[dict] | None:
            """One read of the ring lease and every replica; the
            every-read bounds are held here."""
            try:
                epoch = pkg.sharding.ring_status(server.cluster)["epoch"]
            except RuntimeError:
                return None  # no replica has created the ring lease yet
            now = time.monotonic()
            epochs.setdefault(epoch, now)
            if (observe_only and epoch != 0) or epoch > 2:
                raise PhaseError(f"autoscale {name}: ring epoch {epoch} (epochs seen {sorted(epochs)})")
            try:
                views = [scrape_replica(port) for port in ports]
            except OSError:
                return None
            ceilings: dict[str, float] = {}
            calls: dict[str, float] = {}
            for view in views:
                # over shard owners, as docs/operations.md ("Quota
                # division") states the fleet bound: a replica holding
                # no shard idles at the limiter's 0.5/s floor with no
                # key to call AWS for
                for family, ceiling in view["ceilings"].items():
                    if view["sharding"]["owned"]:
                        ceilings[family] = ceilings.get(family, 0.0) + ceiling
                for family, count in view["calls"].items():
                    calls[family] = calls.get(family, 0.0) + count
                targets = metric_samples(view["metrics"], "agac_autoscaler_target_shards")
                target_seen["max"] = max(target_seen["max"], *targets.values(), 0.0)
            for family, total in ceilings.items():
                ceilings_seen[family] = max(ceilings_seen.get(family, 0.0), total)
            if last_calls and now - last_calls[0] >= 1.0:
                for family, count in calls.items():
                    rate = (count - last_calls[1].get(family, 0.0)) / (now - last_calls[0])
                    rates_seen[family] = max(rates_seen.get(family, 0.0), rate)
                last_calls[:] = [now, calls]
            elif not last_calls:
                last_calls[:] = [now, calls]
            over = {f: v for f, v in [*ceilings.items(), *rates_seen.items()]
                    if v > SHARD_BUDGET_QPS * 1.001}
            if over:
                raise PhaseError(
                    f"autoscale {name}: AIMD ceiling sums {ceilings} or call rates {rates_seen} "
                    f"exceed {SHARD_BUDGET_QPS}/s per service"
                )
            return views

        def stable(views: list[dict], count: int, epoch: int) -> bool:
            want = ("stable", f"{count}x64", 0, epoch)
            for view in views:
                resize = view["sharding"]["resize"]
                if (resize["state"], resize["ring"], resize["handoff_pending"], resize["epoch"]) != want:
                    return False
            owned = [set(view["sharding"]["owned"]) for view in views]
            if set().union(*owned) != set(range(count)):
                return False
            if sum(map(len, owned)) != count:
                raise PhaseError(f"autoscale {name}: replicas hold overlapping sets {owned}")
            return True

        def held() -> bool:
            views = read()
            return views is not None and stable(views, AUTOSCALE_FROM, 0)

        _wait_for("shard leases {0, 1} held", held, children, spawned)
        lease_s = time.monotonic() - spawned
        client = pkg.rest.RestClusterClient(server.url)
        aws = pkg.fake_backend.FileBackedFakeAWSBackend(state_path)

        def chains() -> tuple:
            counts = aws.chain_counts()
            if max(counts) > n:
                raise PhaseError(f"autoscale {name}: chain counts {counts} exceed {n}: duplicates")
            return counts

        def decisions(port: int) -> list[dict]:
            return _get_json(f"http://127.0.0.1:{port}/debug/autoscaler")["decisions"]

        with DuplicateWatch(package, state_path, workdir) as watch:
            def create(i: int) -> None:
                watch.sending()
                client.create("Service", make_shard_service(pkg, i))

            def create_all(indices) -> None:
                with concurrent.futures.ThreadPoolExecutor(max_workers=RESIZE_BATCH) as pool:
                    list(pool.map(create, indices))

            base_at = time.monotonic()
            create_all(range(n_base))
            _wait_for(f"{n_base} baseline chains", lambda: chains() == (n_base,) * 3, children, base_at)
            base_s = time.monotonic() - base_at
            pids = {r: child.popen.pid for r, child in enumerate(children)}
            cpu = {r: -cpu_seconds(pid) for r, pid in pids.items()}
            own = os.times()

            # the wave, and the run with no operator action
            wave_at = time.monotonic()
            creator = threading.Thread(target=create_all, args=(range(n_base, n),), name="creator")
            creator.start()
            scale_out = None
            stable_at: dict[int, float] = {}
            drained_at = None
            calm_since = settle_s = None
            end_at = None
            while True:
                for child in children:
                    child.check_alive()
                now = time.monotonic()
                if now - wave_at > PROCESS_DEADLINE:
                    raise PhaseError(
                        f"autoscale {name}: no end within {PROCESS_DEADLINE} s of the wave "
                        f"(epochs {sorted(epochs)}, chains {chains()})"
                    )
                views = read()
                counts = chains()
                if views is None:
                    time.sleep(AUTOSCALE_READ)
                    continue
                epoch = max(epochs)
                if drained_at is None and counts == (n, n, n) and not creator.is_alive():
                    drained_at = now
                if not observe_only:
                    if 1 not in epochs and now - wave_at > AUTOSCALE_REACTION_BOUND:
                        raise PhaseError(
                            f"autoscale: no scale-out within {AUTOSCALE_REACTION_BOUND} s of the wave"
                        )
                    if 1 in epochs and scale_out is None:
                        for replica, port in enumerate(ports):
                            for d in decisions(port):
                                if (d["executed"] and d["action"] == "scale-out"
                                        and d["target_shards"] == AUTOSCALE_TO
                                        and d["current_shards"] == AUTOSCALE_FROM):
                                    scale_out = {"replica": replica, **d}
                                    break
                            if scale_out is not None:
                                break
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
                count = AUTOSCALE_TO if epoch == 1 else AUTOSCALE_FROM
                ring_stable = stable(views, count, epoch)
                if ring_stable and epoch not in stable_at:
                    stable_at[epoch] = now
                # the fault-1 bound: from the first read at which the last
                # chain is complete and the ring stable, every replica's
                # journeys in flight reach 0 within AUTOSCALE_SETTLE_S
                if settle_s is None and drained_at is not None and ring_stable:
                    calm_since = calm_since or now
                    journeys = [replica_journeys(v["metrics"]) for v in views]
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
                if end_at is not None and now >= end_at and settle_s is not None:
                    break
                time.sleep(AUTOSCALE_READ)
            elapsed = time.monotonic() - wave_at
            for r, pid in pids.items():
                cpu[r] += cpu_seconds(pid)
            own_cpu = sum(os.times()[:2]) - sum(own[:2])

            pending = {f"default/{make_shard_service(pkg, i).metadata.name}" for i in range(n)}

            def converged() -> bool:
                for key in sorted(pending):
                    for port in ports:
                        answer = json.loads(_http(f"http://127.0.0.1:{port}/debug/explain?key={key}"))
                        if answer["verdict"] == "converged":
                            pending.discard(key)
                            break
                return not pending

            _wait_for("every Service converged on its owner", converged, children, time.monotonic())

            def idle() -> list[dict] | None:
                # and every replica ends with no journey in flight (after
                # a scale-in the adopters' resync runs on past the tail)
                scrapes = [scrape_replica(port) for port in ports]
                journeys = [replica_journeys(s["metrics"]) for s in scrapes]
                return scrapes if all(j == (0, 0.0) for j in journeys) else None

            scrapes = _wait_for("no journey in flight on any replica", idle, children, time.monotonic())
            histories = [decisions(port) for port in ports]
            time.sleep(2 * RESIZE_POLL)  # the watch reads the settled state once more
        watch.check()
        final = aws.chain_counts()
        if final != (n, n, n):
            raise PhaseError(f"autoscale {name}: chain counts {final} at the end")
        creates = sum(s["ops"].get("create_accelerator", 0.0) for s in scrapes)
        if creates != n:
            raise PhaseError(f"autoscale {name}: {creates} create_accelerator calls for {n} Services")
        if observe_only:
            suppressed = [
                (r, d) for r, history in enumerate(histories) for d in history
                if d["action"] == "scale-out" and "observe-only" in d["rails"]
            ]
            if not suppressed or target_seen["max"] != AUTOSCALE_TO:
                raise PhaseError(
                    f"autoscale observe-only: {len(suppressed)} scale-outs held by observe-only, "
                    f"target-shards gauge at most {target_seen['max']}"
                )
        exits = {child.name: child.terminate() for child in children}
    finally:
        ring_stop.set()
        for child in children:
            child.kill()
        server.stop()
        ring_watch.join(JOIN_TIMEOUT)
    tracebacks = [c.name for c in children if "Traceback" in c.stderr()]
    if set(exits.values()) != {0} or tracebacks:
        raise PhaseError(f"autoscale {name}: exit statuses {exits}, tracebacks from {tracebacks}")
    per_replica = []
    for scrape, history in zip(scrapes, histories):
        tally: dict[str, int] = {}
        rails: dict[str, int] = {}
        for d in history:
            tally[f"{d['action']}/{d['reason']}"] = tally.get(f"{d['action']}/{d['reason']}", 0) + 1
            for rail in d["rails"]:
                rails[rail] = rails.get(rail, 0) + 1
        per_replica.append({
            "owned": scrape["sharding"]["owned"],
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
    mutating = pkg.fake_backend._MUTATING_PREFIXES
    ops = {}
    for scrape in scrapes:
        for op, count in scrape["ops"].items():
            ops[op] = ops.get(op, 0.0) + count
    mutations = sum(count for op, count in ops.items() if op.startswith(mutating))
    flock_op_s = flock_op_seconds(pkg, state_path)
    evidence = scale_out["evidence"] if scale_out is not None else {}
    return {
        "run": name,
        "services": {"base": n_base, "wave": n_wave},
        "latency_s": latency,
        "lease_s": lease_s,
        "base_s": base_s,
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
        "journeys": journey_counts(pkg, [s["metrics"] for s in scrapes]),
        "replicas": per_replica,
        "target_shards_max": target_seen["max"],
        "aimd_ceiling_sums_max": dict(sorted(ceilings_seen.items())),
        "call_rates_max": dict(sorted(rates_seen.items())),
        "mutations": int(mutations),
        "flock_busy_share": mutations * flock_op_s / elapsed,
        "watch": {"polls": watch.polls, "max_gap_s": watch.max_gap_s},
        "elapsed_s": elapsed,
        "replica_cores_busy": sum(cpu.values()) / elapsed,
        "this_process_cores_busy": own_cpu / elapsed,
        "exits": exits,
    }


def autoscale_runs(
    pkg, package: str, n_base: int, n_wave: int, latency: float, workdir: pathlib.Path
) -> dict:
    """``autoscale_fleet``'s acting run and its observe-only twin side by
    side, the twin ``AUTOSCALE_TWIN_DELAY`` s behind, each on its own
    apiserver, account and ports (any failure of either is raised).  Beside the runs, the cores that this process and
    its children keep busy, read every ``AUTOSCALE_BUSY_READ`` s: the two
    runs share the host, and more than half its cores busy would make
    them measure each other."""
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
    return {
        **runs,
        "busy_cores_max": max(busy, default=0.0),
        "busy_cores_mean": sum(busy) / len(busy) if busy else 0.0,
        "busy_cores": busy,
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
    fleet, elapsed = converge(pkg, n)
    (accels, listeners, groups), records, bound = fleet.progress()
    result = {
        "services": n,
        "ingresses": fleet.n_ing,
        "bindings": fleet.n_egb,
        "elapsed_s": elapsed,
        "objects_per_s": fleet.n_objects / elapsed,
        "chains": [accels, listeners, groups],
        "records": records,
        "bound": bound,
        "aws_calls": len(fleet.aws.calls),
    }
    print(
        f"converge: {n} Services + {fleet.n_ing} Ingresses + {fleet.n_egb} bindings "
        f"in {elapsed} s = {result['objects_per_s']} objects/s "
        f"({WORKERS} workers per controller, unshaped fake AWS; host-bound, the card "
        f"is idle in this phase) on {card}",
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
        f"{result['ingresses']} Ingresses over HTTP: lease held after {result['lease_s']} s, "
        f"every Event after {result['events_s']} s, every object converged after "
        f"{result['converged_s']} s from spawn = {result['objects_per_s']} objects/s; "
        f"AWS calls leader/standby {result['aws_calls'][result['leader']]}/"
        f"{result['aws_calls'][1 - result['leader']]}; peak RSS MiB (sampled every 0.25 s) "
        f"{result['peak_rss_mib']} "
        f"(host-bound, the card is idle in this phase) on {card}",
        flush=True,
    )
    summary = {k: v for k, v in result.items() if k not in ("events", "verdicts")}
    print("process " + json.dumps(summary), flush=True)
    return result


def phase_shard(n: int, card: str) -> dict:
    """``bench.py``'s scaling curve at ``SHARD_WIDTHS`` and a width-2
    kill run, through the port's command line; ``shard_fleet`` holds
    each run to its hard bounds."""
    pkg = load(PORT)
    lease = "/".join(
        SHARD_ENV[f"AGAC_LEASE_{k}"] for k in ("DURATION", "RENEW_DEADLINE", "RETRY_PERIOD")
    )
    start = time.monotonic()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-shard-") as workdir:
        for width, kill_at in [*((w, None) for w in SHARD_WIDTHS), (2, SHARD_KILL_AT)]:
            label = f"{width}-kill" if kill_at is not None else str(width)
            rundir = pathlib.Path(workdir) / label
            rundir.mkdir()
            run = shard_fleet(pkg, PORT, n, width, SHARD_LATENCY, rundir, kill_at=kill_at)
            del run["aws_state"]
            runs[label] = run
            kill = run["kill"]
            print(
                f"shard {label}: {width} x python -m {PORT} controller ({SHARD_WORKERS} workers, "
                f"{SHARD_LATENCY} s fake AWS latency, the bench's lease timing {lease} s) "
                f"converged {n} Services "
                f"in {run['elapsed_s']} s = {run['objects_per_s']} objects/s after every shard "
                f"lease was held ({run['lease_s']} s from spawn); owned {run['owned']}; "
                f"call rates {run['aggregate_calls_per_s']} /s and AIMD ceiling sums "
                f"{run['aimd_ceiling_sums']} /s per service (budget {SHARD_BUDGET_QPS}); "
                f"journeys {run['journeys']}; {run['host_cores_busy']} of {os.cpu_count()} host "
                f"cores busy ({run['apiserver_cores_busy']} in this process, the apiserver's); "
                f"the account's flock held at most {run['flock_busy_share']} of the run "
                f"({run['mutations']} mutating calls x {run['flock_op_ms']} ms)"
                + ("" if kill is None else (
                    f"; SIGKILL to replica {kill['victim']} (shards {kill['owned']}) at chains "
                    f"{kill['chains']}, {kill['at_s']} s in; the survivor owned "
                    f"{kill['survivor_owned']} {kill['takeover_s']} s later and the fleet "
                    f"converged {kill['converged_after_s']} s after the kill"
                ))
                + f" (host-bound, the card is idle in this phase) on {card}",
                flush=True,
            )
    single = runs["1"]["objects_per_s"]
    curve = {}
    for width in SHARD_WIDTHS:
        run = runs[str(width)]
        curve[str(width)] = {
            "objects_per_s": run["objects_per_s"],
            "speedup": run["objects_per_s"] / single,
            "efficiency": run["objects_per_s"] / (width * single),
            "ga_converge_p99_s": run["journeys"]["ga"]["p99_s"],
            "host_cores_busy": run["host_cores_busy"],
            "apiserver_cores_busy": run["apiserver_cores_busy"],
            "flock_busy_share": run["flock_busy_share"],
        }
    gates = {
        f"2-shard speedup >= {SHARD_MIN_SPEEDUP_2}": curve["2"]["speedup"] >= SHARD_MIN_SPEEDUP_2,
        f"4-shard efficiency >= {SHARD_MIN_EFFICIENCY_4}":
            curve["4"]["efficiency"] >= SHARD_MIN_EFFICIENCY_4,
    }
    result = {"runs": runs, "curve": curve, "gates": gates, "wall_s": time.monotonic() - start}
    print(
        f"shard: curve {curve}; bench.py's gates (not enforced here, they measure the host's "
        f"cores): " + ", ".join(f"{k} {'met' if v else 'not met'}" for k, v in gates.items())
        + f"; phase {result['wall_s']} s on the host of {card}",
        flush=True,
    )
    print("shard " + json.dumps(result), flush=True)
    return result


def phase_resize(n: int, card: str) -> dict:
    """The runbook's live resize through the port's command line;
    ``resize_fleet`` holds it to its hard bounds."""
    pkg = load(PORT)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-resize-") as workdir:
        start = time.monotonic()
        run = resize_fleet(pkg, PORT, n, SHARD_LATENCY, pathlib.Path(workdir))
    run["wall_s"] = time.monotonic() - start
    kill, grow = run["kill"], run["grow_journeys"]
    print(
        f"resize: 2 x python -m {PORT} controller --shard-count {RESIZE_FROM} "
        f"--shards-per-replica {RESIZE_CAPACITY} ({SHARD_WORKERS} workers, {SHARD_LATENCY} s fake "
        f"AWS latency), {n} Services; grow {RESIZE_FROM} -> {RESIZE_TO} requested at chains "
        f"{run['chains_at_grow']} ({run['grow_stdout']!r}), every replica stable at "
        f"{RESIZE_TO}x64 {run['grow_s']} s later (owned {run['grown_owned']}), {n} chains "
        f"{run['converged_s']} s after the first create; create_accelerator calls "
        f"{run['create_accelerator']} for {n} Services; moved keys {run['moved_keys_grow']} "
        f"(ring vs trigger=resize journeys), GA resize journeys p50/p99 "
        f"{grow['ga_resize']['p50_s']}/{grow['ga_resize']['p99_s']} s, spec p50/p99 "
        f"{grow['ga']['p50_s']}/{grow['ga']['p99_s']} s, {run['grow_calls_per_moved_key']} AWS "
        f"calls per moved key between the request and every chain closed (the last quarter's "
        f"creates included); shrink {RESIZE_TO} -> {RESIZE_FROM}: SIGKILL to replica "
        f"{kill['victim']} (shards {kill['owned']}, states {kill['states']}) {kill['at_s']} s "
        f"after the request, the survivor held its leases {kill['takeover_s']} s later and was "
        f"stable at {RESIZE_FROM}x64 {kill['stable_after_kill_s']} s after the kill "
        f"({run['shrink_s']} s after the request; moved keys {run['moved_keys_shrink']}); "
        f"handoff windows {run['handoff_windows']}; call rates {run['call_rates']} /s, AIMD "
        f"ceiling sums at most {run['aimd_ceiling_sums_max']} /s (budget {SHARD_BUDGET_QPS}); "
        f"duplicate watch {run['watch']['polls']} reads, at most {run['watch']['max_gap_s']} s "
        f"apart, no duplicate; {run['host_cores_busy']} of {os.cpu_count()} host cores busy "
        f"({run['apiserver_cores_busy']} in this process, the apiserver's); phase "
        f"{run['wall_s']} s (host-bound, the card is idle in this phase) on {card}",
        flush=True,
    )
    print("resize " + json.dumps(run), flush=True)
    return run


def phase_autoscale(card: str) -> dict:
    """The autoscaler canary through the port's command line, the acting
    run and its observe-only twin side by side; ``autoscale_fleet``
    holds each to its hard bounds."""
    pkg = load(PORT)
    start = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-autoscale-") as workdir:
        runs = autoscale_runs(
            pkg, PORT, AUTOSCALE_BASE, AUTOSCALE_WAVE, SHARD_LATENCY, pathlib.Path(workdir)
        )
    runs["wall_s"] = time.monotonic() - start
    acting, twin = runs["acting"], runs["observe-only"]
    out, scale_in = acting["scale_out"], acting["scale_in"]
    print(
        f"autoscale: {AUTOSCALE_REPLICAS} x python -m {PORT} controller --autoscale "
        f"--shard-count {AUTOSCALE_FROM} --shards-per-replica 1 (queue {AUTOSCALE_QUEUE[0]} qps / "
        f"burst {AUTOSCALE_QUEUE[1]}, {SHARD_WORKERS} workers, {SHARD_LATENCY} s fake AWS "
        f"latency, interval {AUTOSCALE_INTERVAL:g} s, cooldowns {AUTOSCALE_COOLDOWN_OUT:g}/"
        f"{AUTOSCALE_COOLDOWN_IN:g} s), {AUTOSCALE_BASE} Services then a wave of "
        f"{AUTOSCALE_WAVE}, an acting run and an observe-only twin side by side (the twin "
        f"{AUTOSCALE_TWIN_DELAY:g} s behind); acting: ring epochs "
        f"at {acting['epochs_s']} s after the wave's first create, scale-out by replica "
        f"{out['replica']} for {out['reason']} {out['reaction_s']} s after the wave (burn "
        f"{out['burn']}, oldest unconverged age {out['oldest_unconverged_age_s']} s), every "
        f"replica stable at {AUTOSCALE_TO}x64 {out['transition_stable_s']} s after the request; "
        f"scale-in {scale_in if scale_in is not None else 'none'}; wave drained "
        f"{acting['drain_s']} s after its first create (observe-only twin: {twin['drain_s']} s, "
        f"max target-shards gauge {twin['target_shards_max']}); journeys in flight 0 on every "
        f"replica {acting['settle_s']} / {twin['settle_s']} s after the last chain with the ring "
        f"stable; GA spec p50/p99 {acting['journeys']['ga']['p50_s']}/"
        f"{acting['journeys']['ga']['p99_s']} s acting, {twin['journeys']['ga']['p50_s']}/"
        f"{twin['journeys']['ga']['p99_s']} s twin; decisions per replica acting "
        f"{[r['decisions'] for r in acting['replicas']]}, suppressed "
        f"{[r['suppressed'] for r in acting['replicas']]}; twin {[r['decisions'] for r in twin['replicas']]}, "
        f"suppressed {[r['suppressed'] for r in twin['replicas']]}; create_accelerator "
        f"{acting['create_accelerator']}/{twin['create_accelerator']}; AIMD ceiling sums at most "
        f"{acting['aimd_ceiling_sums_max']} /s, call rates at most {acting['call_rates_max']} /s "
        f"(budget {SHARD_BUDGET_QPS}); cores busy in this process and its children at most "
        f"{runs['busy_cores_max']} (mean {runs['busy_cores_mean']}) of {os.cpu_count()}, the "
        f"replicas {acting['replica_cores_busy']} / {twin['replica_cores_busy']}, this process "
        f"(both apiservers) {acting['this_process_cores_busy']}, flock share "
        f"{acting['flock_busy_share']}; phase {runs['wall_s']} s (host-bound, the card is idle "
        f"in this phase) on {card}",
        flush=True,
    )
    print("autoscale " + json.dumps(runs), flush=True)
    return runs


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
    """The pinned scenarios: each clean, each with its pinned hash."""
    out = []
    for (scenario, seed, profile), pinned in FUZZ_PINS.items():
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
    pinned = ROLLOUT_PINS.get(n)
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
    pinned = SHARD_SOAK_PINS.get(n)
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
        f"the card is idle in this phase) on {card}",
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
        "objects_per_s": fleet.n_objects / elapsed,
        "observed_edges": len(edges),
        "unmapped_edges": len(unmapped),
        "stage_accesses": len(accesses),
        "unmapped_accesses": len(unmapped_accesses),
        "lock_violations": len(lock_violations),
        "footprint_violations": len(footprint_violations),
    }
    print(
        f"analysis crosscheck: {n} Services + {fleet.n_ing} Ingresses + {fleet.n_egb} "
        f"bindings converged through {faults} injected faults in {elapsed} s = "
        f"{result['objects_per_s']} objects/s under the racecheck watchdog; "
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
        phase_sim(args.sim_services, card)
        phase_analysis(args.services, card)
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
