"""CLI entry: ``controller``, ``webhook``, ``version``, ``manifests``.

Capability parity with the reference's cobra CLI (``cmd/``, 199 LoC +
``main.go``): subcommand structure, klog-style ``-v`` verbosity on the
root, kubeconfig resolution order flag → ``$KUBECONFIG`` →
``~/.kube/config`` → in-cluster (``cmd/controller/controller.go:84-98``),
``POD_NAMESPACE`` for the leader-election lease namespace
(``controller.go:55-58``), and version stamping.  ``manifests`` is the
``make manifests`` analog (the reference generates its config/ tree
with controller-gen).
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import VERSION, klog

REVISION = os.environ.get("AGAC_BUILD_REVISION", "dev")
BUILD = os.environ.get("AGAC_BUILD_DATE", "unknown")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="aws-global-accelerator-controller",
        description="Manage AWS Global Accelerator and Route53 from Kubernetes",
    )
    parser.add_argument(
        "-v", "--verbosity", type=int, default=0, help="klog-style log verbosity"
    )
    sub = parser.add_subparsers(dest="command")

    controller = sub.add_parser("controller", help="Start controller")
    controller.add_argument(
        # 8, not the reference's 1: measured at N=1000 under realistic
        # AWS latency/quota shaping, 1 -> 8 workers buys ~10x
        # convergence throughput and further workers only inflate p99
        # (docs/operations.md "Sizing the worker pool")
        "-w", "--workers", type=int, default=8,
        help="Concurrent workers number for controller (reference default: 1).",
    )
    controller.add_argument(
        "-c", "--cluster-name", default="default",
        help="Owner cluster name which is used in resource tags.",
    )
    controller.add_argument(
        "--kubeconfig", default="",
        help="Path to a kubeconfig. Only required if out-of-cluster.",
    )
    controller.add_argument(
        "--master", default="",
        help="The address of the Kubernetes API server. Overrides any value in kubeconfig.",
    )
    controller.add_argument(
        "--disable-leader-election", action="store_true",
        help="Run without acquiring the leader lease (single-replica setups).",
    )
    controller.add_argument(
        "--shard-count", type=int, default=1,
        help="Horizontal sharding: partition the reconcile "
        "keyspace over N shard leases (consistent hashing on "
        "namespace/name) and run every replica concurrently — each "
        "reconciles only the keys its held shards own, with the AWS "
        "quota divided per shard. Replaces classic single-leader "
        "election. 1 (default) disables: one active leader owns "
        "everything. This is the BOOT count; the live count follows "
        "the ring lease — change it at runtime with the "
        "`resize-shards` subcommand (drain/handoff-mediated, no "
        "restart).",
    )
    controller.add_argument(
        "--shards-per-replica", type=int, default=0,
        help="Most shard leases one replica may hold (0 = no cap). "
        "Failover coverage requires (replicas-1) x shards-per-replica "
        ">= shard-count; see docs/operations.md 'Horizontal sharding' "
        "for the sizing math.",
    )
    controller.add_argument(
        "--queue-qps", type=float, default=10.0,
        help="Overall enqueue rate limit per workqueue (token bucket qps).",
    )
    controller.add_argument(
        "--queue-burst", type=int, default=100,
        help="Enqueue burst size per workqueue (token bucket capacity).",
    )
    controller.add_argument(
        "--drift-resync-period", type=float, default=0.0,
        help="Re-enqueue every managed object each N seconds so AWS-side "
        "drift (out-of-band disable/delete/record edits) is repaired "
        "without a Kubernetes object change. 0 (default) matches the "
        "reference: drift waits for an object edit.",
    )
    controller.add_argument(
        "--queue-max-backoff", type=float, default=1000.0,
        help="Cap on the per-item exponential retry backoff in seconds "
        "(client-go's default 1000 is far past useful for external-API "
        "retries; lower it to bound worst-case repair latency).",
    )
    controller.add_argument(
        "--reconcile-deadline", type=float, default=300.0,
        help="Per-item reconcile deadline in seconds: settle polls and "
        "backend retry backoffs check it and requeue with a retryable "
        "deadline error instead of wedging a worker. 0 disables "
        "(reference parity: a poll can hold a worker its full timeout).",
    )
    controller.add_argument(
        "--health-port", type=int, default=8081,
        help="Port for the manager /healthz+/readyz endpoint (circuit "
        "state + worker liveness, for deployment probes). 0 disables.",
    )
    controller.add_argument(
        "--api-health-window", type=float, default=None,
        help="Rolling classification window (seconds) of the per-service "
        "API health tracker; 0 disables the whole health plane "
        "(circuit breakers + AIMD pacing). Default 30 "
        "(env AGAC_API_HEALTH_WINDOW).",
    )
    controller.add_argument(
        "--api-health-failure-ratio", type=float, default=None,
        help="Failure ratio over the window that opens a service "
        "circuit. Default 0.5 (env AGAC_API_HEALTH_FAILURE_RATIO).",
    )
    controller.add_argument(
        "--api-health-min-calls", type=int, default=None,
        help="Minimum calls in the window before the ratio is "
        "evaluated. Default 10 (env AGAC_API_HEALTH_MIN_CALLS).",
    )
    controller.add_argument(
        "--api-health-open-duration", type=float, default=None,
        help="Seconds an open circuit rejects calls before admitting "
        "probe calls. Default 15 (env AGAC_API_HEALTH_OPEN_DURATION).",
    )
    controller.add_argument(
        "--api-health-probe-budget", type=int, default=None,
        help="Probe calls allowed per open-duration interval while "
        "half-open. Default 1 (env AGAC_API_HEALTH_PROBE_BUDGET).",
    )
    controller.add_argument(
        "--api-health-aimd-qps", type=float, default=None,
        help="Ceiling of the per-service AIMD adaptive call rate; "
        "throttle responses cut the live rate multiplicatively, "
        "successes restore it additively. 0 disables pacing (circuit "
        "breaking only). Default 20 (env AGAC_API_HEALTH_AIMD_QPS).",
    )
    controller.add_argument(
        "--gc-interval", type=float, default=0.0,
        help="Seconds between orphan-GC sweeps: cross-check every "
        "cluster-tagged accelerator and owner-TXT'd Route53 record "
        "against the apiserver and tear down confirmed orphans (a "
        "Service deleted during a controller outage is otherwise a "
        "permanent leak). 0 (default) disables — reference parity.",
    )
    controller.add_argument(
        "--gc-grace-sweeps", type=int, default=2,
        help="Consecutive sweeps an orphan must be observed before "
        "deletion; disappearing from one sweep resets the counter.",
    )
    controller.add_argument(
        "--gc-max-deletes", type=int, default=10,
        help="Per-sweep deletion budget (accelerators + record owners "
        "combined) — bounds blast radius of a mass-orphan event.",
    )
    controller.add_argument(
        "--gc-dry-run", action="store_true",
        help="GC observes and logs would-be deletions without touching "
        "AWS — the recommended first rollout step (watch the gc "
        "counters on /healthz).",
    )
    controller.add_argument(
        "--metrics-port", type=int, default=0,
        help="Serve the Prometheus /metrics exposition on a dedicated "
        "port in addition to the health server (which always carries "
        "/metrics). 0 (default) disables the dedicated listener.",
    )
    controller.add_argument(
        "--trace-sample", type=float, default=0.0,
        help="Fraction of reconciles to trace (0..1): a sampled item "
        "emits one structured JSON log line with queue-wait, sync, "
        "per-AWS-call and settle-poll spans plus the requeue decision. "
        "0 (default) disables tracing.",
    )
    controller.add_argument(
        "--profile-hz", type=float, default=0.0,
        help="Continuous sampling-profiler rate (samples/second): a "
        "daemon thread walks every thread's stack at this rate and "
        "folds the samples; the top table goes to the log on SIGTERM "
        "and /debug/profile?seconds=N serves on-demand captures. "
        "0 (default) disables the continuous sampler (on-demand "
        "captures still work).",
    )
    controller.add_argument(
        "--profile-stages", dest="profile_stages", action="store_true",
        default=True,
        help="Per-stage CPU/wall attribution for the reconcile hot "
        "path (queue-pop, shard-filter, informer-lookup, serialize, "
        "driver-mutate, settle-park, self-tax, ...), exported as "
        "agac_profile_stage_* histograms. On by default.",
    )
    controller.add_argument(
        "--no-profile-stages", dest="profile_stages",
        action="store_false",
        help="Disable the stage accountant (drops the "
        "agac_profile_stage_* attribution).",
    )
    controller.add_argument(
        "--slo-eval-interval", type=float, default=15.0,
        help="Seconds between convergence-SLO engine evaluations "
        "(journey-latency burn rates over the 5m/1h windows; sustained "
        "burn sheds GC sweeps and drift pacing before user-facing "
        "convergence degrades further). The objectives and shed "
        "doctrine are documented in docs/operations.md 'Convergence "
        "SLOs'; /slo serves the live view. 0 disables the engine.",
    )
    controller.add_argument(
        "--autoscale", action="store_true",
        help="SLO-driven shard autoscaler: close the loop "
        "from burn rate to live resize. Scales out on sustained "
        "both-window budget burn or growing oldest-unconverged-age, "
        "scales in only on sustained headroom, always through the "
        "drain/handoff resize path — railed by min/max shards, one "
        "doubling per step, per-direction cooldowns, and never while "
        "a transition is in flight. Requires --shard-count > 1 and "
        "the SLO engine (--slo-eval-interval > 0). Every decision is "
        "flight-recorded; /debug/autoscaler serves the history.",
    )
    controller.add_argument(
        "--autoscale-min-shards", type=int, default=2,
        help="Floor the autoscaler may never scale below.",
    )
    controller.add_argument(
        "--autoscale-max-shards", type=int, default=8,
        help="Ceiling the autoscaler may never scale above.",
    )
    controller.add_argument(
        "--autoscale-cooldown-out", type=float, default=120.0,
        help="Seconds after any executed resize before the next "
        "scale-OUT may fire (sized to outlast placement hysteresis "
        "and the transition itself).",
    )
    controller.add_argument(
        "--autoscale-cooldown-in", type=float, default=600.0,
        help="Seconds after any executed resize before the next "
        "scale-IN may fire (longer than scale-out: shrinking is the "
        "cheaper mistake to delay).",
    )
    controller.add_argument(
        "--autoscale-interval", type=float, default=30.0,
        help="Seconds between autoscaler evaluations.",
    )
    controller.add_argument(
        "--autoscale-observe-only", action="store_true",
        help="Evaluate and flight-record scale recommendations "
        "WITHOUT acting — the recommended first rollout step (watch "
        "/debug/autoscaler before arming).",
    )
    controller.add_argument(
        "--fleet-peers", default="",
        help="Comma-separated host:port list of the OTHER shard "
        "replicas' health endpoints. /metrics/fleet on this replica "
        "then serves the fleet-merged view (counters and journey "
        "histograms summed across replicas, gauges labeled by shard) "
        "— the one scrape that answers fleet-wide convergence SLOs "
        "under --shard-count > 1. Empty (default): the fleet view "
        "carries only this replica.",
    )
    controller.add_argument(
        "--read-plane-ttl", type=float, default=None,
        help="Tick scope (seconds) of the coalesced verification read "
        "plane: accelerator-topology, record-set and load-balancer "
        "reads are shared within one window of this length and re-read "
        "after it. Default 15; 0 disables coalescing (reference-parity "
        "per-object reads). Fine-grained knobs: AGAC_TOPOLOGY_VERIFY_TTL, "
        "AGAC_TOPOLOGY_FULL_TTL, AGAC_RECORDSET_CACHE_TTL, "
        "AGAC_LB_CACHE_TTL, AGAC_LB_BATCH_WINDOW.",
    )

    controller.add_argument(
        "--settle-poll-interval", type=float, default=None,
        help="Tick period (seconds) of the pending-settle scheduler: "
        "reconcile items parked on AWS wait states (accelerator "
        "disable→DEPLOYED settles, Route53 change-batch commits, the "
        "Route53 wait for the accelerator to exist) are re-checked in "
        "coalesced reads and requeued when resolved, instead of each "
        "holding a worker in a poll loop. Default 1 "
        "(env AGAC_SETTLE_POLL_INTERVAL); 0 disables — reference-parity "
        "blocking settle.",
    )
    controller.add_argument(
        "--r53-batch-max", type=int, default=None,
        help="Maximum changes per batched ChangeResourceRecordSets call "
        "(the API accepts up to 1,000). Default 100 "
        "(env AGAC_R53_BATCH_MAX).",
    )
    controller.add_argument(
        "--r53-batch-linger", type=float, default=None,
        help="Seconds the Route53 change batcher gathers co-submitted "
        "record mutations for the same hosted zone into one multi-change "
        "wire call. Default 0 = batching disabled (one call per "
        "mutation, reference parity); 0.1-2 s recommended at fleet "
        "scale (env AGAC_R53_BATCH_LINGER). See docs/operations.md "
        "'Async mutation pipeline'.",
    )

    controller.add_argument(
        "--capture-path", default="",
        help="Arm the incident capture: record every "
        "external input — informer deliveries, AWS call outcomes, "
        "lease observations, signals — to this bounded JSONL ring for "
        "deterministic replay (agac explain --capture / "
        "sim.replay.ReplayHarness). '%%p' expands to the PID. Default "
        "off (env AGAC_CAPTURE_PATH).",
    )
    controller.add_argument(
        "--capture-max-bytes", type=int, default=0,
        help="Incident-capture ring size: the active segment rotates "
        "to <path>.1 past this many bytes (at most two segments kept). "
        "Default 16MiB (env AGAC_CAPTURE_MAX_BYTES).",
    )

    webhook = sub.add_parser("webhook", help="Start webhook server")
    webhook.add_argument(
        "--tls-cert-file", default="",
        help="File containing the x509 Certificate for HTTPS.",
    )
    webhook.add_argument(
        "--tls-private-key-file", default="",
        help="File containing the x509 private key to --tls-cert-file.",
    )
    webhook.add_argument("--port", type=int, default=8443, help="Webhook server port.")
    webhook.add_argument(
        "--ssl", default="true", choices=["true", "false"],
        help="Webhook server use SSL.",
    )

    resize = sub.add_parser(
        "resize-shards",
        help="Live-resize a sharded fleet: CAS the new "
        "shard-count target onto the ring lease; every replica's next "
        "membership tick starts the drain/handoff transition — no "
        "restarts, no unowned keys beyond one handoff window.",
    )
    resize.add_argument(
        "-n", "--shard-count", type=int, required=True,
        help="Target shard count (the live hash ring resizes to it).",
    )
    resize.add_argument(
        "--kubeconfig", default="",
        help="Path to a kubeconfig. Only required if out-of-cluster.",
    )
    resize.add_argument(
        "--master", default="",
        help="The address of the Kubernetes API server. Overrides any "
        "value in kubeconfig.",
    )
    resize.add_argument(
        "--force", action="store_true",
        help="Supersede an in-flight transition (only when the fleet "
        "is wedged — a forced restart recomputes every replica's plan).",
    )
    resize.add_argument(
        "--dry-run", action="store_true",
        help="Print the computed transition plan (donor/gainer arcs, "
        "moved keyspace fraction) without writing the ring lease.",
    )

    explain = sub.add_parser(
        "explain",
        help="Explain why an object has not converged: query "
        "every replica's /debug/explain, let the owning shard answer, "
        "and merge — non-owners report not-owner with their ring epoch.",
    )
    explain.add_argument(
        "key",
        help="Object key as namespace/name (e.g. default/my-service).",
    )
    explain.add_argument(
        "--controller", default="",
        help="Restrict the verdict to one controller worker (e.g. "
        "'service'); default merges across all controllers.",
    )
    explain.add_argument(
        "--fleet-peers", default="127.0.0.1:8080",
        help="Comma-separated host:port health endpoints of every "
        "replica (same value as the controller's --fleet-peers). A "
        "single peer queries just that replica.",
    )
    explain.add_argument(
        "--timeout", type=float, default=3.0,
        help="Per-peer HTTP timeout in seconds.",
    )
    explain.add_argument(
        "--capture", default="",
        help="Time-machine mode: instead of querying live "
        "peers, replay this incident capture in the deterministic sim "
        "and answer from the replayed world — the verdict as of "
        "--at seconds of virtual time.",
    )
    explain.add_argument(
        "--at", type=float, default=-1.0,
        help="With --capture: the past virtual instant (seconds) to "
        "stop the replay at before asking. Default: the capture's end.",
    )

    sub.add_parser("version", help="Print the version number")

    manifests = sub.add_parser(
        "manifests", help="Generate CRD/webhook/RBAC/sample manifests"
    )
    manifests.add_argument("-o", "--output", default="config", help="Output directory.")

    return parser


def resolve_kubeconfig(flag_value: str) -> str:
    """flag → $KUBECONFIG → ~/.kube/config → "" (in-cluster)."""
    if flag_value:
        return flag_value
    env = os.environ.get("KUBECONFIG", "")
    if env:
        return env
    default = os.path.expanduser("~/.kube/config")
    if os.path.exists(default):
        return default
    return ""


def run_controller(args) -> int:
    from .. import clockseam

    if not clockseam.threads_enabled():
        # the CLI lifecycle spawns slo/autoscale/health-server threads;
        # it is the production entry point and has no sim analogue
        raise RuntimeError(
            "run_controller requires a threaded runtime "
            "(clockseam.threads_enabled() is false)"
        )
    from ..cluster.rest import build_client
    from ..controllers import (
        EndpointGroupBindingConfig,
        GarbageCollectorConfig,
        GlobalAcceleratorConfig,
        Route53Config,
    )
    from ..leaderelection import LeaderElection, LeaderElectionConfig
    from ..manager import ControllerConfig, Manager
    from ..sharding import ShardingConfig
    from ..signals import setup_signal_handler

    kubeconfig = resolve_kubeconfig(args.kubeconfig)
    if kubeconfig:
        klog.infof("Using kubeconfig: %s", kubeconfig)
    else:
        klog.info("Using in-cluster config")
    try:
        client = build_client(kubeconfig, args.master)
    except Exception as err:
        klog.errorf("Error building rest config: %s", err)
        return 1

    namespace = os.environ.get("POD_NAMESPACE") or "default"
    # lease timing env overrides: the kill-recovery / leader-failover
    # drills need sub-second takeover, production keeps the reference's
    # 60/15/5 defaults.  Shared by the single-leader lease AND the
    # per-shard leases.
    lease_defaults = LeaderElectionConfig()
    lease_config = LeaderElectionConfig(
        lease_duration=float(
            os.environ.get("AGAC_LEASE_DURATION", lease_defaults.lease_duration)
        ),
        renew_deadline=float(
            os.environ.get("AGAC_LEASE_RENEW_DEADLINE", lease_defaults.renew_deadline)
        ),
        retry_period=float(
            os.environ.get("AGAC_LEASE_RETRY_PERIOD", lease_defaults.retry_period)
        ),
    )
    queue_limits = {
        "queue_qps": args.queue_qps,
        "queue_burst": args.queue_burst,
        "queue_max_backoff": args.queue_max_backoff,
        "drift_resync_period": args.drift_resync_period,
        "reconcile_deadline": args.reconcile_deadline,
    }
    config = ControllerConfig(
        global_accelerator=GlobalAcceleratorConfig(
            workers=args.workers, cluster_name=args.cluster_name, **queue_limits
        ),
        route53=Route53Config(
            workers=args.workers, cluster_name=args.cluster_name, **queue_limits
        ),
        endpoint_group_binding=EndpointGroupBindingConfig(
            workers=args.workers, **queue_limits
        ),
        garbage_collector=GarbageCollectorConfig(
            interval=args.gc_interval,
            grace_sweeps=args.gc_grace_sweeps,
            max_deletes=args.gc_max_deletes,
            dry_run=args.gc_dry_run,
            cluster_name=args.cluster_name,
        ),
        sharding=ShardingConfig(
            shard_count=args.shard_count,
            shards_per_replica=args.shards_per_replica,
            namespace=namespace,
            lease=lease_config,
        ),
    )
    stop = setup_signal_handler()

    # the incident capture: a wall-clock tap over this
    # controller's whole external-input stream.  Armed before any
    # informer or AWS traffic so the recording starts at genesis;
    # closed at exit (the per-record flush makes a SIGKILL'd tail a
    # tolerated torn record, not a lost capture).
    capture_path = args.capture_path or os.environ.get("AGAC_CAPTURE_PATH", "")
    if capture_path:
        import atexit

        from ..sim import capture as capture_mod

        capture_path = capture_path.replace("%p", str(os.getpid()))
        max_bytes = (
            args.capture_max_bytes
            or int(os.environ.get("AGAC_CAPTURE_MAX_BYTES", "0"))
            or capture_mod.DEFAULT_MAX_BYTES
        )
        tap = capture_mod.IncidentCapture(
            capture_path, max_bytes=max_bytes,
            clock_mode="real", source="controller",
        )
        capture_mod.install(tap)
        tap.record_clock("start")
        klog.infof("incident capture armed: %s (max %d bytes)",
                   capture_path, max_bytes)

        def _close_capture():
            tap.record_clock("stop")
            capture_mod.install(None)
            tap.close()

        atexit.register(_close_capture)

    from ..cloudprovider.aws.factory import (
        adoption_hooks,
        configure_api_health,
        configure_pipeline,
        configure_read_plane,
        real_cloud_factory,
        settle_poll_interval,
        shared_health_tracker,
        shared_settle_table,
    )

    configure_read_plane(args.read_plane_ttl)
    configure_pipeline(
        settle_poll_interval=args.settle_poll_interval,
        r53_batch_max=args.r53_batch_max,
        r53_batch_linger=args.r53_batch_linger,
    )
    config.settle_poll_interval = settle_poll_interval()
    configure_api_health(
        window=args.api_health_window,
        failure_ratio=args.api_health_failure_ratio,
        min_calls=args.api_health_min_calls,
        open_duration=args.api_health_open_duration,
        probe_budget=args.api_health_probe_budget,
        aimd_qps=args.api_health_aimd_qps,
    )
    from ..observability import metrics as obs_metrics
    from ..observability import profile as obs_profile
    from ..observability import stackprof as obs_stackprof
    from ..observability import trace as obs_trace

    obs_trace.configure(args.trace_sample)
    obs_profile.configure(stages=args.profile_stages)
    if args.profile_hz > 0:
        # continuous sampling profiler: folds stacks in the
        # background; SIGTERM dumps the top table with the post-mortem
        obs_stackprof.configure(args.profile_hz)
        obs_stackprof.profiler().start(stop)
    tracker = shared_health_tracker()
    manager = Manager(health=tracker, metrics_registry=obs_metrics.registry())
    # reshard adoptions re-read AWS through fresh snapshots, from the
    # moment the keys are served
    manager.on_adopt, manager.on_reshard = adoption_hooks()
    # this process's journey tracker holds its own journeys only: keys
    # it stops serving close here without a latency, and the new owner
    # observes their convergence in its own process
    manager.on_release = manager.release_journeys
    # confirmed orphans are torn down by delete reconciles on workers,
    # parking on settle waits like a delete event's teardown
    manager.gc_hands_over = True

    import threading

    from ..manager import make_health_server
    from ..observability import fleet as obs_fleet
    from ..observability import journey as obs_journey
    from ..observability import slo as obs_slo

    if args.slo_eval_interval > 0:
        # the convergence SLO engine over the process-global
        # journey histograms; installing it globally arms the
        # deferrable-load gates in the GC sweeper and drift tickers
        slo_engine = obs_slo.SLOEngine(
            registry=obs_metrics.registry(),
            journey_tracker=obs_journey.tracker(),
        )
        obs_slo.install_engine(slo_engine)

        def slo_loop():
            while not stop.wait(args.slo_eval_interval):
                try:
                    slo_engine.tick()
                except Exception as err:  # a bad tick must not kill the loop
                    klog.errorf("slo engine tick failed: %s", err)

        threading.Thread(target=slo_loop, daemon=True, name="slo-engine").start()

    # the fleet-merged scrape: this replica's registry plus
    # every --fleet-peers replica's /metrics
    fleet_view = obs_fleet.FleetView({"self": obs_metrics.registry().render})
    for peer in filter(None, (p.strip() for p in args.fleet_peers.split(","))):
        url = peer if peer.startswith("http") else f"http://{peer}"
        fleet_view.add_source(
            peer, obs_fleet.http_fetcher(url.rstrip("/") + "/metrics")
        )

    autoscaler = None
    if args.autoscale:
        # the shard autoscaler: burn rates + journey ages +
        # the ring-lease load board in, railed resize decisions out
        # through the same CAS path the resize-shards CLI uses
        if args.shard_count <= 1:
            klog.warning(
                "--autoscale requires --shard-count > 1; autoscaler disabled"
            )
        elif args.slo_eval_interval <= 0:
            klog.warning(
                "--autoscale requires the SLO engine "
                "(--slo-eval-interval > 0); autoscaler disabled"
            )
        else:
            from ..autoscaler import (
                AutoscalerLoop,
                ScalePolicy,
                ScalePolicyConfig,
                ScaleSignals,
            )

            def _resize_status():
                membership = manager.shard_membership
                return (
                    membership.resize_status() if membership is not None else {}
                )

            def _replica_count():
                membership = manager.shard_membership
                if membership is None:
                    return 0
                holders = membership.shard_map().get("holders", {})
                return len(set(holders.values()))

            autoscaler = AutoscalerLoop(
                ScaleSignals(
                    slo_engine=obs_slo.engine(),
                    journey_tracker=obs_journey.tracker(),
                    resize_status=_resize_status,
                    keys_by_shard=manager.keys_by_shard,
                    replica_count=_replica_count,
                    open_circuits=(
                        tracker.open_services if tracker is not None else None
                    ),
                ),
                ScalePolicy(
                    ScalePolicyConfig(
                        min_shards=args.autoscale_min_shards,
                        max_shards=args.autoscale_max_shards,
                        cooldown_out_seconds=args.autoscale_cooldown_out,
                        cooldown_in_seconds=args.autoscale_cooldown_in,
                        observe_only=args.autoscale_observe_only,
                    )
                ),
                execute=lambda target: manager.request_resize(client, target),
                registry=obs_metrics.registry(),
            )

            def autoscale_loop():
                autoscaler.run(stop, args.autoscale_interval)

            threading.Thread(
                target=autoscale_loop, daemon=True, name="autoscaler"
            ).start()

    if args.health_port > 0:
        health_server = make_health_server(
            args.health_port, health=tracker, gc_status=manager.gc_status,
            shard_status=manager.shard_status, fleet_view=fleet_view,
            queue_status=manager.queue_status,
            autoscaler_status=(
                autoscaler.status if autoscaler is not None else None
            ),
            autoscaler_history=(
                autoscaler.history if autoscaler is not None else None
            ),
        )
        threading.Thread(
            target=health_server.serve_forever, daemon=True, name="health-server"
        ).start()
    if args.metrics_port > 0 and args.metrics_port != args.health_port:
        # a dedicated scrape listener for deployments that separate
        # probe and metrics networks; same handler, same registry
        metrics_server = make_health_server(
            args.metrics_port, health=tracker, gc_status=manager.gc_status,
            shard_status=manager.shard_status, fleet_view=fleet_view,
        )
        threading.Thread(
            target=metrics_server.serve_forever, daemon=True, name="metrics-server"
        ).start()

    def run_manager(stop_event):
        manager.run(
            client, config, stop_event, cloud_factory=real_cloud_factory,
            block=True, settle_table=shared_settle_table(),
        )

    if args.shard_count > 1:
        # sharded mode: every replica runs concurrently —
        # the per-shard leases (manager's membership loop) decide who
        # works which keys, so the single-leader lease would only
        # serialize the fleet back down to one active process
        klog.infof(
            "sharded mode: %d shards, capacity %d/replica — classic "
            "leader election disabled",
            args.shard_count, args.shards_per_replica or args.shard_count,
        )
        run_manager(stop)
        return 0

    if args.disable_leader_election:
        run_manager(stop)
        return 0

    election = LeaderElection(
        "aws-global-accelerator-controller", namespace, config=lease_config
    )
    election.run(
        client,
        run_manager,
        stop,
        # lease lost: exit so the kubelet restarts us as a follower
        # (reference ``leaderelection.go:70-73``)
        on_stopped_leading=lambda: os._exit(0),
    )
    return 0


def run_resize_shards(args) -> int:
    from ..cluster.rest import build_client
    from ..sharding import HashRing, request_resize, ring_status, transition_plan

    kubeconfig = resolve_kubeconfig(args.kubeconfig)
    try:
        client = build_client(kubeconfig, args.master)
    except Exception as err:
        klog.errorf("Error building rest config: %s", err)
        return 1
    namespace = os.environ.get("POD_NAMESPACE") or "kube-system"
    try:
        status = ring_status(client, namespace=namespace)
    except Exception as err:
        print(f"resize refused: {err}", file=sys.stderr)
        return 1
    current = status["shard_count"]
    if args.shard_count == current:
        print(
            f"resize refused: the fleet is already at {current} shards "
            f"(epoch {status['epoch']}) — nothing to do",
            file=sys.stderr,
        )
        return 1
    # show the operator exactly what will move before anything acts
    if current >= 1:
        plan = transition_plan(HashRing(current), HashRing(args.shard_count))
        print(
            f"transition plan {current} -> {args.shard_count} shards: "
            f"{plan.moved_fraction:.1%} of the keyspace moves"
        )
        for donor in sorted(plan.gainers_of):
            gainers = ", ".join(
                str(gainer) for gainer in sorted(plan.gainers_of[donor])
            )
            print(f"  shard {donor} drains to shard(s) {gainers}")
    if status["in_flight"] and not args.force:
        print(
            "note: a resize transition is still in flight — the request "
            "will be refused unless --force",
        )
    if args.dry_run:
        print("dry run: ring lease not written")
        return 0
    try:
        epoch = request_resize(
            client, args.shard_count, namespace=namespace, force=args.force
        )
    except Exception as err:
        print(f"resize refused: {err}", file=sys.stderr)
        return 1
    print(
        f"resize to {args.shard_count} shards requested (epoch {epoch}); "
        "watch /healthz sharding.resize until state returns to 'stable'"
    )
    return 0


def run_explain(args) -> int:
    """Query /debug/explain across the fleet and print the merged verdict.

    Every peer is asked; the owning shard's answer wins (see
    observability.explain.merge_fleet_explains). Peers that cannot be
    reached are reported in the ``peers`` map rather than dropped, so a
    partial fleet still yields the most-blocking view of what answered.
    """
    import json
    import urllib.error
    import urllib.parse
    import urllib.request

    from ..observability import explain as obs_explain

    if getattr(args, "capture", ""):
        # time-machine mode: replay the capture to --at
        # virtual seconds and answer from the replayed world
        from ..sim.replay import ReplayHarness
        from ..sim.capture import load_capture

        capture = load_capture(args.capture)
        with ReplayHarness(capture) as rh:
            if args.at >= 0:
                rh.run_to(args.at)
            else:
                rh.run_to(float("inf"))
            answer = rh.explain(args.key, args.controller or None)
        print(json.dumps(answer, indent=2, sort_keys=True))
        return 0 if answer.get("verdict") not in ("", "no-live-stack") else 1

    peers = [p.strip() for p in args.fleet_peers.split(",") if p.strip()]
    if not peers:
        print("no --fleet-peers given", file=sys.stderr)
        return 2
    params = {"key": args.key}
    if args.controller:
        params["controller"] = args.controller
    query = urllib.parse.urlencode(params)

    answers = {}
    for peer in peers:
        url = peer if peer.startswith("http") else f"http://{peer}"
        url = url.rstrip("/") + "/debug/explain?" + query
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                answers[peer] = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as err:
            # 4xx still carries the JSON error contract; surface it
            try:
                answers[peer] = json.loads(err.read().decode("utf-8"))
            except Exception:
                answers[peer] = {"error": f"HTTP {err.code}"}
        except Exception as err:
            answers[peer] = {"error": str(err)}

    merged = obs_explain.merge_fleet_explains(answers)
    print(json.dumps(merged, indent=2, sort_keys=True))
    return 0 if merged.get("owner") else 1


def run_webhook(args) -> int:
    from ..webhook import Server

    use_ssl = args.ssl == "true"
    if use_ssl and (not args.tls_cert_file or not args.tls_private_key_file):
        print(
            "You must set --tls-cert-file and --tls-private-key-file when you use SSL",
            file=sys.stderr,
        )
        return 2
    Server(
        args.port,
        args.tls_cert_file if use_ssl else "",
        args.tls_private_key_file if use_ssl else "",
    )
    return 0


def run_version(_args) -> int:
    print(f"Version : {VERSION}")
    print(f"Revision: {REVISION}")
    print(f"Build   : {BUILD}")
    return 0


def run_manifests(args) -> int:
    from ..manifests import write_manifests

    for path in write_manifests(args.output):
        print(os.path.join(args.output, path))
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    klog.init(verbosity=args.verbosity)
    if args.command == "controller":
        return run_controller(args)
    if args.command == "resize-shards":
        return run_resize_shards(args)
    if args.command == "explain":
        return run_explain(args)
    if args.command == "webhook":
        return run_webhook(args)
    if args.command == "version":
        return run_version(args)
    if args.command == "manifests":
        return run_manifests(args)
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
