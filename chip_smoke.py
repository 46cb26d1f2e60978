#!/usr/bin/env python3
"""Drive the PyTorch port (``agac_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--services N] [--seed S]

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
3. ``graft``: the torch twin of the MLP, forward and
   one train step on ``cuda``, held against the same weights run on
   the CPU in float32 with bf16 rounding at the same points.

The port has no hand-written kernel (the reference holds no Pallas
kernel), so the kernel line lists none.  The last line is
``{"ok": true, "device": {...}}``.

The fleet helpers and ``converge`` take the package as a parameter so
that tests can run the same fleet through the reference; this script
itself only ever loads the port.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import threading
import time
import types

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


class PhaseError(RuntimeError):
    """A phase's check failed."""


# ---------------------------------------------------------------------------
# the fleet: bench.py's workload objects, built from a given package
# ---------------------------------------------------------------------------

def load(package: str = PORT) -> types.SimpleNamespace:
    """The modules the fleet needs, from ``package``."""
    mod = lambda name: importlib.import_module(f"{package}.{name}")
    return types.SimpleNamespace(
        apis=mod("apis"),
        egb=mod("apis.endpointgroupbinding"),
        objects=mod("cluster.objects"),
        cluster=mod("cluster"),
        aws=mod("cloudprovider.aws"),
        controllers=mod("controllers"),
        manager=mod("manager"),
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
    pkg, n: int, accelerator_missing_retry: float = ACCELERATOR_MISSING_RETRY
) -> tuple[Fleet, float]:
    """Converge a fleet of ``n`` Services through ``pkg``'s Manager, then
    stop the Manager and join every thread it started.  Returns the
    fleet and the seconds from the objects' creation to convergence."""
    controllers, manager_mod = pkg.controllers, pkg.manager
    fleet = Fleet(pkg, n)
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
    parser.add_argument("--seed", type=int, default=0, help="seed of the graft MLP's weights")
    args = parser.parse_args(argv)
    try:
        import torch

        load(PORT)  # fails here, before any result, outside a checkout
        card = phase_device(torch)
        phase_converge(args.services, card)
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
