"""agac_tpu_torch — the PyTorch/CUDA port of ``agac_tpu``.

``agac_tpu`` is a from-scratch framework with the capabilities of
omi-lab/aws-global-accelerator-controller: a Kubernetes controller
that reconciles annotated Services, Ingresses and
EndpointGroupBindings into AWS Global Accelerator chains and Route53
records.  This package is its second implementation, module-complete.
It keeps the reference's module layout and every public name
(classes, functions, metric names, event reasons, annotation keys), so
each module here has its counterpart at the same relative path under
``agac_tpu/`` and the reference's tests can run against it through an
import alias.  It imports only itself, the standard library and (in
``graft_entry`` alone) ``torch``; never ``agac_tpu`` or ``jax``.

What it holds, from the entry point down (``python -m agac_tpu_torch
controller`` -> ``cmd.root`` -> ``Manager`` -> controllers ->
``AWSDriver``):

- the command line (``agac_tpu_torch.cmd``: ``controller``,
  ``webhook``, ``manifests``, ``explain``, ``resize-shards``,
  ``version``), the admission webhook (``agac_tpu_torch.webhook``) and
  the manifest generator (``agac_tpu_torch.manifests``),
- the generic level-triggered reconcile kernel
  (``agac_tpu_torch.reconcile``) with rate-limited workqueues,
- the cluster I/O layer (``agac_tpu_torch.cluster``): typed objects,
  shared informers, listers, the event recorder, the fake in-memory
  apiserver, and the wire: the Kubernetes REST client, the dataclass
  wire codec (``cluster.serde``) and the HTTP test apiserver,
- the cloud-provider layer (``agac_tpu_torch.cloudprovider``): the AWS
  drivers, read-plane caches, the Route53 change batcher, the health
  plane and the in-memory and durable fake AWS backends,
- the three controllers plus the GC sweeper
  (``agac_tpu_torch.controllers``), leader election, sharding and the
  shard autoscaler (``agac_tpu_torch.autoscaler``), the observability
  planes and the controller manager,
- the simulation slice (``agac_tpu_torch.sim``): the virtual-time
  runtime that runs the whole Manager on one thread, incident
  capture and replay, the invariant oracles and the scenario fuzzer
  (``python -m agac_tpu_torch.sim.fuzz``),
- the static analyses (``agac_tpu_torch.analysis``): the linter, the
  whole-program lock-order, census, determinism and confinement
  analyses and the runtime race checker,
- ``graft_entry``: the torch twin of the MLP in
  ``__graft_entry__.py``.

The control plane is host code; only ``graft_entry`` touches a device.
"""

VERSION = "0.1.0"
