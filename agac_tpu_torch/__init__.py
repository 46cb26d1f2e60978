"""agac_tpu_torch — the PyTorch/CUDA port of ``agac_tpu``.

``agac_tpu`` is a from-scratch framework with the capabilities of
omi-lab/aws-global-accelerator-controller: a Kubernetes controller
that reconciles annotated Services, Ingresses and
EndpointGroupBindings into AWS Global Accelerator chains and Route53
records.  This package is its second implementation, built slice by
slice.  It keeps the reference's module layout and every public name
(classes, functions, metric names, event reasons, annotation keys), so
each module here has its counterpart at the same relative path under
``agac_tpu/`` and the reference's tests can run against it through an
import alias.  It imports only itself, the standard library and (in
``graft_entry`` alone) ``torch``; never ``agac_tpu`` or ``jax``.

Ported so far — the convergence path, ``Manager`` → controllers →
``AWSDriver``:

- the generic level-triggered reconcile kernel
  (``agac_tpu_torch.reconcile``) with rate-limited workqueues,
- the cluster I/O layer (``agac_tpu_torch.cluster``): typed objects,
  shared informers, listers, the event recorder and the fake
  in-memory apiserver,
- the cloud-provider layer (``agac_tpu_torch.cloudprovider``): the AWS
  drivers, read-plane caches, health plane and the in-memory fake AWS
  backend,
- the three controllers plus the GC sweeper
  (``agac_tpu_torch.controllers``), leader election, sharding, the
  observability planes and the controller manager,
- the simulation slice (``agac_tpu_torch.sim``): the virtual-time
  runtime that runs the whole Manager on one thread, incident
  capture and replay, the invariant oracles and the scenario fuzzer
  (``python -m agac_tpu_torch.sim.fuzz``), with what it builds on:
  the shard autoscaler (``agac_tpu_torch.autoscaler``), the Route53
  change batcher and the dataclass wire codec (``cluster.serde``),
- ``graft_entry``: the torch twin of the MLP in
  ``__graft_entry__.py``.

The control plane is host code; only ``graft_entry`` touches a device.
"""

VERSION = "0.1.0"
