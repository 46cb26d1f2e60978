"""Machine-checked controller correctness.

Two halves, both specific to this codebase's hazard surface —
level-triggered multi-threaded reconcile loops over shared caches,
workqueues and a mutable fake cloud:

- ``agac_tpu_torch.analysis.lint`` — an AST invariant linter enforcing the
  controller-correctness rules ruff cannot express (raw backend calls
  from controllers, bare lock ``acquire()``, blocking sleeps inside
  reconcile paths, reconcile handlers that can fall through without a
  ``Result``, module-level imports of deps CI never installs).  Run it
  with ``python -m agac_tpu_torch.analysis.lint agac_tpu_torch``; the
  whole-program analyses (lock order, shared-state census, determinism,
  confinement) with ``python -m agac_tpu_torch.analysis.program
  agac_tpu_torch --baseline agac_tpu_torch/analysis/baseline.json``.
- ``agac_tpu_torch.analysis.racecheck`` — a runtime lock-order watchdog and
  instrumented lock/dict wrappers the core modules (workqueue,
  informer, leader election, fake backend) create their locks through.
  Disabled by default (plain ``threading`` primitives, zero overhead);
  tests enable it to fail on lock-order cycles and unlocked shared-
  dict mutation with the offending stacks.

The linter half is import-light on purpose: a CI job can run it with
nothing but a checkout and a stdlib Python.
"""
