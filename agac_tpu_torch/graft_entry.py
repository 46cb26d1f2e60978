"""The torch twin of the MLP in ``__graft_entry__.py``.

A bf16 two-layer MLP, ``tanh(x @ w1) @ w2`` with ``w1`` (64, 128) and
``w2`` (128, 64), at batch 32, and its train step: mean squared error
in float32, then SGD with learning rate 0.1 applied in float32 and cast
back to bf16.  The JAX program computes both products in plain ``jnp``
that XLA compiles, with no Pallas kernel behind them, so the twin uses
plain torch ops.

This is the only module of the package that imports ``torch``; the
controller itself is host code.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.  ``dryrun_multichip(n)`` runs the JAX
program's multi-chip dry run, one train step over a data x model mesh,
in n processes over gloo on the CPU: the JAX program's own dry run uses
n virtual CPU devices.

Run as a script (``python -m agac_tpu_torch.graft_entry``), it does what
``python __graft_entry__.py`` does: the dry run at 8, then the forward's
shape.
"""

from __future__ import annotations

from typing import Mapping, Optional

# torch is this module's whole point (it is the MLP's torch twin); no CI
# workflow installs it, and no other module of the package imports it
import torch  # agac-lint: ignore[unguarded-optional-import] -- the torch twin needs torch
from torch import nn  # agac-lint: ignore[unguarded-optional-import] -- the torch twin needs torch

HIDDEN = 128
FEATURES = 64
BATCH = 32
LR = 0.1
INIT_SCALE = 0.02


def _device(device: Optional[str | torch.device]) -> torch.device:
    return torch.device("cuda" if device is None else device)


def init_params(generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random weights scaled like the JAX program's ``_init_params``.
    Torch's generator gives other numbers than ``jax.random`` from the
    same seed; to compare the two, hand both the same weights through
    ``params_from_numpy``."""
    kwargs = {"generator": generator, "device": generator.device}
    return {
        "w1": (INIT_SCALE * torch.randn(FEATURES, HIDDEN, **kwargs)).to(torch.bfloat16),
        "w2": (INIT_SCALE * torch.randn(HIDDEN, FEATURES, **kwargs)).to(torch.bfloat16),
    }


def params_from_numpy(
    arrays: Mapping[str, object], device: Optional[str | torch.device] = None
) -> dict[str, torch.Tensor]:
    """Weights given as numpy arrays (float32, or bf16 from
    ``ml_dtypes``), as bf16 tensors on ``device``.  A bf16 input goes
    through float32 exactly, so JAX's weights arrive bit for bit."""
    import numpy as np

    params = {}
    for name, shape in (("w1", (FEATURES, HIDDEN)), ("w2", (HIDDEN, FEATURES))):
        array = np.asarray(arrays[name], dtype=np.float32)
        if array.shape != shape:
            raise ValueError(f"{name} has shape {array.shape}, expected {shape}")
        params[name] = torch.from_numpy(array).to(_device(device), torch.bfloat16)
    return params


def _forward(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    hidden = torch.tanh(x @ params["w1"])
    return hidden @ params["w2"]


class GraftMLP(nn.Module):
    """The MLP as a module: bf16 parameters ``w1`` and ``w2``."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.w1 = nn.Parameter(params["w1"].to(torch.bfloat16))
        self.w2 = nn.Parameter(params["w2"].to(torch.bfloat16))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _forward({"w1": self.w1, "w2": self.w2}, x)


def loss_fn(model: GraftMLP, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    pred = model(x)
    return torch.mean((pred.float() - y.float()) ** 2)


def loss_and_grads(
    model: GraftMLP, x: torch.Tensor, y: torch.Tensor
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The float32 loss and the bf16 gradient of each parameter, the
    counterpart of ``jax.value_and_grad(loss_fn)``."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, x, y)
    loss.backward()
    return loss.detach(), {name: p.grad for name, p in model.named_parameters()}


def train_step(model: GraftMLP, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One SGD step, ``p <- bf16(f32(p) - LR * f32(g))``.  Unlike the
    JAX step, which returns new parameters, it updates the module in
    place.  Returns the loss before the step."""
    loss, grads = loss_and_grads(model, x, y)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_((p.float() - LR * grads[name].float()).to(p.dtype))
    return loss


def entry(device: Optional[str | torch.device] = None):
    """``(fn, example_args)`` for the batch-32 forward, as the JAX
    ``entry()`` gives them: weights from seed 0 and an all-ones input,
    on ``device`` (CUDA by default)."""
    dev = _device(device)
    params = {
        name: w.to(dev)
        for name, w in init_params(torch.Generator().manual_seed(0)).items()
    }
    x = torch.ones(BATCH, FEATURES, dtype=torch.bfloat16, device=dev)
    return _forward, (params, x)


# ---------------------------------------------------------------------------
# the multi-chip dry run: one train step over a data x model mesh
# ---------------------------------------------------------------------------


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """``(data, model)``: model 2 when ``n_devices`` is even, else 1."""
    model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // model, model


def dryrun_batch(data: int) -> int:
    """The batch rounded up to a multiple of the data axis (33 at 3)."""
    return data * -(-BATCH // data)


class _ModelSum(torch.autograd.Function):
    """Sum the partial products of the model group in the forward pass;
    pass the gradient through unchanged in the backward pass, since
    every model rank then holds the whole output and its loss."""

    @staticmethod
    def forward(ctx, partial: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist

        total = partial.clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


# how long the dry run waits for a rank at a time, and in all, s
_POLL_S = 0.5
_DRYRUN_TIMEOUT_S = 300.0


def _dryrun_rank(rank: int, world: int, store_path: str, arrays: dict, results) -> None:
    """One rank of the dry run.  ``w1`` is split over the model axis by
    columns (the JAX program's ``P(None, "model")``) and ``w2`` by rows
    (``P("model", None)``); the batch is split over the data axis.  The
    first product is local, the second sums over the model group, and
    the gradients, each rank's share of the global mean, sum over the
    data group."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    # the ranks meet through a file and talk over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world
    )
    try:
        data, model = mesh_shape(world)
        mesh = init_device_mesh("cpu", (data, model), mesh_dim_names=("data", "model"))
        d, m = mesh.get_coordinate()
        batch = dryrun_batch(data)
        rows, width = batch // data, HIDDEN // model
        full = params_from_numpy(arrays, device="cpu")
        # the shards as exact float32 copies of the bf16 weights: each
        # product and its gradient accumulate in float32 and round to
        # bf16 where one device's bf16 matmul would, and the gradient
        # rounds to bf16 once, after its sum over the data group
        w1 = full["w1"][:, m * width:(m + 1) * width].float().requires_grad_()
        w2 = full["w2"][m * width:(m + 1) * width, :].float().requires_grad_()
        assert tuple(w1.shape) == (FEATURES, HIDDEN // model), w1.shape
        x = torch.ones(rows, FEATURES, dtype=torch.bfloat16)
        y = torch.ones(rows, FEATURES, dtype=torch.bfloat16)

        hidden = torch.tanh((x.float() @ w1).to(torch.bfloat16))
        # this rank's share of the contraction over the hidden axis
        partial = hidden.float() @ w2
        pred = _ModelSum.apply(partial, mesh.get_group("model")).to(torch.bfloat16)
        share = ((pred.float() - y.float()) ** 2).sum() / (batch * FEATURES)
        share.backward()

        loss = share.detach().clone()
        dist.all_reduce(loss, group=mesh.get_group("data"))
        new = {}
        for name, p in (("w1", w1), ("w2", w2)):
            grad = p.grad.clone()
            dist.all_reduce(grad, group=mesh.get_group("data"))
            grad = grad.to(torch.bfloat16).float()
            new[name] = (p.detach() - LR * grad).to(torch.bfloat16).float().numpy()
        results.put((rank, (d, m), float(loss), new))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(
    n_devices: int, params: Optional[Mapping[str, object]] = None
) -> tuple[float, dict[str, torch.Tensor]]:
    """One full train step over an ``n_devices`` mesh with data x model
    axes (data over the batch, model over the hidden dimension), run in
    ``n_devices`` processes over gloo on the CPU, the counterpart of the
    JAX program's dry run on n virtual CPU devices.  ``x`` and ``y`` are
    all ones; the weights are ``params`` (numpy arrays, as
    ``params_from_numpy`` takes them) or seed 0's.  Prints the JAX
    program's line and returns the loss before the step and the updated
    weights, gathered from their shards."""
    import os
    import queue as queue_mod
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    data, model = mesh_shape(n_devices)
    if params is None:
        params = init_params(torch.Generator().manual_seed(0))
    arrays = {
        name: (
            w.detach().float().cpu().numpy()
            if isinstance(w, torch.Tensor)
            else np.asarray(w, np.float32)
        )
        for name, w in params.items()
    }
    results = mp.get_context("spawn").Queue()
    got = {}
    polls = int(_DRYRUN_TIMEOUT_S / _POLL_S)
    with tempfile.TemporaryDirectory(prefix="graft-dryrun-") as store:
        ctx = mp.start_processes(
            _dryrun_rank,
            args=(n_devices, os.path.join(store, "store"), arrays, results),
            nprocs=n_devices,
            join=False,
            start_method="spawn",
        )
        try:
            # each poll waits for a result; the count of polls bounds the run
            for _ in range(polls):
                if len(got) == n_devices:
                    break
                try:
                    rank, coord, loss, new = results.get(timeout=_POLL_S)
                    got[rank] = (coord, loss, new)
                except queue_mod.Empty:
                    ctx.join(timeout=0)  # raises if a rank failed
            if len(got) < n_devices:
                raise TimeoutError(f"dry run: {len(got)} of {n_devices} ranks answered")
            if not any(ctx.join(timeout=_POLL_S) for _ in range(polls)):
                raise TimeoutError("dry run: ranks did not exit")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join()

    losses = {loss for _, loss, _ in got.values()}
    assert len(losses) == 1, f"ranks disagree on the loss: {sorted(losses)}"
    loss = losses.pop()
    assert loss == loss, "loss is NaN"  # noqa: PLR0124 — NaN check
    width = HIDDEN // model
    new = {
        "w1": np.zeros((FEATURES, HIDDEN), np.float32),
        "w2": np.zeros((HIDDEN, FEATURES), np.float32),
    }
    for (d, m), _, shard in sorted(got.values(), key=lambda r: r[0]):
        assert shard["w1"].shape == (FEATURES, width), shard["w1"].shape
        cols = slice(m * width, (m + 1) * width)
        if d == 0:
            new["w1"][:, cols], new["w2"][cols, :] = shard["w1"], shard["w2"]
        else:  # every data rank ends with the same shards
            np.testing.assert_array_equal(shard["w1"], new["w1"][:, cols])
            np.testing.assert_array_equal(shard["w2"], new["w2"][cols, :])
    print(f"dryrun_multichip OK: mesh=({data} data x {model} model), loss={loss:.4f}")
    return loss, {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in new.items()}


if __name__ == "__main__":
    dryrun_multichip(8)
    fn, args = entry()
    print("entry() forward:", tuple(fn(*args).shape))
