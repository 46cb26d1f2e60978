"""The torch twin of the MLP in ``__graft_entry__.py``.

A bf16 two-layer MLP, ``tanh(x @ w1) @ w2`` with ``w1`` (64, 128) and
``w2`` (128, 64), at batch 32, and its train step: mean squared error
in float32, then SGD with learning rate 0.1 applied in float32 and cast
back to bf16.  The JAX program computes both products in plain ``jnp``
that XLA compiles, with no Pallas kernel behind them, so the twin uses
plain torch ops.

This is the only module of the package that imports ``torch``; the
controller itself is host code.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.  The multi-chip dry run of the JAX
program (its data x model mesh) is not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

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
