"""The torch twin of the MLP against the JAX original.

Weights and data come from ``numpy.random.default_rng`` and are cast
to bf16.  The JAX side runs ``__graft_entry__._forward`` in a
subprocess, as ``tests/test_graft_entry.py`` does, because importing
``__graft_entry__`` sets ``XLA_FLAGS``; the port runs on the CPU in
this process.  Tolerances: the forward output within
``torch.testing.assert_close``'s bf16 defaults; the train step's loss
within a relative 1e-4 (both accumulate in float32); gradients within
an absolute 1e-3 (bf16 gradients of magnitude ~4e-3 differ by at most
a rounding step, ~1.5e-5, when the two frameworks round at different
places)."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0

JAX_SIDE = textwrap.dedent(
    """
    import sys

    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as graft

    jax.config.update("jax_platforms", "cpu")
    src, dst = sys.argv[1], sys.argv[2]
    data = np.load(src)
    params = {k: jnp.asarray(data[k], jnp.bfloat16) for k in ("w1", "w2")}
    x = jnp.asarray(data["x"], jnp.bfloat16)
    y = jnp.asarray(data["y"], jnp.bfloat16)

    def loss_fn(params, x, y):
        pred = graft._forward(params, x)
        return jnp.mean((pred.astype(jnp.float32) - y.astype(jnp.float32)) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
    new = jax.tree_util.tree_map(
        lambda p, g: (p.astype(jnp.float32) - 0.1 * g.astype(jnp.float32)).astype(p.dtype),
        params,
        grads,
    )
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    np.savez(
        dst,
        forward=f32(graft._forward(params, x)),
        loss=f32(loss),
        g1=f32(grads["w1"]),
        g2=f32(grads["w2"]),
        w1=f32(new["w1"]),
        w2=f32(new["w2"]),
    )
    """
)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Seeded inputs, and what the JAX program computes from them."""
    np = pytest.importorskip("numpy")
    pytest.importorskip("jax")
    rng = np.random.default_rng(SEED)
    inputs = {
        "w1": (0.02 * rng.standard_normal((64, 128))).astype(np.float32),
        "w2": (0.02 * rng.standard_normal((128, 64))).astype(np.float32),
        "x": rng.standard_normal((32, 64)).astype(np.float32),
        "y": rng.standard_normal((32, 64)).astype(np.float32),
    }
    tmp_path = tmp_path_factory.mktemp("graft")
    src, dst = tmp_path / "inputs.npz", tmp_path / "jax.npz"
    np.savez(src, **inputs)
    result = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(src), str(dst)],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=300,
    )
    assert result.returncode == 0, result.stderr
    with np.load(dst) as out:
        return inputs, dict(out)


def _tensors(torch, inputs):
    bf16 = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in inputs.items()}
    return bf16["x"], bf16["y"]


def test_forward_matches_jax(case):
    torch = pytest.importorskip("torch")
    from agac_tpu_torch import graft_entry

    inputs, ref = case
    model = graft_entry.GraftMLP(graft_entry.params_from_numpy(inputs, device="cpu"))
    x, _ = _tensors(torch, inputs)
    with torch.no_grad():
        out = model(x)
    assert out.dtype == torch.bfloat16 and out.shape == (32, 64)
    torch.testing.assert_close(out, torch.from_numpy(ref["forward"]).to(torch.bfloat16))


def test_train_step_matches_jax(case):
    torch = pytest.importorskip("torch")
    from agac_tpu_torch import graft_entry

    inputs, ref = case
    model = graft_entry.GraftMLP(graft_entry.params_from_numpy(inputs, device="cpu"))
    x, y = _tensors(torch, inputs)
    loss, grads = graft_entry.loss_and_grads(model, x, y)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert abs(float(loss) - float(ref["loss"])) <= 1e-4 * abs(float(ref["loss"]))
    for name, key in (("w1", "g1"), ("w2", "g2")):
        assert grads[name].dtype == torch.bfloat16
        diff = (grads[name].float() - torch.from_numpy(ref[key])).abs().max()
        assert float(diff) <= 1e-3, (name, float(diff))

    step_loss = graft_entry.train_step(model, x, y)
    assert float(step_loss) == float(loss)
    for name in ("w1", "w2"):
        param = getattr(model, name)
        assert param.dtype == torch.bfloat16
        torch.testing.assert_close(
            param.detach(), torch.from_numpy(ref[name]).to(torch.bfloat16)
        )


def test_entry_runs_on_the_requested_device():
    torch = pytest.importorskip("torch")
    from agac_tpu_torch import graft_entry

    fn, (params, x) = graft_entry.entry(device="cpu")
    out = fn(params, x)
    assert out.shape == (graft_entry.BATCH, graft_entry.FEATURES)
    assert out.dtype == torch.bfloat16 and out.device.type == "cpu"
    assert bool(torch.isfinite(out.float()).all())
    # seeded: a second call gives the same weights
    _, (again, _) = graft_entry.entry(device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)
    # with no device named, the entry points go to CUDA, never the CPU
    assert graft_entry._device(None) == torch.device("cuda")


def test_params_from_numpy_rejects_wrong_shapes():
    np = pytest.importorskip("numpy")
    pytest.importorskip("torch")
    from agac_tpu_torch import graft_entry

    with pytest.raises(ValueError, match="w1 has shape"):
        graft_entry.params_from_numpy(
            {"w1": np.zeros((128, 64)), "w2": np.zeros((128, 64))}, device="cpu"
        )
