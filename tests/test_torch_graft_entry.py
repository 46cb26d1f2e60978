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
places).

The data x model dry run (``dryrun_multichip``) runs in a subprocess,
since it spawns one process per rank, with the same seeded weights and
all-ones ``x`` and ``y``, as the JAX program's dry run has them.  Its
loss is held to the unsharded step's, the port's and JAX's, within the
same relative 1e-4.  Its updated weights are within one bf16 rounding
step of the port's unsharded step, and within the train step's bf16
tolerance above of JAX's: gradients that differ by a bf16 rounding
move a small weight by more than its own bf16 spacing."""

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


PORT_DRYRUN = textwrap.dedent(
    """
    import sys

    import numpy as np

    from agac_tpu_torch import graft_entry

    src, dst = sys.argv[1], sys.argv[2]
    arrays = dict(np.load(src))
    out = {}
    for n in (8, 6):
        loss, new = graft_entry.dryrun_multichip(n, arrays)
        out[f"loss{n}"] = np.float32(loss)
        for name, w in new.items():
            out[f"{name}_{n}"] = w.float().numpy()
    np.savez(dst, **out)
    """
)
MESHES = {8: ((4, 2), 32), 6: ((3, 2), 33)}


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """The port's dry run at 8 and 6 ranks, and JAX's unsharded step, on
    the same seeded weights and all-ones data."""
    np = pytest.importorskip("numpy")
    pytest.importorskip("torch")
    pytest.importorskip("jax")
    rng = np.random.default_rng(SEED + 1)
    weights = {
        "w1": (0.02 * rng.standard_normal((64, 128))).astype(np.float32),
        "w2": (0.02 * rng.standard_normal((128, 64))).astype(np.float32),
    }
    tmp_path = tmp_path_factory.mktemp("dryrun")
    np.savez(tmp_path / "weights.npz", **weights)
    port = subprocess.run(
        [sys.executable, "-c", PORT_DRYRUN, str(tmp_path / "weights.npz"), str(tmp_path / "port.npz")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert port.returncode == 0, port.stderr[-4000:]
    jax_out = {}
    for batch in sorted({b for _, b in MESHES.values()}):
        ones = np.ones((batch, 64), np.float32)
        src, dst = tmp_path / f"in{batch}.npz", tmp_path / f"jax{batch}.npz"
        np.savez(src, x=ones, y=ones, **weights)
        result = subprocess.run(
            [sys.executable, "-c", JAX_SIDE, str(src), str(dst)],
            capture_output=True, text=True, cwd=REPO, timeout=300,
        )
        assert result.returncode == 0, result.stderr
        with np.load(dst) as out:
            jax_out[batch] = dict(out)
    with np.load(tmp_path / "port.npz") as out:
        return weights, dict(out), port.stdout, jax_out


def _assert_within_one_bf16_step(torch, actual, expected, name):
    """Every element of ``actual`` is its bf16 counterpart in
    ``expected`` or one of that value's two bf16 neighbours."""
    actual, expected = actual.to(torch.bfloat16), expected.to(torch.bfloat16)
    up = torch.nextafter(expected, torch.full_like(expected, float("inf")))
    down = torch.nextafter(expected, torch.full_like(expected, float("-inf")))
    outside = (actual < down) | (actual > up)
    assert not bool(outside.any()), (name, int(outside.sum()))


def test_dryrun_prints_the_reference_mesh_line(dryrun):
    _, _, stdout, _ = dryrun
    for (data, model), _ in MESHES.values():
        assert f"dryrun_multichip OK: mesh=({data} data x {model} model), loss=" in stdout


@pytest.mark.parametrize("n", sorted(MESHES))
def test_dryrun_matches_the_unsharded_step(dryrun, n):
    torch = pytest.importorskip("torch")
    from agac_tpu_torch import graft_entry

    weights, port, _, _ = dryrun
    (data, model), batch = MESHES[n]
    assert graft_entry.mesh_shape(n) == (data, model)
    assert graft_entry.dryrun_batch(data) == batch
    model_ = graft_entry.GraftMLP(graft_entry.params_from_numpy(weights, device="cpu"))
    ones = torch.ones(batch, 64, dtype=torch.bfloat16)
    loss = float(graft_entry.train_step(model_, ones, ones))
    assert abs(float(port[f"loss{n}"]) - loss) <= 1e-4 * abs(loss)
    for name in ("w1", "w2"):
        _assert_within_one_bf16_step(
            torch, torch.from_numpy(port[f"{name}_{n}"]), getattr(model_, name).detach(), name
        )


@pytest.mark.parametrize("n", sorted(MESHES))
def test_dryrun_matches_jax(dryrun, n):
    torch = pytest.importorskip("torch")

    _, port, _, jax_out = dryrun
    ref = jax_out[MESHES[n][1]]
    assert abs(float(port[f"loss{n}"]) - float(ref["loss"])) <= 1e-4 * abs(float(ref["loss"]))
    for name in ("w1", "w2"):
        torch.testing.assert_close(
            torch.from_numpy(port[f"{name}_{n}"]).to(torch.bfloat16),
            torch.from_numpy(ref[name]).to(torch.bfloat16),
        )
