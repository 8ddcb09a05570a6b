"""The port's ops (speech2lip_tpu_torch.ops) against the JAX package's.

Same inputs, made from a seed with numpy, go through both packages on the
CPU in float32; tolerances are stated per test.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.ops import coords as jcoords
from speech2lip_tpu.ops import embedders as jemb
from speech2lip_tpu.ops import grid_sample as jgs
from speech2lip_tpu.ops import nn as jnn
from speech2lip_tpu.ops.pallas import conv_block as jcb
from speech2lip_tpu_torch.ops import coords as tcoords
from speech2lip_tpu_torch.ops import embedders as temb
from speech2lip_tpu_torch.ops import grid_sample as tgs
from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.ops.kernels import conv_block as tcb

torch.set_num_threads(2)

TOL = 1e-5  # float32, same formulas; only summation order differs
ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else _np(got)
    ref = _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    assert err <= tol, err


def test_default_config_fields_match_jax():
    """The port's whole default tree equals the JAX package's."""
    from speech2lip_tpu.core.config import default_config as jdefault
    from speech2lip_tpu_torch.config import default_config
    assert default_config() == jdefault()


@pytest.mark.parametrize("multires", [0, 4, 10])
def test_fourier_embed(multires):
    x = np.random.default_rng(0).uniform(0, 1, (50, 2)).astype(np.float32)
    _close(temb.fourier_embed(_t(x), multires),
           jemb.fourier_embed(jnp.asarray(x), multires))


def test_time_embed_batched_matches_per_frame():
    idx = np.array([0, 3, 17, 250], np.float32)
    got = temb.time_embed(_t(idx), 20)
    ref = np.stack([_np(jemb.time_embed(jnp.asarray(i), 20)) for i in idx])
    # sin/cos of arguments up to 250 rad: float32 argument reduction
    _close(got, ref, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_get_coords(dtype):
    got = tcoords.get_coords(120, 80, dtype=getattr(torch, dtype))
    ref = jcoords.get_coords(120, 80, dtype=getattr(jnp, dtype))
    # bf16 rounds identically; float32 within one ulp of 1.0
    _close(got, ref.astype(jnp.float32), 0.0 if dtype == "bfloat16" else 1e-7)


def test_nn_layers():
    rng = np.random.default_rng(1)
    lin = {"w": rng.standard_normal((6, 5)).astype(np.float32),
           "b": rng.standard_normal(5).astype(np.float32)}
    x = rng.standard_normal((4, 6)).astype(np.float32)
    tl = {k: _t(v) for k, v in lin.items()}
    jl = {k: jnp.asarray(v) for k, v in lin.items()}
    _close(tnn.linear(tl, _t(x)), jnn.linear(jl, jnp.asarray(x)))

    c1 = {"w": rng.standard_normal((3, 7, 9)).astype(np.float32),
          "b": rng.standard_normal(9).astype(np.float32)}
    xs = rng.standard_normal((2, 16, 7)).astype(np.float32)
    _close(tnn.conv1d({k: _t(v) for k, v in c1.items()}, _t(xs), 2, 1),
           jnn.conv1d({k: jnp.asarray(v) for k, v in c1.items()},
                      jnp.asarray(xs), 2, 1))

    c2 = {"w": rng.standard_normal((3, 3, 5, 6)).astype(np.float32)}
    xi = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    _close(tnn.conv2d({"w": _t(c2["w"])}, _t(xi), padding=1),
           jnn.conv2d({"w": jnp.asarray(c2["w"])}, jnp.asarray(xi),
                      padding=1))

    bnp = {"scale": rng.uniform(0.5, 2, 5).astype(np.float32),
           "bias": rng.standard_normal(5).astype(np.float32)}
    bns = {"mean": rng.standard_normal(5).astype(np.float32),
           "var": rng.uniform(0.5, 2, 5).astype(np.float32)}
    ref, _ = jnn.batchnorm({k: jnp.asarray(v) for k, v in bnp.items()},
                           {k: jnp.asarray(v) for k, v in bns.items()},
                           jnp.asarray(xi), train=False)
    _close(tnn.batchnorm({k: _t(v) for k, v in bnp.items()},
                         {k: _t(v) for k, v in bns.items()}, _t(xi)), ref)

    _close(tnn.maxpool2d(_t(xi)), jnn.maxpool2d(jnp.asarray(xi)))
    _close(tnn.relu(_t(xi)), jnn.relu(jnp.asarray(xi)), 0.0)
    _close(tnn.leaky_relu(_t(xi)), jnn.leaky_relu(jnp.asarray(xi), 0.02),
           0.0)


@pytest.mark.parametrize("out_size,in_size", [(10, 5), (250, 125), (8, 1)])
def test_align_corners_upsample(out_size, in_size):
    _close(tnn._align_corners_matrix(out_size, in_size, torch.float32),
           jnn._align_corners_matrix(out_size, in_size, jnp.float32))
    x = np.random.default_rng(2).standard_normal(
        (2, in_size, in_size + 1, 3)).astype(np.float32)
    _close(tnn.upsample_bilinear(_t(x), out_size, out_size + 2),
           jnn.upsample_bilinear(jnp.asarray(x), out_size, out_size + 2))


def _grid(rng, b, h, w, lo=-1.1, hi=1.1):
    return rng.uniform(lo, hi, (b, h, w, 2)).astype(np.float32)


def test_grid_sample_zeros_padding():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (2, 13, 17, 3)).astype(np.float32)
    grid = _grid(rng, 2, 9, 7)
    _close(tgs.grid_sample(_t(img), _t(grid)),
           jgs.grid_sample(jnp.asarray(img), jnp.asarray(grid)))


def test_grid_sample_onehot_on_interior_points():
    rng = np.random.default_rng(4)
    b, hs, ws, h, w, y_off, x_off = 2, 22, 38, 100, 120, 40, 40
    src = rng.uniform(0, 1, (b, hs, ws, 3)).astype(np.float32)
    gx = rng.uniform((x_off + 2) / w * 2 - 1, (x_off + ws - 3) / w * 2 - 1,
                     (b, 300))
    gy = rng.uniform((y_off + 2) / h * 2 - 1, (y_off + hs - 3) / h * 2 - 1,
                     (b, 300))
    grid = np.stack([gx, gy], -1).astype(np.float32)
    _close(tgs.grid_sample_onehot(_t(src), _t(grid), y_off, x_off, h, w),
           jgs.grid_sample_onehot(jnp.asarray(src), jnp.asarray(grid),
                                  y_off, x_off, h, w))


@pytest.mark.parametrize("binarize", [True, False])
def test_warp_box_mask(binarize):
    rng = np.random.default_rng(5)
    grid = _grid(rng, 2, 20, 24)
    box = (6, 15, 4, 40)  # clipped to the image at the bottom
    _close(tgs.warp_box_mask(_t(grid), box, 30, 26, binarize),
           jgs.warp_box_mask(jnp.asarray(grid), box, 30, 26, binarize))


def test_fold_bn():
    rng = np.random.default_rng(6)
    p = {"scale": rng.uniform(0.5, 2, 8).astype(np.float32),
         "bias": rng.standard_normal(8).astype(np.float32)}
    s = {"mean": rng.standard_normal(8).astype(np.float32),
         "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    got = tcb.fold_bn({k: _t(v) for k, v in p.items()},
                      {k: _t(v) for k, v in s.items()})
    ref = jcb.fold_bn({k: jnp.asarray(v) for k, v in p.items()},
                      {k: jnp.asarray(v) for k, v in s.items()})
    for g, r in zip(got, ref):
        _close(g, r)


def test_port_imports_no_jax():
    """Every module of the port, then ``chip_smoke`` (its ``main`` is
    guarded), imported in a fresh process, leaves no ``jax*`` and nothing
    of ``speech2lip_tpu`` in ``sys.modules``; and no import statement
    anywhere in those files, lazy ones inside functions included, names
    one of them."""
    code = r"""
import ast, importlib, pathlib, pkgutil, sys
import speech2lip_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
assert len(mods) >= 84, mods
assert {pkg.__name__ + "." + m for m in (
    "models.tiny_landmarks", "train.metrics_eval", "train.syncnet_pretrain",
    "cli.evaluate", "cli.train_syncnet", "tools.convergence_run",
    "ops.rasterize", "preprocess.face_3dmm", "preprocess.steps",
    "preprocess.tracker", "preprocess.landmarks",
    "preprocess.synthetic_world", "models.fan", "models.s3fd",
    "models.dsfd", "models.bisenet", "cli.preprocess",
    "tools.train_tiny_landmarks", "tools.bench_preprocess",
    "core.factory", "tools.convert_weights", "tools.reference_weights",
    "tools.full_pipeline_run", "tools.bench_train",
    "tools.bench_components", "parallel.distributed", "parallel.mesh",
    "core.checkpoint_sharded", "data.native_loader")} <= set(mods)

def banned(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "speech2lip_tpu")

loaded = [m for m in sys.modules if banned(m)]
assert not loaded, loaded
files = [pathlib.Path(sys.modules[m].__file__) for m in mods + ["chip_smoke"]]
for f in files:
    for node in ast.walk(ast.parse(f.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(banned(n) for n in names), (str(f), names)
print(len(files))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 85
