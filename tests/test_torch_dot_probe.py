"""K8, the kernel-shaped dot probe, and its tool, against the JAX tool's own
Pallas kernel on the CPU.

``make`` is a closure inside ``tools/bench_int8_dot.py:main``; it is taken
out with ``ast`` and executed with small shapes, its ``pallas_call`` in
interpret mode.  The port's wrapper, given CPU tensors, runs its plain
version and launches nothing.
"""

import ast
import functools
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from speech2lip_tpu_torch.ops.kernels import dot_probe as kdp
from speech2lip_tpu_torch.tools import bench_int8_dot as tool

torch.set_num_threads(2)

JAX_TOOL = Path(__file__).resolve().parents[1] / "tools" / "bench_int8_dot.py"
SMALL = dict(m=32, k=64, n=48, g=3, t=4)
SHAPES = [SMALL, dict(m=16, k=128, n=8, g=1, t=2)]
# bf16 products are exact in float32 and float64; the JAX kernel sums them
# in float32 dot by dot, the plain version in float64 once
BF16_TOL = 1e-5


def jax_make(m, k, n, g, t):
    """The JAX tool's ``make(dtype, acc_dtype)`` at these shapes, its
    ``pallas_call`` run in interpret mode."""
    tree = ast.parse(JAX_TOOL.read_text())
    main = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    make = next(f for f in main.body
                if isinstance(f, ast.FunctionDef) and f.name == "make")
    ns = {"jax": jax, "jnp": jnp, "pltpu": pltpu,
          "pl": types.SimpleNamespace(
              pallas_call=functools.partial(pl.pallas_call, interpret=True),
              BlockSpec=pl.BlockSpec),
          "M": m, "K": k, "N": n, "G": g, "T": t}
    exec(compile(ast.Module(body=[make], type_ignores=[]), str(JAX_TOOL),
                 "exec"), ns)
    return ns["make"]


def _jax_out(shape, dt, lhs, rhs):
    make = jax_make(**shape)
    call = make(*((jnp.int8, jnp.int32) if dt == "int8"
                  else (jnp.bfloat16, jnp.float32)))
    to_jax = lambda x: jnp.asarray(x.float().numpy()).astype(
        jnp.int8 if dt == "int8" else jnp.bfloat16)
    return np.asarray(call(to_jax(lhs), to_jax(rhs)))


@pytest.mark.parametrize("shape", SHAPES, ids=["small", "k128_n8"])
def test_int8_matches_jax_kernel_exactly(shape):
    inputs = tool.make_inputs(shape["m"], shape["k"], shape["n"], shape["g"])
    lhs, rhs = inputs["int8"]
    kdp.launches = 0
    got = kdp.dot_probe(lhs, rhs, shape["t"])
    ref = _jax_out(shape, "int8", lhs, rhs)
    assert kdp.launches == 0
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    assert got.shape == ref.shape == (shape["t"], shape["m"], shape["n"])
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES, ids=["small", "k128_n8"])
def test_bf16_matches_jax_kernel(shape):
    inputs = tool.make_inputs(shape["m"], shape["k"], shape["n"], shape["g"])
    lhs, rhs = inputs["bf16"]
    kdp.launches = 0
    got = kdp.dot_probe(lhs, rhs, shape["t"])
    ref = _jax_out(shape, "bf16", lhs, rhs)
    assert kdp.launches == 0
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert got.shape == ref.shape
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= BF16_TOL * max(1.0, float(np.abs(ref).max())), err


def test_inputs_are_the_jax_tools_draws():
    """One default_rng(0): bf16 lhs and rhs from standard_normal, then int8
    from integers(-127, 127), converted as the JAX tool's jnp.asarray
    converts them (bit for bit)."""
    m, k, n, g = 8, 16, 24, 2
    rng = np.random.default_rng(0)
    want = {}
    for name, dt in (("bf16", jnp.bfloat16), ("int8", jnp.int8)):
        draw = (rng.standard_normal if name == "bf16"
                else functools.partial(rng.integers, -127, 127))
        want[name] = (jnp.asarray(draw((m, k)), dt),
                      jnp.asarray(draw((g, k, n)), dt))
    got = tool.make_inputs(m, k, n, g)
    for name in ("bf16", "int8"):
        for x, y in zip(got[name], want[name]):
            assert x.dtype == (torch.bfloat16 if name == "bf16"
                               else torch.int8)
            y = np.asarray(y.astype(jnp.float32))
            np.testing.assert_array_equal(x.float().numpy(), y)


def test_plain_is_one_tile_per_program():
    lhs, rhs = tool.make_inputs(16, 32, 8, 3)["int8"]
    out = kdp.dot_probe_plain(lhs, rhs, 5)
    want = sum(lhs.long() @ rhs[i].long() for i in range(3))
    assert out.shape == (5, 16, 8) and out.is_contiguous()
    for i in range(5):
        assert torch.equal(out[i], want.int())


def test_run_on_cpu_prints_the_jax_tools_lines(capsys):
    kdp.launches = 0
    res = tool.run(**SMALL, device="cpu", iters=2)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# device: cpu"
    assert re.fullmatch(r"bf16: +\d+\.\d{3} ms -> +\d+\.\d TF/s", lines[1])
    assert re.fullmatch(r"int8: +\d+\.\d{3} ms -> +\d+\.\d TOP/s", lines[2])
    assert kdp.launches == 0
    for name in ("bf16", "int8"):
        r = res[name]
        assert r["launches"] == 0 and r["ms"] > 0
        assert torch.equal(r["out"], kdp.dot_probe_plain(r["lhs"], r["rhs"],
                                                         SMALL["t"]))


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


def test_main_on_cpu_runs_the_probes_shape(monkeypatch):
    """``--device cpu`` is main's one option: the probe's shape and its
    count of timed calls are run()'s defaults."""
    assert tool.run.__defaults__ == (128, 768, 512, 8, 256, None, 30)
    assert tool.ITERS == 30
    calls = []
    monkeypatch.setattr(tool, "run", lambda **kw: calls.append(kw))
    tool.main(["--device", "cpu"])
    assert calls == [{"device": "cpu"}]
    with pytest.raises(SystemExit):
        tool.main(["--device", "cpu", "--iters", "1"])


def test_run_on_cpu_at_the_probes_shape(capsys):
    kdp.launches = 0
    res = tool.run(device="cpu", iters=1)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["# device", "bf16", "int8"]
    assert kdp.launches == 0
    for name, dt in (("bf16", torch.float32), ("int8", torch.int32)):
        out = res[name]["out"]
        assert out.dtype == dt and out.shape == (tool.T, tool.M, tool.N)
