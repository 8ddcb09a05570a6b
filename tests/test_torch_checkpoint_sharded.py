"""The port's sharded checkpoints (speech2lip_tpu_torch.core.
checkpoint_sharded) against the JAX package's, both ways, on the CPU: a
directory the JAX ``save_sharded`` writes from a (2, 4) mesh of this
session's virtual devices restores in the port, and one the port's two
gloo ranks write restores in JAX ``restore_sharded``.  Every value must
come back exactly, the tolerant cases included (a key the files lack
keeps the template leaf, so does a leaf whose shape drifted, and a value
is cast to the template's dtype).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from speech2lip_tpu.core.checkpoint_sharded import (restore_sharded as
                                                    jrestore,
                                                    save_sharded as jsave)
from speech2lip_tpu.parallel.mesh import make_mesh as jmake_mesh
from speech2lip_tpu_torch.core import checkpoint as tckpt
from speech2lip_tpu_torch.core.checkpoint_sharded import (restore_sharded,
                                                          save_sharded)
from torch_ranks import run_ranks
import torch_ranks


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 12)).astype(np.float32),
                       "b": rng.standard_normal(5).astype(np.float32)},
            "opt": [rng.standard_normal((4, 3)).astype(np.float32),
                    np.asarray(7, np.int32)],
            "it": np.asarray(5, np.int32)}


def _nan_like(values):
    """A torch template: NaN floats, -1 ints, plus the tolerant cases."""
    def t(a):
        out = torch.from_numpy(np.array(a))
        return out.fill_(float("nan") if out.is_floating_point() else -1)
    like = {"params": {"w": t(values["params"]["w"]),
                       "b": t(values["params"]["b"]).double(),   # cast
                       "new": torch.ones(2)},                    # unknown
            "opt": [torch.zeros(3, 4),                           # drifted
                    t(values["opt"][1])],
            "it": 0}
    return like


def test_a_jax_sharded_checkpoint_restores_in_the_port(tmp_path):
    v = _values()
    mesh = jmake_mesh((2, 4))
    put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    tree = {"params": {"w": put(v["params"]["w"], P("data", "pixel")),
                       "b": put(v["params"]["b"], P())},
            "opt": [put(v["opt"][0], P("data")), put(v["opt"][1], P())],
            "it": jnp.asarray(v["it"])}
    jsave(str(tmp_path / "ck"), tree, {"it": 5, "epoch_it": 1})
    got, scalars = restore_sharded(str(tmp_path / "ck"), _nan_like(v))
    assert scalars == {"it": 5, "epoch_it": 1}
    assert torch.equal(got["params"]["w"], torch.from_numpy(v["params"]["w"]))
    assert got["params"]["b"].dtype == torch.float64
    assert torch.equal(got["params"]["b"],
                       torch.from_numpy(v["params"]["b"]).double())
    assert torch.equal(got["params"]["new"], torch.ones(2))
    assert torch.equal(got["opt"][0], torch.zeros(3, 4))
    assert int(got["opt"][1]) == 7 and got["it"] == 5


def test_a_port_sharded_checkpoint_restores_in_jax(tmp_path):
    v = _values(1)
    path = str(tmp_path / "ck")
    files = run_ranks(torch_ranks.save_sharded, 2, tmp_path, path, v,
                      {"it": 5})
    assert files[0] == files[1] == ["index-p0.json", "index-p1.json",
                                    "meta.json", "shards-p0.npz",
                                    "shards-p1.npz"]
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta == {"processes": 2, "scalars": {"it": 5}}
    # replicated state: written once, by rank 0
    with np.load(os.path.join(path, "shards-p1.npz")) as z:
        assert not z.files
    mesh = jmake_mesh((2, 4))
    like = {"params": {"w": jax.device_put(np.zeros((8, 12), np.float32),
                                           NamedSharding(mesh, P("data"))),
                       "b": np.zeros(5, np.float64),
                       "new": np.ones(2, np.float32)},
            "opt": [np.zeros((3, 4), np.float32), np.zeros((), np.int32)],
            "it": np.zeros((), np.int32)}
    got, scalars = jrestore(path, like)
    assert scalars == {"it": 5}
    assert np.array_equal(np.asarray(got["params"]["w"]), v["params"]["w"])
    assert got["params"]["w"].sharding == like["params"]["w"].sharding
    assert got["params"]["b"].dtype == np.float64
    assert np.array_equal(got["params"]["b"], v["params"]["b"])
    assert np.array_equal(got["params"]["new"], np.ones(2))
    assert np.array_equal(got["opt"][0], np.zeros((3, 4)))
    assert int(got["opt"][1]) == 7 and int(got["it"]) == 5


def test_port_ranks_restore_their_own_checkpoint_bit_exactly(tmp_path):
    """Saved and restored by two ranks into NaN templates, every leaf
    equal on both; stale files of a larger group are ignored."""
    v = _values(2)
    path = str(tmp_path / "ck")
    os.makedirs(path)
    with open(os.path.join(path, "index-p2.json"), "w") as f:
        json.dump({"it": {"shape": [], "dtype": "int32", "blocks": [
            {"file": "shards-p2.npz", "key": "it#0", "bounds": []}]}}, f)
    run_ranks(torch_ranks.save_sharded, 2, tmp_path, path, v, {})
    like = torch_ranks._numpy(_nan_like(v))
    like["opt"][0] = np.full((4, 3), np.nan, np.float32)
    like["params"]["b"] = np.full(5, np.nan, np.float32)
    for tree, _ in run_ranks(torch_ranks.restore_sharded, 2, tmp_path,
                             path, like):
        assert np.array_equal(tree["params"]["w"], v["params"]["w"])
        assert np.array_equal(tree["params"]["b"], v["params"]["b"])
        assert np.array_equal(tree["opt"][0], v["opt"][0])
        assert tree["opt"][1].shape == () and int(tree["opt"][1]) == 7
        assert tree["it"] == 5


def test_the_manager_routes_sharded_saves(tmp_path):
    """``CheckpointManager(sharded=True)`` writes directories, resumes from
    the highest ``model_<it>.ckpt`` directory, and a dense manager reads
    them too."""
    v = _values(3)
    tree = torch_ranks._to_torch(v)
    mgr = tckpt.CheckpointManager(str(tmp_path), sharded=True)
    mgr.save_latest(tree, it=2)
    mgr.save_step(tree, 4)
    mgr.save_best(tree, it=4)
    mgr.save_best(tree, it=5)
    names = sorted(os.listdir(tmp_path))
    assert {"model.ckpt", "model_4.ckpt", "model_best.ckpt"} <= set(names)
    assert any(n.startswith("model_best.ckpt.") for n in names)
    assert all(os.path.isdir(tmp_path / n) for n in names)
    like = torch_ranks._to_torch(_values(9))
    for m in (mgr, tckpt.CheckpointManager(str(tmp_path))):
        got, scalars = m.restore(like)
        assert scalars == {"it": 4}
        assert torch.equal(got["params"]["w"], tree["params"]["w"])
    with pytest.raises(FileNotFoundError):
        restore_sharded(str(tmp_path / "missing"), like)
    save_sharded(str(tmp_path / "one"), tree)       # one process: no group
    assert json.load(open(tmp_path / "one" / "meta.json"))["processes"] == 1
