"""The port's checkpoints (speech2lip_tpu_torch.core.checkpoint and
train_step.state_to_tree) against the JAX package's on the CPU: a JAX
``TrainState`` written by ``speech2lip_tpu.core.checkpoint`` restores in the
port and the port's restores in JAX, in the full and the chunked regime,
with equal key sets both ways and values that round-trip exactly; and the
managers' retention (``latest_step_file``, ``save_best`` backups, resume
scalars) behaves the same.  Leaves are drawn with numpy on the JAX init's
own trees (``jax.eval_shape``).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.core import checkpoint as jckpt
from speech2lip_tpu.core.config import default_config as jdefault_config
from speech2lip_tpu.core.metrics import MetricsWriter as JMetricsWriter
from speech2lip_tpu.core.tb_events import decode_scalar_events
from speech2lip_tpu.models import talking_face as jtf
from speech2lip_tpu.models import unet_light as junet
from speech2lip_tpu.train import train_step as jts
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.core import checkpoint as tckpt
from speech2lip_tpu_torch.core.metrics import MetricsWriter
from speech2lip_tpu_torch.train import train_step as tts

torch.set_num_threads(2)

SCALARS = {"epoch_it": 2, "it": 5, "loss_val_best": 21.5}


def _cfg():
    cfg = jdefault_config()
    cfg["model"].update(canonical_depth_height=16, canonical_depth_width=20,
                        net_width=32)
    return cfg


def _fill(shapes, rng):
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


def _jax_state(chunked: bool, seed: int = 0):
    """A JAX TrainState with random leaves everywhere: params, U-Net, BN
    state, Adam moments; count 3, it 5."""
    cfg = _cfg()
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(0)
    params = _fill(jax.eval_shape(lambda k: jtf.init(k, cfg), key), rng)
    unet_p, unet_s = _fill(jax.eval_shape(junet.init, key), rng)
    trainable = params if chunked else {"model": params, "unet": unet_p}
    opt = jts.make_optimizer(cfg).init(trainable)
    adam = opt[0]._replace(count=jnp.int32(3), mu=_fill(opt[0].mu, rng),
                           nu=jax.tree.map(np.abs, _fill(opt[0].nu, rng)))
    opt = (adam, opt[1]._replace(count=jnp.int32(3)))
    return jts.TrainState(params, unet_p, unet_s, opt, jnp.int32(5))


def _port_state(chunked: bool, seed: int = 1, zero: bool = False):
    """A port TrainState of the same shapes; random Adam moments, count 3,
    it 5 (or all zeros with ``zero``)."""
    params, unet_p, unet_s = weights.random_params(seed, cfg=_cfg())
    trainable = params if chunked else {"model": params, "unet": unet_p}
    adam = tts.make_optimizer(_cfg()).init(tts.tree_leaves(trainable))
    state = tts.TrainState(params, unet_p, unet_s, adam, 0)
    if zero:
        return tts.TrainState(*[tts.tree_map(torch.zeros_like, t)
                                for t in state[:3]], adam, 0)
    g = torch.Generator().manual_seed(seed)
    adam = {"count": 3,
            "mu": [torch.randn(t.shape, generator=g) for t in adam["mu"]],
            "nu": [torch.rand(t.shape, generator=g) for t in adam["nu"]]}
    return tts.TrainState(params, unet_p, unet_s, adam, 5)


def _npz_keys(path):
    with np.load(path) as z:
        return set(z.files) - {"__scalars__"}


@pytest.mark.parametrize("chunked", [False, True])
def test_jax_checkpoint_restores_in_the_port(tmp_path, chunked):
    js = _jax_state(chunked)
    jckpt.CheckpointManager(str(tmp_path)).save_latest(js, **SCALARS)
    path = str(tmp_path / "model.ckpt")
    like = tts.state_to_tree(_port_state(chunked, zero=True), chunked)
    assert set(tckpt.flatten(like)) == _npz_keys(path)
    tree, scalars = tckpt.CheckpointManager(str(tmp_path)).restore(like)
    assert scalars == SCALARS
    state = tts.state_from_tree(tree)
    assert (state.it, state.opt_state["count"]) == (5, 3)
    ref = jckpt._flatten(js)
    got = tckpt.flatten(tts.state_to_tree(state, chunked))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("chunked", [False, True])
def test_port_checkpoint_restores_in_jax(tmp_path, chunked):
    ps = _port_state(chunked)
    tm = tckpt.CheckpointManager(str(tmp_path))
    tm.save_latest(tts.state_to_tree(ps, chunked), async_=True, **SCALARS)
    tm.wait()
    mgr = jckpt.CheckpointManager(str(tmp_path))
    like = jax.tree.map(jnp.zeros_like, _jax_state(chunked))
    path = str(tmp_path / "model.ckpt")
    assert set(jckpt._flatten(like)) == _npz_keys(path)
    restored, scalars = mgr.restore(like)
    assert scalars == SCALARS
    ref = tckpt.flatten(tts.state_to_tree(ps, chunked))
    got = jckpt._flatten(restored)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the optimizer keys of the two regimes
    keys = set(got)
    assert "opt_state/1/count" in keys and "it" in keys
    level = "opt_state/0/mu/audio_enc/conv/0/w" if chunked else \
        "opt_state/0/mu/model/audio_enc/conv/0/w"
    assert level in keys
    assert any(k.startswith("opt_state/0/nu/unet/") for k in keys) \
        != chunked


def _retention(mgr, tree, save_best_tree):
    mgr.save_latest(tree, it=10)
    mgr.save_step(tree, 2, epoch_it=0)
    mgr.save_step(tree, 4, epoch_it=1)
    mgr.save_best(save_best_tree, it=3, loss_val_best=1.0)
    mgr.save_best(save_best_tree, it=4, loss_val_best=2.0)
    files = sorted(re.sub(r"\.\d{14}$", ".<ts>", f)
                   for f in os.listdir(mgr.out_dir))
    return files, os.path.basename(mgr.latest_step_file())


def test_manager_retention_matches_jax(tmp_path):
    jtree = {"a": {"w": jnp.arange(6.0).reshape(2, 3)}, "b": [jnp.ones(2)]}
    ttree = {"a": {"w": torch.arange(6.0).reshape(2, 3)},
             "b": [torch.ones(2)]}
    jm = jckpt.CheckpointManager(str(tmp_path / "j"))
    tm = tckpt.CheckpointManager(str(tmp_path / "t"))
    assert jm.latest_step_file() is None and tm.latest_step_file() is None
    jfiles, jlatest = _retention(jm, jtree, jtree)
    tfiles, tlatest = _retention(tm, ttree, ttree)
    assert tfiles == jfiles and "model_best.ckpt.<ts>" in tfiles
    # resume picks the highest step file over a newer model.ckpt, as JAX
    assert tlatest == jlatest == "model_4.ckpt"
    _, jsc = jm.restore(jax.tree.map(jnp.zeros_like, jtree))
    like = {"a": {"w": torch.zeros(2, 3)}, "b": [torch.zeros(2)]}
    tree, tsc = tm.restore(like)
    assert tsc == jsc == {"epoch_it": 1, "it": 4}
    torch.testing.assert_close(tree["a"]["w"], ttree["a"]["w"], rtol=0,
                               atol=0)
    for m in (jm, tm):
        _, sc = m.restore(like if m is tm else jax.tree.map(
            jnp.zeros_like, jtree), name="model_best.ckpt")
        assert sc == {"it": 4, "loss_val_best": 2.0}
    # nothing to restore: the template comes back as it is
    empty = tckpt.CheckpointManager(str(tmp_path / "e"))
    assert empty.restore(like) == (like, {})


def test_tolerant_load_unflatten_and_weight_checks(tmp_path):
    t = {"a": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)},
         "list": [torch.zeros(2), torch.full((2, 2), 7.0)], "n": 4}
    p = str(tmp_path / "m.ckpt")
    tckpt.save(p, t, {"it": 42})
    like = {"a": {"w": torch.zeros(2, 3), "b": torch.zeros(3),
                  "new": torch.full((4,), -1.0)},
            "list": [torch.zeros(2), torch.zeros(3, 3)], "n": 0}
    loaded, scalars = tckpt.load(p, like)
    assert scalars == {"it": 42} and loaded["n"] == 4
    torch.testing.assert_close(loaded["a"]["w"], t["a"]["w"])
    torch.testing.assert_close(loaded["a"]["new"], like["a"]["new"])
    assert loaded["list"][1].shape == (3, 3)        # shape drift kept
    nested, _ = tckpt.load_nested(p)
    jnested, _ = jckpt.load_nested(p)
    assert isinstance(nested["list"], list)
    assert jax.tree.structure(nested) == jax.tree.structure(jnested)
    assert tckpt.check_weights(t) == []
    bad = {"a": torch.tensor([1.0, float("nan")]), "b": np.array([np.inf])}
    assert tckpt.check_weights(bad) == ["a", "b"]
    # sharded mode writes the checkpoint as a directory (the JAX package's
    # core/checkpoint_sharded format) and restores it as tolerantly
    mgr = tckpt.CheckpointManager(str(tmp_path / "sharded"), sharded=True)
    mgr.save_latest(t, it=42)
    assert os.path.isdir(tmp_path / "sharded" / "model.ckpt")
    loaded, scalars = mgr.restore(like)
    assert scalars == {"it": 42} and loaded["n"] == 4
    torch.testing.assert_close(loaded["a"]["w"], t["a"]["w"])
    torch.testing.assert_close(loaded["a"]["new"], like["a"]["new"])


def test_metrics_writer_matches_jax(tmp_path):
    vals = {"loss": torch.tensor(0.25), "psnr": 12.5, "skipme": "str"}
    for name, cls in (("t", MetricsWriter), ("j", JMetricsWriter)):
        w = cls(str(tmp_path / name))
        w.scalars(5, vals, prefix="train/")
        w.image(5, "panel", np.full((4, 6, 3), 0.5, np.float32))
        w.close()
    recs = {}
    for name in ("t", "j"):
        (line,) = open(tmp_path / name / "metrics.jsonl").read().splitlines()
        rec = json.loads(line)
        rec.pop("t")
        recs[name] = rec
        (ev,) = os.listdir(tmp_path / name / "tensorboard")
        events = decode_scalar_events(str(tmp_path / name / "tensorboard"
                                          / ev))
        assert events == {5: {"train/loss": 0.25, "train/psnr": 12.5}}
        assert os.listdir(tmp_path / name / "images") == [
            "panel_00000005.jpg"]
    assert recs["t"] == recs["j"] == {"it": 5, "train/loss": 0.25,
                                      "train/psnr": 12.5}
