"""The port's SyncNet teacher pretraining (speech2lip_tpu_torch.train.
syncnet_pretrain, cli.train_syncnet, weights.init_syncnet) against the JAX
package's, on the CPU.

``build_sync_arrays`` decodes the same JPEGs with cv2: the face windows are
bit-equal; the mel windows come from the port's float64 mel spectrogram
against JAX's float32 one, within tests/test_torch_dataset.py's MEL_TOL.

``pretrain_teacher``: two steps from the JAX ``init`` of the JAX key
schedule, with the JAX draws passed in, at batch 8 (16 windows through
BatchNorm in train mode).  The first loss (the same parameters and
windows) to 1e-4 relative (measured 2.5e-6).  Adam's first step moves each
weight by about lr·sign(g), so where float32 noise flips the sign of a
gradient near zero the weight lands 2·lr away (0.09% of the weights after
one step).  Those flips move the second loss by 2.1e-3 relative (bound
5e-3) and its gradients: after two steps the weights are within 2·lr per
step, and all but 2% of them within lr (measured 0.74%; 2.3% beyond
lr/2, 67% beyond 1e-6, 0.07% beyond 2·lr).  At batch 2
the late layers' batch statistics over 4 windows (two faces) amplify
float32 noise to 1.5e-4 in the first loss already: both packages sit
~1e-4 from a float64 run.
"""


import jax
import numpy as np
import pytest
import torch

from speech2lip_tpu.core import checkpoint as jckpt
from speech2lip_tpu.data.synthetic import make_learnable_tree
from speech2lip_tpu.models import syncnet as jsyncnet
from speech2lip_tpu.train import syncnet_pretrain as jsp
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.cli import train_syncnet as tcli
from speech2lip_tpu_torch.config import save_config
from speech2lip_tpu_torch.core import checkpoint as tckpt
from speech2lip_tpu_torch.data.synthetic import synthetic_config
from speech2lip_tpu_torch.train import syncnet_pretrain as tsp
from speech2lip_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

MEL_TOL = 1e-4          # float32 (JAX) against float64 (port) mel
LOSS0_TOL = 1e-4        # relative, the first loss
LOSS1_TOL = 5e-3        # relative, the loss after one Adam step
FLIP_SHARE = 2e-2       # weights more than lr apart
to_np = lambda tree: jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def identity(tmp_path_factory):
    """A learnable identity of 48 frames at face 48, val 8: 36 windows."""
    tmp = tmp_path_factory.mktemp("sync_id")
    root = str(tmp / "identity")
    geo = make_learnable_tree(root, n_frames=48, face=48, lip_h=16, lip_w=24)
    cfg = synthetic_config(root, geo)
    cfg["data"]["val_split_frames"] = 8
    path = str(tmp / "config.yaml")
    save_config(path, cfg)
    return cfg, path


def test_build_sync_arrays_matches_jax(identity):
    cfg = identity[0]
    windows, mels = tsp.build_sync_arrays(cfg)
    jw, jm = jsp.build_sync_arrays(cfg)
    assert windows.shape == (36, 48, 96, 15) and mels.shape == (36, 80, 16)
    assert windows.dtype == mels.dtype == np.float32
    np.testing.assert_array_equal(windows, jw)
    np.testing.assert_allclose(mels, jm, rtol=0, atol=MEL_TOL)


def test_too_few_windows_raise_in_both(identity):
    cfg = dict(identity[0], data=dict(identity[0]["data"],
                                      val_split_frames=38))
    for pkg in (jsp, tsp):
        kw = {"device": "cpu"} if pkg is tsp else {}
        with pytest.raises(ValueError, match=r"need >= 7 sync windows .*got 6"):
            pkg.pretrain_teacher(cfg, steps=1, batch=2, **kw)


def test_pretrain_teacher_matches_jax(identity):
    cfg = identity[0]
    seed, steps, batch, lr = 0, 2, 8, 1e-4
    (jp, js), jhist = jsp.pretrain_teacher(
        cfg, steps=steps, batch=batch, lr=lr, seed=seed, log_every=1,
        log=lambda *_: None)
    # the JAX tool's key schedule, drawn here and passed to the port
    n = len(tsp.build_sync_arrays(cfg)[0])
    key = jax.random.PRNGKey(seed)
    key, init_key = jax.random.split(key)
    draws = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        k1, k2 = jax.random.split(k)
        draws.append((np.asarray(jax.random.randint(k1, (batch,), 0, n)),
                      np.asarray(jax.random.randint(k2, (batch,), 3, n - 3))))
    init = weights.syncnet_from_jax(*to_np(jsyncnet.init(init_key)))
    start = tckpt.flatten(init[0])
    (tp, ts), hist = tsp.pretrain_teacher(
        cfg, steps=steps, batch=batch, lr=lr, log_every=1,
        log=lambda *_: None, device="cpu", init=init, draws=draws)

    assert len(hist) == len(jhist) == steps
    assert hist[0] == pytest.approx(jhist[0], rel=LOSS0_TOL)
    assert hist[1] == pytest.approx(jhist[1], rel=LOSS1_TOL)
    want, got = jckpt._flatten(to_np((jp, js))), tckpt.flatten((tp, ts))
    assert set(got) == set(want)
    far = total = 0
    for k in want:
        if not k.startswith("0/"):
            continue
        d = np.abs(got[k] - want[k])
        assert d.max() <= 2 * lr * steps + 1e-6, k
        far += int((d > lr).sum())
        total += d.size
        # every weight moved as Adam moves it: about lr a step
        assert np.abs(got[k] - start[k[2:]]).max() <= lr * steps * 1.01, k
    assert far <= FLIP_SHARE * total, (far, total)


def test_pretrain_teacher_default_draws_are_seeded(identity):
    cfg = identity[0]
    runs = [tsp.pretrain_teacher(cfg, steps=2, batch=2, seed=s,
                                 log=lambda *_: None, device="cpu")[1]
            for s in (3, 3, 4)]
    assert runs[0] == runs[1] != runs[2]
    assert all(np.isfinite(runs[0]))
    # the float32 / deterministic settings of the steps are restored
    assert torch.backends.cudnn.deterministic is False
    assert torch.backends.cudnn.allow_tf32 is True


def test_init_syncnet_follows_jax_init():
    """The JAX ``init``'s tree, shapes and distribution: convs and biases
    uniform(+-1/sqrt(fan_in)), BatchNorm at 1, 0, 0, 1."""
    params, state = weights.init_syncnet(0)
    got = tckpt.flatten((params, state))
    want = jckpt._flatten(to_np(jsyncnet.init(jax.random.PRNGKey(0))))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for k, v in got.items():
        leaf = k.rsplit("/", 1)[1]
        if leaf in ("scale", "var"):
            assert (v == 1).all(), k
        elif leaf in ("bias", "mean"):
            assert (v == 0).all(), k
        else:
            w = got[k.replace("/b", "/w")] if leaf == "b" else v
            bound = 1 / np.sqrt(np.prod(w.shape[:3]))
            assert np.abs(v).max() <= np.float32(bound), k
            if v.size > 1000:
                assert np.std(v) == pytest.approx(bound / np.sqrt(3),
                                                  rel=0.05), k


def test_teacher_checkpoint_loads_in_both(identity, tmp_path):
    """The port's cli/train_syncnet writes the JAX (params, state) layout:
    the JAX loader takes every leaf from it, and the reverse; both sides'
    trainers load the file as their sync teacher."""
    cfg, path = identity
    port_file = str(tmp_path / "port.ckpt")
    hist = tcli.main([path, "--out", port_file, "--steps", "2", "--batch",
                      "2", "--device", "cpu"])
    assert len(hist) == 2 and all(np.isfinite(hist))
    flat, _ = tckpt.load(port_file)
    like = jsyncnet.init(jax.random.PRNGKey(5))
    tree, _ = jckpt.load(port_file, like=like)
    loaded = jckpt._flatten(to_np(tree))
    assert set(loaded) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(loaded[k], flat[k], err_msg=k)

    jax_file = str(tmp_path / "jax.ckpt")
    jckpt.save(jax_file, like)
    want = jckpt._flatten(to_np(like))
    got, _ = tckpt.load(jax_file, like=weights.init_syncnet(1))
    got = tckpt.flatten(got)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # the port's trainer takes it as training.syncnet_weights
    tcfg = dict(cfg, training=dict(cfg["training"],
                                   syncnet_weights=jax_file))
    frozen = ttrainer.load_frozen_weights(
        tcfg, {"syncnet": weights.random_syncnet(0)})
    np.testing.assert_array_equal(
        frozen["syncnet"][0]["face"][0]["conv"]["w"].numpy(),
        want["0/face/0/conv/w"])
