"""The port's training loop and CLIs (speech2lip_tpu_torch.train.trainer,
cli.train, cli.infer) and its chunked step against the JAX package's, on
the CPU.

``fit``: a JAX ``make_synthetic_tree`` (64² face, 16x24 lip, 12 frames),
batch 2, the random draws of the step off (no local ensemble, no uv or
audio noise, no black-hole augmentation), the sync loss on from iteration
2, both packages resumed from one checkpoint written by the JAX package
and from the same frozen LPIPS / SyncNet weights, on one device each;
each trains to iteration 2, then resumes and trains to 3.  Per iteration, ``loss``,
``loss_rgb``, ``psnr`` and ``grad_norm`` of ``metrics.jsonl`` agree within
1e-4 relative (float32 sums in another order, as tests/test_torch_train.py;
measured <= 1.5e-5).  The JAX side's ``init_models`` is replaced by numpy
draws on its own trees: the checkpoint and the frozen-weight files
overwrite what it makes, and its PRNG would compile once per leaf shape.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.core import checkpoint as jckpt
from speech2lip_tpu.core.config import default_config as jdefault_config
from speech2lip_tpu.data import synthetic as jsyn
from speech2lip_tpu.data.synthetic import synthetic_batch
from speech2lip_tpu.models import lpips as jlpips
from speech2lip_tpu.models import syncnet as jsyncnet
from speech2lip_tpu.models import talking_face as jtf
from speech2lip_tpu.models import unet_light as junet
from speech2lip_tpu.train import train_step as jts
from speech2lip_tpu.train import trainer as jtrainer
from speech2lip_tpu_torch import config as tconfig
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.cli import infer as tinfer
from speech2lip_tpu_torch.cli import train as tcli_train
from speech2lip_tpu_torch.core import checkpoint as tckpt
from speech2lip_tpu_torch.data import image_io
from speech2lip_tpu_torch.train import train_step as tts
from speech2lip_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

FIT_TOL = 1e-4      # relative, per iteration
CHUNK_TOL = 1e-5    # relative, the chunked step's losses
KEYS = ("train/loss", "train/loss_rgb", "train/psnr", "train/grad_norm")
KEY = jax.random.PRNGKey(0)


def _fill(shapes, rng):
    """numpy leaves on a JAX tree of shapes: matrices and kernels
    uniform(+-1/sqrt(fan_in)), vectors (biases, BatchNorm) in [0.5, 1]."""
    def leaf(s):
        if len(s.shape) > 1:
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(s.dtype)
        return rng.uniform(0.5, 1.0, s.shape).astype(s.dtype)
    return jax.tree.map(leaf, shapes)


def _records(out_dir):
    return {r["it"]: r for r in map(json.loads, open(
        os.path.join(out_dir, "metrics.jsonl"))) if "train/loss" in r}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit")
    root = str(tmp / "tree")
    geo = jsyn.make_synthetic_tree(root, n_frames=12, face=64, lip_h=16,
                                   lip_w=24)
    cfg = jsyn.synthetic_config(root, geo)
    cfg["model"]["use_post_fusion_blackaug"] = False
    # one device: the test session's JAX CPU backend holds eight
    cfg["parallel"]["mesh_shape"] = [1, 1]
    cfg["training"].update(
        batch_size=2, print_every=1, checkpoint_every=0, backup_every=0,
        validate_every=0, visualize_every=0, use_local_ensemble=False,
        add_noise_uv=False, add_noise_audio=False, sync_start_iter=1,
        lpips_weights=str(tmp / "lpips.ckpt"),
        syncnet_weights=str(tmp / "syncnet.ckpt"))
    rng = np.random.default_rng(0)
    jckpt.save(cfg["training"]["lpips_weights"],
               _fill(jax.eval_shape(jlpips.init, KEY), rng))
    jckpt.save(cfg["training"]["syncnet_weights"],
               _fill(jax.eval_shape(jsyncnet.init, KEY), rng))
    params = _fill(jax.eval_shape(lambda k: jtf.init(k, cfg), KEY), rng)
    params["canonical_depth"] = rng.uniform(
        0.8, 1.2, params["canonical_depth"].shape).astype(np.float32)
    unet_p, unet_s = _fill(jax.eval_shape(junet.init, KEY), rng)
    opt = jts.make_optimizer(cfg)
    state = jts.TrainState(params, unet_p, unet_s,
                           opt.init({"model": params, "unet": unet_p}),
                           jnp.int32(0))
    cfgs = {}
    for who in ("jax", "port"):
        out = str(tmp / who)
        jckpt.CheckpointManager(out).save_latest(state, it=0, epoch_it=-1)
        cfgs[who] = dict(cfg, training=dict(cfg["training"], out_dir=out))

    def fast_init(cfg, ds, seed=0):
        shapes = jax.eval_shape(lambda k: jtf.init(k, cfg), KEY)
        frozen = {"lpips": jax.eval_shape(jlpips.init, KEY),
                  "syncnet": jax.eval_shape(jsyncnet.init, KEY)}
        z = lambda t: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), t)
        return (z(shapes), *z(jax.eval_shape(junet.init, KEY)), z(frozen))

    mp = pytest.MonkeyPatch()
    mp.setattr(jtrainer, "init_models", fast_init)
    try:
        for n in (2, 3):   # train to 2, then resume and train to 3
            jtrainer.fit(cfgs["jax"], max_iters=n)
            last = ttrainer.fit(cfgs["port"], max_iters=n, device="cpu")
    finally:
        mp.undo()
    return dict(tmp=tmp, root=root, cfg=cfgs["port"], last=last)


def test_fit_matches_jax_per_iteration(runs):
    jrec = _records(runs["cfg"]["training"]["out_dir"].replace("port",
                                                               "jax"))
    trec = _records(runs["cfg"]["training"]["out_dir"])
    assert sorted(jrec) == sorted(trec) == [1, 2, 3]
    assert "train/loss_sync" not in trec[1] and "train/loss_sync" in trec[2]
    for it in jrec:
        for k in KEYS:
            ref, got = jrec[it][k], trec[it][k]
            assert abs(got - ref) <= FIT_TOL * abs(ref), (it, k, got, ref)
        assert trec[it]["train/batch_ms"] > 0 and trec[it]["train/step_ms"] > 0


def test_fit_resumes_and_checkpoints_as_jax(runs):
    out = runs["cfg"]["training"]["out_dir"]
    assert runs["last"].it == 3
    _, scalars = tckpt.load(os.path.join(out, "model.ckpt"))
    _, jscalars = jckpt.load(os.path.join(out.replace("port", "jax"),
                                          "model.ckpt"))
    assert scalars["it"] == jscalars["it"] == 3
    assert scalars["epoch_it"] == jscalars["epoch_it"]
    log = open(os.path.join(out, "train.log")).read()
    assert "resume at it=2" in log and "staging change at it=2" in log
    # the port's checkpoint holds the JAX state's keys
    with np.load(os.path.join(out, "model.ckpt")) as z, np.load(
            os.path.join(out.replace("port", "jax"), "model.ckpt")) as zj:
        assert set(z.files) == set(zj.files)


def test_exit_after_checkpoints_and_exits_3(runs):
    cfg = json.loads(json.dumps(runs["cfg"]))
    cfg["training"]["out_dir"] = str(runs["tmp"] / "exit")
    tckpt.CheckpointManager(cfg["training"]["out_dir"])
    with pytest.raises(SystemExit) as exc:
        ttrainer.fit(cfg, exit_after=0.0, device="cpu")
    assert exc.value.code == 3
    _, scalars = tckpt.load(os.path.join(cfg["training"]["out_dir"],
                                         "model.ckpt"))
    assert scalars["it"] == 1


def test_cli_train_and_infer_on_the_cpu(runs, tmp_path, monkeypatch):
    cfg = json.loads(json.dumps(runs["cfg"]))
    cfg["parallel"]["mesh_shape"] = None
    cfg["training"].update(out_dir=str(tmp_path / "out"), checkpoint_every=1,
                           backup_every=2, validate_every=2,
                           visualize_every=2, use_syncloss=False)
    path = str(tmp_path / "cfg.yaml")
    tconfig.save_config(path, cfg)
    state = tcli_train.main([path, "--max-iters", "2", "--device", "cpu"])
    assert state.it == 2
    out = tmp_path / "out"
    assert {"model.ckpt", "model_2.ckpt", "model_best.ckpt",
            "metrics.jsonl", "train.log"} <= set(os.listdir(out))
    assert len(os.listdir(out / "images")) == 3
    assert any(r.get("val/psnr") for r in map(json.loads, open(
        out / "metrics.jsonl")))
    monkeypatch.chdir(tmp_path)
    res = tinfer.main([path, "--output_dir", "x", "--batch", "2",
                       "--device", "cpu"])
    assert res["it"] == 2 and res["frames"] == 2
    assert res["compute_dtype"] == "float32"
    frames = sorted(os.listdir(tmp_path / "rendering_result" / "x"
                               / "postfusion"))
    # numbered by position in the split, as the JAX CLI numbers them
    assert frames == ["00001.jpg", "00002.jpg"]
    img = image_io.imread_float(str(tmp_path / "rendering_result" / "x"
                                    / "postfusion" / frames[0]))
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()


def test_clis_default_to_the_card(runs, tmp_path, monkeypatch):
    """Without ``--device`` the CLIs ask for the card and raise where
    there is none: no silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "cfg.yaml")
    tconfig.save_config(path, dict(runs["cfg"], parallel={"mesh_shape": None}))
    for main in (tcli_train.main, tinfer.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([path])


def test_fit_refuses_what_the_port_lacks(runs, tmp_path):
    """A mesh of more ranks than the world is refused as the JAX
    ``make_mesh`` refuses more devices than it has, on either axis;
    per-chunk stepping refuses the other losses."""
    cfg = json.loads(json.dumps(runs["cfg"]))
    cfg["training"]["out_dir"] = str(tmp_path)
    for shape in ([2, 1], [1, 2]):
        cfg["parallel"]["mesh_shape"] = shape
        with pytest.raises(ValueError, match="needs 2 ranks"):
            ttrainer.fit(cfg, max_iters=1, device="cpu")
    cfg["parallel"]["mesh_shape"] = None
    cfg["training"]["batch_rays"] = 96
    with pytest.raises(ValueError, match="only the lip photometric"):
        ttrainer.fit(cfg, max_iters=1, device="cpu")


def test_chunked_fit_writes_the_chunked_keys(runs, tmp_path):
    cfg = json.loads(json.dumps(runs["cfg"]))
    cfg["model"]["use_post_fusion"] = False
    cfg["training"].update(out_dir=str(tmp_path), batch_rays=96,
                           use_perceptual_loss=False, use_syncloss=False,
                           use_canonical_depth_loss_photo_v2=False)
    state = ttrainer.fit(cfg, max_iters=1, device="cpu")
    assert state.opt_state["count"] == 4     # 384 rays in chunks of 96
    p = _fill(jax.eval_shape(lambda k: jtf.init(k, cfg), KEY),
              np.random.default_rng(1))
    up, us = _fill(jax.eval_shape(junet.init, KEY), np.random.default_rng(2))
    like = jts.TrainState(p, up, us, jts.make_optimizer(cfg).init(p),
                          jnp.int32(0))
    with np.load(str(tmp_path / "model.ckpt")) as z:
        assert set(z.files) - {"__scalars__"} == set(jckpt._flatten(like))


def _chunk_setup(ensemble):
    cfg = jdefault_config()
    cfg["model"].update(canonical_depth_height=64, canonical_depth_width=64)
    rng = np.random.default_rng(3)
    params = _fill(jax.eval_shape(lambda k: jtf.init(k, cfg), KEY), rng)
    up, us = _fill(jax.eval_shape(junet.init, KEY), rng)
    raw, geo = synthetic_batch(2, face=64, lip_h=16, lip_w=24, seed=1)
    base = dict(lip_h=16, lip_w=24, lip_x=geo["lip_x"], lip_y=geo["lip_y"],
                face_h=64, face_w=64, focal=geo["focal"], ensemble=ensemble)
    return cfg, params, up, us, raw, base


@pytest.mark.parametrize("ensemble", [True, False])
def test_chunked_step_matches_jax(ensemble):
    cfg, params, up, us, raw, base = _chunk_setup(ensemble)
    n_chunks, b = 4, 2
    jopt = jts.make_optimizer(cfg)
    jstep = jts.make_chunked_train_step(jopt, jts.StepStatics(**base),
                                        n_chunks, donate=False)
    jstate = jts.TrainState(params, up, us, jopt.init(params), jnp.int32(0))
    tp, tup, tus = weights.from_jax(params, up, us)
    topt = tts.make_optimizer(cfg)
    tstep = tts.make_chunked_train_step(topt, tts.StepStatics(**base),
                                        n_chunks)
    tstate = tts.TrainState(tp, tup, tus,
                            topt.init(tts.tree_leaves(tp)), 0)
    jbatch = jax.tree.map(jnp.asarray, raw)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in raw.items()}
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        # the JAX step's draws from ``key``, in its split sequence
        eps = np.stack([np.asarray(jax.random.uniform(k, (b,)))
                        for k in jax.random.split(key, n_chunks)])
        jstate, jm = jstep(jstate, jbatch, key)
        tstate, tm = tstep(tstate, tbatch, {"eps_u": torch.from_numpy(eps)})
        for k in ("loss", "loss_rgb", "psnr"):
            ref, got = float(jm[k]), float(tm[k])
            assert abs(got - ref) <= CHUNK_TOL * abs(ref), (i, k, got, ref)
    assert tstate.it == int(jstate.it) == 2
    assert tstate.opt_state["count"] == int(jstate.opt_state[0].count) == 8
    # the state maps onto the JAX chunked state's keys
    assert set(tckpt.flatten(tts.state_to_tree(tstate, chunked=True))) == \
        set(jckpt._flatten(jstate))
    # the U-Net passes through unchanged
    torch.testing.assert_close(tstate.unet_params["inc"]["conv1"]["w"],
                               tup["inc"]["conv1"]["w"], rtol=0, atol=0)
