"""The port's serving of new audio against the JAX package, on inputs made
from a numpy seed: ``MultiSpeakerServer``, ``new_audio_frames`` and the
``cli/serve`` daemon (``--once``: .npy and .wav requests, mel and
DeepSpeech, ``--static``, a bad request).

Tolerances: float32 on both sides, the plain path against the JAX
server's XLA path (``use_pallas=False``): 1e-5.  Served frames are JPEGs
of uint8 values that both daemons truncate alike: a level apart at most
where a float32 value sits at a boundary (``FRAME_MAX``), and
``FRAME_MEAN`` on average.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.core import checkpoint as jckpt
from speech2lip_tpu.core.config import default_config
from speech2lip_tpu.data.synthetic import synthetic_batch
from speech2lip_tpu.infer import pipeline as jpipe
from speech2lip_tpu.models import deepspeech as jds
from speech2lip_tpu_torch import config as tconfig
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.core import checkpoint as tckpt
from speech2lip_tpu_torch.data import image_io
from speech2lip_tpu_torch.data import synthetic as tsyn
from speech2lip_tpu_torch.infer import pipeline as tpipe

torch.set_num_threads(2)

F32 = 1e-5
FRAME_MAX, FRAME_MEAN = 2 / 255, 1e-3


def _models(cfg, seed):
    from speech2lip_tpu.models import talking_face as jtf
    from speech2lip_tpu.models import unet_light as junet
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (jax.tree.map(np.asarray, jtf.init(k1, cfg)),
            *jax.tree.map(np.asarray, junet.init(k2)))


@pytest.fixture(scope="module")
def three():
    """Three identities (JAX inits carried over), two lip offsets."""
    face, lip = 64, 32
    cfg = default_config()
    cfg["model"]["canonical_depth_height"] = face
    cfg["model"]["canonical_depth_width"] = face
    cfg["data"]["height"] = cfg["data"]["width"] = lip
    sets = [_models(cfg, s) for s in range(3)]
    _, geo = synthetic_batch(2, face=face, lip_h=lip, lip_w=lip)
    positions = [(geo["lip_x"], geo["lip_y"]),
                 (geo["lip_x"] - 2, geo["lip_y"] + 1),
                 (geo["lip_x"], geo["lip_y"])]
    jsrv = jpipe.MultiSpeakerServer(cfg, sets, positions, use_pallas=False)
    tsrv = tpipe.MultiSpeakerServer(cfg, [weights.from_jax(*s) for s in sets],
                                    positions, device="cpu")
    return dict(cfg=cfg, face=face, lip=lip, sets=sets, positions=positions,
                jsrv=jsrv, tsrv=tsrv)


def _batches(three, bsz):
    raw, _ = synthetic_batch(bsz, face=three["face"], lip_h=three["lip"],
                             lip_w=three["lip"])
    out = []
    for s in range(3):
        b = {k: raw[k] for k in tpipe.RENDER_KEYS}
        b["audio"] = raw["audio"] + 0.1 * s   # distinct inputs per identity
        out.append(b)
    return out


def _close(t_out, j_out):
    for k in ("face", "lip"):
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                   rtol=F32, atol=F32)


@pytest.mark.parametrize("bsz", [2, 16])
def test_render_all_matches_jax(three, bsz):
    jsrv, tsrv = three["jsrv"], three["tsrv"]
    assert tsrv.groups == jsrv.groups and len(tsrv.groups) == 2
    assert tsrv.n_identities == 3 and not tsrv.use_kernels
    assert tsrv.compute_dtype == torch.float32
    batches = _batches(three, bsz)
    j_out = jsrv.render_all([jax.tree.map(jnp.asarray, b) for b in batches])
    t_out = tsrv.render_all([{k: torch.from_numpy(v) for k, v in b.items()}
                             for b in batches])
    for i in range(3):
        _close(t_out[i], j_out[i])
    assert not np.allclose(t_out[0]["face"], t_out[2]["face"])
    with pytest.raises(ValueError, match="need 3 batches"):
        tsrv.render_all(batches[:2])


def test_render_and_render_fast_match_jax(three):
    """The port's one ``render`` is both of the JAX server's routes,
    ``render`` and ``render_fast``."""
    b = _batches(three, 2)[1]
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jb = jax.tree.map(jnp.asarray, b)
    for i in (0, 1):
        got = three["tsrv"].render(i, tb)
        _close(got, three["jsrv"].render(i, jb))
        _close(got, three["jsrv"].render_fast(i, jb))
    assert three["tsrv"].param_shardings() == {
        off: torch.device("cpu") for off in three["jsrv"].groups}


def test_render_plain_is_the_plain_path_on_a_kernel_server(three):
    """A kernel server (float32 here, the wrappers' plain versions on the
    CPU): ``render_plain`` is the JAX server's XLA path on the same cast
    parameters, to 1e-5, and so is its kernel path."""
    ksrv = tpipe.MultiSpeakerServer(
        three["cfg"], [weights.from_jax(*s) for s in three["sets"]],
        three["positions"], device="cpu", use_kernels=True,
        compute_dtype=torch.float32)
    assert ksrv.use_kernels
    b = _batches(three, 2)[1]
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jb = jax.tree.map(jnp.asarray, b)
    for i in (0, 1):
        ref = three["jsrv"].render(i, jb)
        _close(ksrv.render_plain(i, tb), ref)
        _close(ksrv.render(i, tb), ref)


def test_server_refuses_mesh_and_plain_on_the_card(three, monkeypatch):
    """A mesh whose data axis does not split an offset group is refused,
    as the JAX server's sharding refuses it; a mesh of one rank serves
    every identity; the card serves no plain path."""
    from speech2lip_tpu_torch.parallel.mesh import Mesh, make_mesh
    every = [weights.from_jax(*s) for s in three["sets"]]
    with pytest.raises(ValueError, match="multiples of the data axis"):
        tpipe.MultiSpeakerServer(three["cfg"], every,
                                 [three["positions"][0]] * 3, device="cpu",
                                 mesh=Mesh(2, 1, 0, torch.device("cpu")))
    one = tpipe.MultiSpeakerServer(three["cfg"], every, three["positions"],
                                   device="cpu", mesh=make_mesh())
    assert sorted(one.served) == [0, 1, 2]
    sets = every[:1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.MultiSpeakerServer(three["cfg"], sets, three["positions"][:1])


def test_new_audio_frames_matches_jax(tmp_path):
    from speech2lip_tpu.data.dataset import LipDataset as JLipDataset
    from speech2lip_tpu.train.train_step import TrainState as JState
    from speech2lip_tpu_torch.data.dataset import LipDataset
    from speech2lip_tpu_torch.train.train_step import TrainState

    root = str(tmp_path / "tree")
    geo = tsyn.make_synthetic_tree(root, n_frames=8, face=64, lip_h=16,
                                   lip_w=24)
    cfg = tsyn.synthetic_config(root, geo)
    p, up, us = _models(cfg, 1)
    ds_j = jax.tree.map(np.asarray, jds.init(jax.random.PRNGKey(2),
                                             hidden=32))
    wav = (np.random.default_rng(0).standard_normal(12000) * 0.1).astype(
        np.float32)
    ref = list(jpipe.new_audio_frames(
        cfg, JState(p, up, us, None, jnp.int32(0)),
        JLipDataset(root, "test", cfg), ds_j, wav, 16000, batch=4))
    got = list(tpipe.new_audio_frames(
        cfg, TrainState(*weights.from_jax(p, up, us), None, 0),
        LipDataset(root, "test", cfg), weights.deepspeech_from_jax(ds_j),
        wav, 16000, batch=4, device="cpu"))
    assert [g.shape for g in got] == [r.shape for r in ref]
    assert sum(g.shape[0] for g in got) == 19   # 0.75 s at 25 fps
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=F32, atol=F32)


def _identity(tmp_path, name, seed, out_dir, mel=False):
    """A synthetic identity tree and its config written by the port,
    whose checkpoint (written by the port, seeded parameters) is in
    ``out_dir`` unless one is there already."""
    root = str(tmp_path / name)
    geo = tsyn.make_learnable_tree(root, n_frames=10, face=64, lip_h=16,
                                   lip_w=24, seed=seed)
    cfg = tsyn.synthetic_config(root, geo)
    cfg["model"]["use_audio_mel"] = mel
    cfg["training"]["out_dir"] = out_dir
    if not os.path.exists(os.path.join(out_dir, "model.ckpt")):
        p, up, us = weights.random_params(seed, cfg=cfg)
        tckpt.CheckpointManager(out_dir).save_latest(
            {"params": p, "unet_params": up, "unet_state": us, "it": 0},
            it=0)
    path = str(tmp_path / f"{name}.yaml")
    tconfig.save_config(path, cfg)
    return path


def _queue(tmp_path, name, requests):
    q = tmp_path / name
    q.mkdir()
    for fname, make in requests.items():
        make(str(q / fname))
    return str(q)


def _served(out):
    """{request: frame names}, and the .done / .err files, of an output
    directory."""
    files = sorted(os.listdir(out))
    reqs = {f: sorted(os.listdir(os.path.join(out, f))) for f in files
            if os.path.isdir(os.path.join(out, f))}
    return reqs, [f for f in files if f.endswith((".done", ".err"))]


def test_cli_serve_once_matches_jax(tmp_path, monkeypatch):
    from scipy.io import wavfile

    from speech2lip_tpu.cli import serve as jserve
    from speech2lip_tpu_torch.cli import serve as tserve

    shared = str(tmp_path / "shared_out")
    cfgs = [_identity(tmp_path, "id0", 0, shared),
            _identity(tmp_path, "id1", 1, shared)]
    mel_cfg = _identity(tmp_path, "idm", 2, str(tmp_path / "mel_out"),
                        mel=True)
    ds_path = str(tmp_path / "deepspeech.ckpt")
    jckpt.save(ds_path, jds.init(jax.random.PRNGKey(3), hidden=32))
    rng = np.random.default_rng(0)

    def npy(n):
        a = rng.standard_normal((n, 16, 29)).astype(np.float32)
        return lambda p: np.save(p, a)

    def wav(n):
        a = (0.2 * rng.standard_normal(n)).astype(np.float32)
        return lambda p: wavfile.write(p, 16000, a)

    runs = [("ds", cfgs, {"0__reqA.npy": npy(5), "1__reqB.npy": npy(3),
                          "7__reqBad.npy": npy(2), "1__reqW.wav": wav(6400)},
             ["--deepspeech", ds_path]),
            ("mel", [mel_cfg], {"0__reqM.wav": wav(8000)}, [])]
    for name, paths, requests, extra in runs:
        for static in ([], ["--static"]):
            tag = name + "".join(static)
            q = {who: _queue(tmp_path, f"q_{tag}_{who}", requests)
                 for who in ("jax", "port")}
            outs = {who: str(tmp_path / f"o_{tag}_{who}")
                    for who in ("jax", "port")}
            flags = ["--batch", "4", "--once", *extra, *static]
            monkeypatch.setattr(sys, "argv", [
                "serve", *paths, "--queue", q["jax"], "--out", outs["jax"],
                *flags])
            jserve.main()
            res = tserve.main([*paths, "--queue", q["port"], "--out",
                               outs["port"], "--device", "cpu", *flags])
            want, marks = _served(outs["jax"])
            assert _served(outs["port"]) == (want, marks), tag
            assert not os.listdir(q["port"]) and not os.listdir(q["jax"])
            assert sorted(res["done"]) == sorted(want) and \
                res["frames"] == sum(map(len, want.values()))
            if name == "ds":
                assert res["err"] == ["reqBad"] and "reqBad.err" in marks
                assert len(want["reqA"]) == 5 and len(want["reqW"]) == 10
            for req, frames in want.items():
                assert open(os.path.join(outs["port"], req + ".done")).read() \
                    == str(len(frames))
                for f in frames:
                    a, b = (image_io.imread_float(os.path.join(outs[w], req, f))
                            for w in ("jax", "port"))
                    assert a.shape == (64, 64, 3)
                    d = np.abs(a - b)
                    assert d.max() <= FRAME_MAX and d.mean() < FRAME_MEAN, \
                        (tag, req, f, d.max(), d.mean())
    shutil.rmtree(shared)


def test_cli_serve_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``--device`` the daemon asks for the card and raises where
    there is none: no silent CPU run."""
    from speech2lip_tpu_torch.cli import serve as tserve

    path = _identity(tmp_path, "id0", 0, str(tmp_path / "out"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main([path, "--queue", str(tmp_path), "--out",
                     str(tmp_path / "o"), "--once"])


@pytest.mark.parametrize("static", [False, True])
def test_bench_serving_runs_at_a_cpu_size(static):
    from speech2lip_tpu_torch.tools import bench_serving

    rec = bench_serving.run(bench_serving.parse(
        ["--identities", "2", "--face", "64", "--lip-h", "16", "--lip-w",
         "24", "--batch", "2", "--rounds", "2", "--device", "cpu"]
        + (["--static"] if static else [])))
    assert rec["finite"] and rec["out_shape"] == [2, 64, 64, 3]
    assert rec["device"] == "cpu" and rec["value"] > 0
    assert rec["path"] == ("static-window" if static else "plain")
