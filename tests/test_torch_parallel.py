"""The port's data axis (speech2lip_tpu_torch.parallel, the mesh-aware
step, ``fit``, ``MultiSpeakerServer(mesh=)`` and the tracker's frame
sharding) against the JAX package's mesh, on the CPU.

The port's ranks are gloo processes spawned by ``tests/torch_ranks.py``
(torch only; they meet through a file under ``tmp_path``); the JAX side
runs on a mesh of this session's eight virtual CPU devices
(``tests/conftest.py``).  Bounds, relative to the largest reference
magnitude unless said otherwise:

- the train step against JAX's ``(2, 1)``-mesh step: 1e-4 on the loss
  terms and ``grad_norm``, 1e-5 on the BatchNorm state (those of
  tests/test_torch_train.py's one-device step); the new parameters:
  fewer than 0.1% of the elements off by more than 2% of an Adam step
  (the first Adam step is lr * g / (|g| + eps), so an element whose
  gradient is at noise level moves by what the last float32 bits say,
  up to a flip of the whole step);
- two ranks against the port's one-process step on the global batch:
  1e-5 on the BatchNorm state, 1e-5 of max(1, |value|) on the metrics,
  ``grad_norm`` included (float32 sums in another order; measured
  1.6e-6 on ``grad_norm``);
- ``fit`` on two ranks against one rank on the global batch: 1e-5 of
  max(1, |value|) at the first iteration, 1e-3 after it (Adam's first
  step moves a noise-level gradient element by a whole lr), and the
  final parameters within 2.5 lr;
- the server: 1e-5, as tests/test_serving.py's identity-sharded test;
- the tracker's photometric term and gradients: 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.core.config import default_config as jdefault_config
from speech2lip_tpu.data import synthetic as jsyn
from speech2lip_tpu.data.synthetic import synthetic_batch
from speech2lip_tpu.models import talking_face as jtf
from speech2lip_tpu.parallel.mesh import make_mesh as jmake_mesh
from speech2lip_tpu.parallel.mesh import replicate as jreplicate
from speech2lip_tpu.parallel.mesh import shard_batch as jshard_batch
from speech2lip_tpu.train import train_step as jts
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.parallel import mesh as tmesh
from speech2lip_tpu_torch.train import train_step as tts
from test_torch_kernels import unet_params
from test_torch_train import (_jax_draws, _jax_leaves,
                              _key_with_blackaug_applied)
from torch_ranks import run_ranks
import torch_ranks

torch.set_num_threads(2)

FACE, LIP_H, LIP_W, B = 64, 16, 24, 4       # B: the global batch
LR = 1e-4


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))) / max(1e-6, float(np.max(
        np.abs(ref))))


# -- the mesh -------------------------------------------------------------------

def test_make_mesh_checks_its_shape():
    """data * pixel must be the world size, whatever the split; a mesh
    with a pixel axis is a mesh like any other (its ranks: the pixel
    axis tests, tests/test_torch_pixel_axis.py)."""
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "pixel": 1} and mesh.rank == 0
    assert (mesh.world, mesh.data_index, mesh.pixel_index) == (1, 0, 0)
    assert tmesh.make_mesh([1, 1]) == mesh
    for shape in ([2, 1], [1, 2], [2, 2]):
        with pytest.raises(ValueError, match="needs"):
            tmesh.make_mesh(shape)


def test_one_rank_collectives_return_their_input():
    x = torch.arange(6.0).reshape(2, 3)
    for mesh in (None, tmesh.make_mesh()):
        assert tmesh.all_sum(x, mesh) is x
        assert tmesh.sum_no_grad(x, mesh) is x
        assert tmesh.all_gather_rows(x, mesh) is x
        assert tmesh.mean_tensors([x], mesh)[0] is x
        assert tmesh.shard_batch({"a": x}, mesh)["a"] is x
        with tmesh.on_mesh(mesh):
            assert tmesh.active() is None


def test_draws_split_the_global_batch():
    """Each rank keeps its rows of the global batch's draws: the union
    over the ranks is the one-process draw of the global batch."""
    st = tts.StepStatics(lip_h=4, lip_w=6, lip_x=0, lip_y=0, face_h=8,
                         face_w=8, focal=10.0, add_noise_uv=True,
                         add_noise_audio=True, sync_on=True)
    one = tts.draw_noise(st, 4, generator=torch.Generator().manual_seed(3))
    parts = [tts.draw_noise(st, 2, generator=torch.Generator().manual_seed(3),
                            mesh=tmesh.Mesh(2, 1, r, torch.device("cpu")))
             for r in range(2)]
    for k in ("hole1", "hole2"):
        assert torch.equal(torch.cat([p[k] for p in parts]), one[k])
    for k in ("lip", "sync_lip"):
        for kk in ("eps_u", "audio"):
            assert torch.equal(torch.cat([p[k][kk] for p in parts]),
                               one[k][kk])
        assert all(torch.equal(p[k]["uv"], one[k]["uv"]) for p in parts)
    assert all(torch.equal(p["apply_u"], one["apply_u"]) for p in parts)
    chunk = [tts.draw_chunk_noise(3, 2, generator=torch.Generator()
                                  .manual_seed(4),
                                  mesh=tmesh.Mesh(2, 1, r, torch.device("cpu")))
             for r in range(2)]
    ref = tts.draw_chunk_noise(3, 4, generator=torch.Generator().manual_seed(4))
    assert torch.equal(torch.cat([c["eps_u"] for c in chunk], 1),
                       ref["eps_u"])


# -- the train step ---------------------------------------------------------------

@pytest.fixture(scope="module")
def step_case():
    """Parameters, a global batch of 4 frames, the JAX step's draws and
    statics: the U-Net in train-mode BatchNorm, the black-hole
    augmentation on, the local ensemble on, and the canonical-depth loss
    on its full-frame masked path with masks that differ per frame (the
    second rank's frames hold half the support), so per-rank BatchNorm
    statistics or per-rank mask denominators give another function."""
    raw, geo = synthetic_batch(B, face=FACE, lip_h=LIP_H, lip_w=LIP_W, seed=2)
    raw["mask_head_canonical"][2:, :FACE // 2] = 0.0
    rng = np.random.default_rng(11)
    cfg = jdefault_config()
    cfg["model"]["canonical_depth_height"] = FACE
    cfg["model"]["canonical_depth_width"] = FACE
    jp = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(1), cfg))
    jp["canonical_depth"] = rng.uniform(0.8, 1.2, (FACE, FACE)).astype(
        np.float32)
    jup, jus = unet_params(16, seed=3)
    kw = dict(lip_h=LIP_H, lip_w=LIP_W, lip_x=geo["lip_x"],
              lip_y=geo["lip_y"], face_h=FACE, face_w=FACE,
              focal=geo["focal"], use_perceptual=False)
    jst = jts.StepStatics(**kw)
    key = _key_with_blackaug_applied()
    draws = jax.tree.map(lambda t: t.numpy(), _jax_draws(key, jst, B))
    return dict(raw=raw, kw=kw, jst=jst, key=key, draws=draws,
                jax=(jp, jup, jus), port=weights.from_jax(jp, jup, jus))


@pytest.fixture(scope="module")
def jax_mesh_step(step_case):
    """JAX's train step on a (2, 1) mesh: the global batch over 'data'."""
    c = step_case
    jp, jup, jus = c["jax"]
    opt = jts.make_optimizer(dict(jdefault_config(), training=dict(
        jdefault_config()["training"], learning_rate=LR)))
    state = jts.TrainState(jp, jup, jus, opt.init({"model": jp, "unet": jup}),
                           jnp.asarray(0, jnp.int32))
    mesh = jmake_mesh((2, 1))
    new, metrics = jts.make_train_step(opt, c["jst"], {}, donate=False)(
        jreplicate(state, mesh), jshard_batch(c["raw"], mesh), c["key"])
    return (jax.tree.map(np.asarray, new),
            {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def port_ranks(step_case, tmp_path_factory):
    """The port's step on two gloo ranks, each on its rows."""
    c = step_case
    args = (c["kw"], *[torch_ranks._numpy(t) for t in c["port"]], {},
            c["raw"], c["draws"], LR)
    return run_ranks(torch_ranks.train_step, 2,
                     tmp_path_factory.mktemp("step"), *args)


def test_two_rank_step_matches_jax_mesh_step(step_case, jax_mesh_step,
                                             port_ranks):
    jnew, jm = jax_mesh_step
    r0, r1 = port_ranks
    # every rank ends the step with the same state and metrics
    for a, b in zip(tts.tree_leaves(r0["params"]) + tts.tree_leaves(
            r0["unet"]) + tts.tree_leaves(r0["state"]),
            tts.tree_leaves(r1["params"]) + tts.tree_leaves(r1["unet"])
            + tts.tree_leaves(r1["state"])):
        assert np.array_equal(a, b)
    assert r0["metrics"] == r1["metrics"]
    m = r0["metrics"]
    assert set(m) == set(jm), (sorted(m), sorted(jm))
    for k, ref in jm.items():
        assert abs(m[k] - ref) <= 1e-4 * max(abs(ref), 1e-3), (k, m[k], ref)
    # train-mode BatchNorm: the running statistics of the global batch
    for a, r in zip(tts.tree_leaves(r0["state"]),
                    _jax_leaves(jnew.unet_state, r0["state"])):
        assert _rel(a, r) < 1e-5
    # Adam's first step, model and U-Net
    d = np.concatenate([
        np.abs(a - r).ravel() / LR
        for a, r in zip(tts.tree_leaves(r0["params"]) + tts.tree_leaves(
            r0["unet"]), _jax_leaves(jnew.params, r0["params"])
            + _jax_leaves(jnew.unet_params, r0["unet"]))])
    # (measured: 0.02% of the elements off by more than 2% of a step, the
    # worst by 1.26 steps, a noise-level gradient whose sign flipped)
    assert d.max() <= 2.0 and (d > 0.02).mean() < 1e-3, (d.max(),
                                                          (d > 0.02).mean())


def test_two_ranks_are_the_one_process_step_on_the_global_batch(
        step_case, port_ranks):
    """The two ranks' step against the port's own step on the global
    batch in one process: the same gradients (through grad_norm and the
    U-Net's BatchNorm state, which every gradient leaf feeds) and
    metrics, to float32 summation order."""
    c = step_case
    one = torch_ranks.train_step(
        c["kw"], *[torch_ranks._numpy(t) for t in c["port"]], {}, c["raw"],
        c["draws"], LR, mesh_on=False)
    m = port_ranks[0]["metrics"]
    for k, ref in one["metrics"].items():
        assert abs(m[k] - ref) <= 1e-5 * max(abs(ref), 1.0), (k, m[k], ref)
    for a, r in zip(tts.tree_leaves(port_ranks[0]["state"]),
                    tts.tree_leaves(one["state"])):
        assert _rel(a, r) < 1e-5


# -- fit ---------------------------------------------------------------------------

def test_two_rank_fit_equals_one_rank_fit(tmp_path):
    """Two gloo ranks of ``fit`` at batch 2 a rank against one rank at
    batch 4, from one seed, the step's draws off: per iteration the same
    metrics.jsonl values, and the same final checkpoint."""
    from speech2lip_tpu_torch.core import checkpoint as tckpt
    from speech2lip_tpu_torch.data import synthetic as tsyn

    root = str(tmp_path / "tree")
    cfg = tsyn.synthetic_config(root, tsyn.make_synthetic_tree(
        root, n_frames=12, face=48, lip_h=16, lip_w=24))
    cfg["model"]["use_post_fusion_blackaug"] = False
    cfg["parallel"]["mesh_shape"] = None
    cfg["training"].update(
        print_every=1, checkpoint_every=0, backup_every=0, validate_every=0,
        visualize_every=0, use_local_ensemble=False, add_noise_uv=False,
        add_noise_audio=False, use_syncloss=False,
        use_perceptual_loss=False)
    cfgs = {n: json.loads(json.dumps(dict(cfg, training=dict(
        cfg["training"], batch_size=4 // n, out_dir=str(tmp_path / f"w{n}")))))
        for n in (1, 2)}
    one = torch_ranks.fit(cfgs[1], 2)
    two = run_ranks(torch_ranks.fit, 2, tmp_path, cfgs[2], 2)
    assert one["it"] == two[0]["it"] == two[1]["it"] == 2
    recs = {}
    for n in (1, 2):
        recs[n] = [json.loads(line) for line in open(
            tmp_path / f"w{n}" / "metrics.jsonl")]
    assert [r["it"] for r in recs[1]] == [r["it"] for r in recs[2]] == [1, 2]
    for a, b in zip(recs[1], recs[2]):
        # iteration 1 from the same parameters; iteration 2 after Adam's
        # first step, which moves a noise-level gradient element by a whole
        # lr whatever its last bits (measured on this case up to 6e-5 on
        # grad_norm; chip_smoke.py phase 11c holds the card to the same
        # bounds, its first iteration against a float64 fit)
        bound = 1e-5 if a["it"] == 1 else 1e-3
        for k in ("train/loss", "train/loss_rgb", "train/psnr",
                  "train/grad_norm", "train/loss_canonical_depth_photo"):
            assert abs(a[k] - b[k]) <= bound * max(1.0, abs(a[k])), (
                k, a[k], b[k])
    flat = {n: tckpt.load(str(tmp_path / f"w{n}" / "model.ckpt"))
            for n in (1, 2)}
    assert flat[1][1] == flat[2][1]            # it, epoch_it, best
    assert set(flat[1][0]) == set(flat[2][0])
    for k, v in flat[1][0].items():
        if k.startswith("opt_state") and "count" in k:
            assert np.array_equal(v, flat[2][0][k]), k
        elif k.startswith(("params", "unet")):
            scale = max(1e-6, float(np.abs(v).max()))
            # Adam's two steps move an element by up to 2 lr; noise-level
            # gradients set the last part of that
            assert float(np.abs(v - flat[2][0][k]).max()) <= max(
                1e-5 * scale, 2.5 * cfg["training"]["learning_rate"]), k
    log = open(tmp_path / "w2" / "train.log").read()
    assert "mesh data=2 rank=0" in log and "global batch 4" in log


# -- serving -----------------------------------------------------------------------

def test_two_rank_server_matches_jax_identity_sharded_server(tmp_path):
    """Four identities at one offset over two ranks (each rank serves
    two) against the JAX server with its identity axis over a (2, 1)
    mesh (tests/test_serving.py's setup)."""
    from speech2lip_tpu.infer.pipeline import MultiSpeakerServer
    from speech2lip_tpu.models import unet_light

    face, lip = 32, 16
    cfg = jdefault_config()
    cfg["model"]["canonical_depth_height"] = face
    cfg["model"]["canonical_depth_width"] = face
    cfg["data"]["height"] = cfg["data"]["width"] = lip
    sets = []
    for s in range(4):
        k1, k2 = jax.random.split(jax.random.PRNGKey(s))
        sets.append(jax.tree.map(np.asarray, (jtf.init(k1, cfg),
                                              *unet_light.init(k2))))
    batch0, geo = synthetic_batch(2, face=face, lip_h=lip, lip_w=lip)
    keys = ("audio", "index", "rgb_face_zero", "rgb_face_ori",
            "mask_lip_canonical", "coord")
    batches = [dict({k: batch0[k] for k in keys},
                    audio=batch0["audio"] + 0.1 * s) for s in range(4)]
    positions = [(geo["lip_x"], geo["lip_y"])] * 4
    srv = MultiSpeakerServer(cfg, sets, positions, use_pallas=False,
                             mesh=jmake_mesh((2, 1)))
    ref = srv.render_all([jax.tree.map(jnp.asarray, b) for b in batches])
    got = run_ranks(torch_ranks.serve, 2, tmp_path, cfg, sets, positions,
                    batches)
    assert got[0]["served"] == [0, 1] and got[1]["served"] == [2, 3]
    for r in got:
        for i in range(4):
            np.testing.assert_allclose(r["faces"][i],
                                       np.asarray(ref[i]["face"]),
                                       rtol=1e-5, atol=1e-5)


def test_server_groups_must_split_over_the_ranks():
    cfg = jdefault_config()
    cfg["data"]["height"] = cfg["data"]["width"] = 16
    from speech2lip_tpu_torch.infer.pipeline import MultiSpeakerServer
    sets = [weights.random_params(s, cfg=dict(cfg, model=dict(
        cfg["model"], canonical_depth_height=32,
        canonical_depth_width=32))) for s in range(3)]
    mesh = tmesh.Mesh(2, 1, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="multiples of the data axis"):
        MultiSpeakerServer(cfg, sets, [(4, 4)] * 3, device="cpu", mesh=mesh)
    srv = MultiSpeakerServer(cfg, sets, [(4, 4), (4, 4), (2, 2)],
                             device="cpu", mesh=mesh)
    # rank 1 of 2: the second of a group of two, and the single identity
    assert srv.served == [1, 2]


# -- the tracker --------------------------------------------------------------------

def test_two_rank_tracker_photometric_term_matches_jax(tmp_path):
    """The photometric term of 5 frames of a rendered world (padded to 6:
    one repeat of weight 0 on the second rank) and its gradients with
    respect to the projected vertices and their colours: two gloo ranks
    against the JAX tracker's ``shard_map`` on a (2, 1) mesh."""
    from speech2lip_tpu.preprocess import face_3dmm as jbfm
    from speech2lip_tpu.preprocess.tracker import FaceTracker as JTracker
    from speech2lip_tpu.preprocess.tracker import TrackerConfig as JCfg
    from speech2lip_tpu_torch.preprocess import face_3dmm as tbfm
    from speech2lip_tpu_torch.preprocess import synthetic_world as sw
    from speech2lip_tpu_torch.preprocess.tracker import FaceTracker

    n, size, focal = 5, 48, 60.0
    dims = dict(n_verts=150, id_dim=6, exp_dim=4, tex_dim=6, seed=1)
    ta = tbfm.synthetic_assets(**dims)
    truth = sw.true_params(ta, n)
    imgs, lms = sw.render_world(ta, truth, size, focal)
    cfg_kw = dict(img_h=size, img_w=size, photo_chunk=2)
    t = lambda k: torch.from_numpy(np.asarray(truth[k], np.float32))
    tr = FaceTracker(ta, lms, torch_ranks.tracker_cfg(cfg_kw, dims))
    rng = np.random.default_rng(4)
    tex = torch.from_numpy((0.3 * rng.standard_normal((1, 6))).astype(
        np.float32))
    light = torch.from_numpy((0.1 * rng.standard_normal((n, 27))).astype(
        np.float32))
    with torch.no_grad():
        pix, colors = tr._pix_colors(t("id"), tbfm.forward_tex(ta, tex),
                                     t("exp"), t("euler"), t("trans"),
                                     light, focal)
    pix, colors = pix.numpy(), colors.numpy()
    imgs = np.asarray(imgs, np.float32)
    jt = JTracker(jbfm.synthetic_assets(**dims), lms,
                  JCfg(**torch_ranks.tracker_cfg_kw(cfg_kw, dims)),
                  mesh=jmake_mesh((2, 1)))
    aux = jt._aux_assets()
    imgs_j = jnp.asarray(imgs)
    loss_fn = jax.jit(lambda p, c: jt._chunked_col_loss(p, c, imgs_j, aux))
    ref, (gp, gc) = jax.value_and_grad(loss_fn, argnums=(0, 1))(pix, colors)
    got = run_ranks(torch_ranks.tracker_col_loss, 2, tmp_path, dims, lms,
                    cfg_kw, pix, colors, imgs)
    for loss, (tp, tc) in got:
        assert abs(loss - float(ref)) <= 1e-5 * abs(float(ref))
        assert _rel(tp, gp) < 1e-5 and _rel(tc, gc) < 1e-5
    assert got[0][0] == got[1][0]


def test_cli_train_on_two_ranks_through_the_launcher(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    speech2lip_tpu_torch.cli.train cfg.yaml --device cpu``: the ranks join
    a gloo group from the launcher's variables, rank 0 writes the log and
    the metrics, and the checkpoint is the sharded format when asked."""
    from speech2lip_tpu_torch import config as tconfig
    from speech2lip_tpu_torch.data import synthetic as tsyn
    from speech2lip_tpu_torch.parallel.distributed import launch

    root = str(tmp_path / "tree")
    cfg = tsyn.synthetic_config(root, tsyn.make_synthetic_tree(
        root, n_frames=10, face=48, lip_h=16, lip_w=24))
    cfg["training"].update(out_dir=str(tmp_path / "out"), batch_size=1,
                           print_every=1, checkpoint_every=1,
                           backup_every=0, validate_every=0,
                           visualize_every=0, use_syncloss=False,
                           sharded_ckpt=True)
    path = str(tmp_path / "cfg.yaml")
    tconfig.save_config(path, cfg)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    launch(2, "speech2lip_tpu_torch.cli.train",
           [path, "--max-iters", "2", "--device", "cpu"], cwd=repo,
           env=dict(os.environ, OMP_NUM_THREADS="1"))
    out = tmp_path / "out"
    ck = out / "model.ckpt"
    assert sorted(os.listdir(ck)) == ["index-p0.json", "index-p1.json",
                                      "meta.json", "shards-p0.npz",
                                      "shards-p1.npz"]
    assert json.load(open(ck / "meta.json"))["scalars"]["it"] == 2
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["it"] for r in recs] == [1, 2]
    assert "mesh data=2 rank=0" in open(out / "train.log").read()
