"""The port's pixel axis (a frame's rows over the ranks of a ``(data,
pixel)`` mesh: ``parallel.mesh`` bands, halos and gathers, the band U-Net,
the mesh step, ``fit`` from a YAML ``mesh_shape``) against the JAX
package's pixel-sharded mesh, on the CPU.

The port's ranks are gloo processes spawned by ``tests/torch_ranks.py``
(torch only); the JAX side runs on a mesh of the test run's eight virtual
CPU devices (``tests/conftest.py``), where ``make_train_step(mesh=)``
puts the ``pixel_sharded`` constraint on the U-Net's input.  Bounds:

- the step on a ``(2, 2)`` mesh against JAX's step under ``make_mesh((2,
  2))``: those of ``test_torch_parallel.py::
  test_two_rank_step_matches_jax_mesh_step`` (1e-4 of max(|ref|, 1e-3)
  on each loss term and ``grad_norm``, 1e-5 relative on the BatchNorm
  state, fewer than 0.1% of the new parameters off by more than 2% of an
  Adam step and none by more than 2 steps); against the port's
  one-process step on the global batch, 1e-5 of max(1, |value|) and 1e-5
  relative on the BatchNorm state;
- the band U-Net at uneven bands (24/20/20 rows of 64 over a ``(1, 3)``
  mesh) against JAX ``unet_light.apply`` and ``jax.grad``: 1e-5 relative
  to the largest reference magnitude, float32;
- ``fit`` on a ``(1, 2)`` mesh read from a YAML against one-process
  ``fit``: those of ``test_two_rank_fit_equals_one_rank_fit``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.core.config import default_config as jdefault_config
from speech2lip_tpu.models import unet_light as junet
from speech2lip_tpu.parallel.mesh import make_mesh as jmake_mesh
from speech2lip_tpu.parallel.mesh import replicate as jreplicate
from speech2lip_tpu.parallel.mesh import shard_batch as jshard_batch
from speech2lip_tpu.train import train_step as jts
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.parallel import mesh as tmesh
from speech2lip_tpu_torch.train import train_step as tts
from test_torch_kernels import unet_params
from test_torch_parallel import LR, _rel, step_case  # noqa: F401
from test_torch_train import _jax_leaves
from torch_ranks import run_ranks
import torch_ranks

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _mesh(data, pixel, rank):
    return tmesh.Mesh(data, pixel, rank, CPU)


# -- the band split and the mesh's indices (no group) -------------------------

def test_band_rows_split_quarter_rows():
    assert tmesh.band_rows(500, 2) == (252, 248)
    assert tmesh.band_rows(500, 4) == (128, 124, 124, 124)
    assert tmesh.band_rows(64, 3) == (24, 20, 20)
    assert tmesh.band_rows(64, 1) == (64,)
    assert tmesh.band_rows(8, 2) == (4, 4)
    with pytest.raises(ValueError, match="multiple of 4"):
        tmesh.band_rows(250, 2)
    with pytest.raises(ValueError, match="fewer than"):
        tmesh.band_rows(8, 3)
    band = tmesh.Band(_mesh(1, 4, 2), tmesh.band_rows(500, 4))
    assert (band.start, band.stop, band.height) == (252, 376, 500)
    assert band.half().rows == (64, 62, 62, 62)
    assert band.half().half().rows == (32, 31, 31, 31)


@pytest.mark.parametrize("height,pixel", [(500, 2), (500, 4), (64, 3),
                                          (52, 2)])
def test_band_upsample_reads_one_halo_row(height, pixel):
    """At both of the U-Net's upsamples, each band's output rows of the
    align-corners matrix read the band's input rows and one row past each
    edge, and the band matrix times the haloed band is the frame's
    upsample's rows."""
    rng = np.random.default_rng(0)
    rows = tmesh.band_rows(height, pixel)
    for level in (2, 1):
        h = height >> level
        x = torch.from_numpy(rng.standard_normal((1, h, 3, 2)).astype(
            np.float32))
        full = tnn.upsample_bilinear(x, 2 * h, 3)
        padded = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
        start = 0
        for r in rows:
            r >>= level
            m = tnn._band_matrix(2 * h, h, start, start + r)
            y = torch.einsum("oh,bhwc->bowc", m,
                             padded[:, start:start + r + 2])
            y = torch.einsum("pw,bowc->bopc",
                             tnn._align_corners_matrix(3, 3, torch.float32),
                             y)
            np.testing.assert_allclose(
                y.numpy(), full[:, 2 * start:2 * (start + r)].numpy(),
                rtol=1e-6, atol=1e-6)
            start += r


def test_mesh_indices_rows_and_draws_follow_the_data_index():
    """Ranks lie on the mesh as the JAX mesh lays out devices; a rank's
    rows of the batch and of the step's draws are its data index's, the
    same for every pixel rank; a hand-built mesh takes no collective over
    an axis that needs a group."""
    for r in range(4):
        m = _mesh(2, 2, r)
        assert (m.world, m.data_index, m.pixel_index) == (4, r // 2, r % 2)
        assert tmesh.local_rows(6, m) == slice(3 * (r // 2),
                                               3 * (r // 2) + 3)
        assert tmesh.local_rows(6, _mesh(1, 2, r % 2)) == slice(0, 6)
    st = tts.StepStatics(lip_h=4, lip_w=6, lip_x=0, lip_y=0, face_h=8,
                         face_w=8, focal=10.0, add_noise_audio=True)

    def draws(n, mesh):
        return tts.draw_noise(st, n, generator=torch.Generator()
                              .manual_seed(5), mesh=mesh)

    whole = draws(4, None)
    for r in range(2):
        got = draws(4, _mesh(1, 2, r))
        assert torch.equal(got["hole1"], whole["hole1"])
        assert torch.equal(got["lip"]["audio"], whole["lip"]["audio"])
    for r in range(4):
        got = draws(2, _mesh(2, 2, r))
        ref = draws(2, _mesh(2, 1, r // 2))
        for k in ("hole1", "hole2", "apply_u"):
            assert torch.equal(got[k], ref[k])
        assert torch.equal(got["lip"]["eps_u"], ref["lip"]["eps_u"])
    batch = {"a": torch.arange(8.0).reshape(4, 2)}
    assert torch.equal(tmesh.shard_batch(batch, _mesh(2, 2, 3))["a"],
                       batch["a"][2:])
    x = torch.ones(3)
    with pytest.raises(ValueError, match="built by hand"):
        tmesh.sum_no_grad(x, _mesh(2, 2, 0), tmesh.PIXEL)
    assert tmesh.all_sum(x, _mesh(1, 2, 1), tmesh.DATA) is x
    assert tmesh.mean_tensors([x], _mesh(2, 1, 0), tmesh.PIXEL)[0] is x


def test_server_and_tracker_split_over_the_data_index():
    """``MultiSpeakerServer`` under hand-built meshes: on ``(1, 2)``
    every rank serves every identity, and renders what the server with no
    mesh renders; on ``(2, 2)`` each data index serves its block, the
    same on both its pixel ranks.  ``FaceTracker``: on ``(1, 2)`` the
    photometric term is the unsharded one; on ``(2, 2)`` a rank's frame
    block is its data index's."""
    from speech2lip_tpu_torch.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch.infer.pipeline import (RENDER_KEYS,
                                                     MultiSpeakerServer)
    from speech2lip_tpu_torch.preprocess import face_3dmm as tbfm
    from speech2lip_tpu_torch.preprocess import synthetic_world as sw
    from speech2lip_tpu_torch.preprocess.tracker import FaceTracker

    face, lip = 32, 16
    cfg = jdefault_config()
    cfg["model"]["canonical_depth_height"] = face
    cfg["model"]["canonical_depth_width"] = face
    cfg["data"]["height"] = cfg["data"]["width"] = lip
    sets = [weights.random_params(s, cfg=cfg) for s in range(4)]
    raw, geo = synthetic_batch(2, face=face, lip_h=lip, lip_w=lip)
    pos = [(geo["lip_x"], geo["lip_y"])] * 4
    batches = [{k: torch.from_numpy(np.asarray(raw[k])) for k in RENDER_KEYS}
               for _ in range(4)]
    for i, b in enumerate(batches):
        b["audio"] = b["audio"] + 0.1 * i
    ref = MultiSpeakerServer(cfg, sets, pos, device="cpu").render_all(
        batches)
    srv = MultiSpeakerServer(cfg, sets, pos, device="cpu",
                             mesh=_mesh(1, 2, 1))
    assert srv.served == [0, 1, 2, 3]
    for a, b in zip(srv.render_all(batches), ref):
        assert torch.equal(a["face"], b["face"])
    for r in range(4):
        srv = MultiSpeakerServer(cfg, sets, pos, device="cpu",
                                 mesh=_mesh(2, 2, r))
        assert srv.served == ([0, 1] if r < 2 else [2, 3])

    n, size, focal = 5, 48, 60.0
    dims = dict(n_verts=150, id_dim=6, exp_dim=4, tex_dim=6, seed=1)
    assets = tbfm.synthetic_assets(**dims)
    truth = sw.true_params(assets, n)
    imgs, lms = sw.render_world(assets, truth, size, focal)
    tcfg = torch_ranks.tracker_cfg(dict(img_h=size, img_w=size,
                                        photo_chunk=2), dims)
    plain = FaceTracker(assets, lms, tcfg)
    pixel = FaceTracker(assets, lms, tcfg, mesh=_mesh(1, 2, 1))
    assert pixel.mesh is None
    t = lambda k: torch.from_numpy(np.asarray(truth[k], np.float32))
    with torch.no_grad():
        pix, colors = plain._pix_colors(
            t("id"), tbfm.forward_tex(assets, torch.zeros(1, 6)), t("exp"),
            t("euler"), t("trans"), torch.zeros(n, 27), focal)
    imgs = torch.from_numpy(np.asarray(imgs, np.float32))
    assert torch.equal(pixel.col_loss(pix, colors, imgs),
                       plain.col_loss(pix, colors, imgs))
    for r in range(4):
        idx, w = FaceTracker(assets, lms, tcfg,
                             mesh=_mesh(2, 2, r)).frame_block(n)
        want = ([0, 1, 2], [1, 1, 1]) if r < 2 else ([3, 4, 0], [1, 1, 0])
        assert (idx.tolist(), w.tolist()) == want


# -- the band U-Net on three ranks --------------------------------------------

def test_band_unet_at_uneven_bands_matches_jax(tmp_path):
    """The train-mode U-Net on a ``(1, 3)`` mesh, 64 rows as bands of
    24/20/20 (12/10/10 and 6/5/5 below the pools): the gathered output,
    the BatchNorm running state and the gradients of sum(out * cot) with
    respect to the input and every parameter against JAX's ``apply`` and
    ``jax.grad`` on the whole frames."""
    jp, js = unet_params(8, seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 64, 24, 3)).astype(np.float32)
    cot = rng.standard_normal((2, 64, 24, 3)).astype(np.float32)

    def loss(p, xx):
        out, new = junet.apply(p, js, xx, train=True)
        return jnp.sum(out * cot), (out, new)

    (_, (out, new)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    got = run_ranks(torch_ranks.unet_bands, 3, tmp_path, [1, 3], jp, js, x,
                    cot)
    assert [g["rows"] for g in got] == [(24, 20, 20)] * 3
    for g in got:
        assert _rel(g["face"], out) < 1e-5
        for a, r in zip(tts.tree_leaves(g["state"]),
                        _jax_leaves(new, g["state"])):
            assert _rel(a, r) < 1e-5
        assert _rel(g["grad_x"], gx) < 1e-5
        for a, r in zip(g["grads"], _jax_leaves(gp, jp)):
            assert _rel(a, r) < 1e-5
    for a, b in zip(tts.tree_leaves(got[0]), tts.tree_leaves(got[2])):
        assert np.array_equal(a, b)


# -- the train step on a (2, 2) mesh ------------------------------------------

@pytest.fixture(scope="module")
def jax_pixel_step(step_case):
    """JAX's train step under ``make_mesh((2, 2))`` with ``mesh=``: the
    global batch over 'data' and the U-Net's input rows over 'pixel'."""
    c = step_case
    jp, jup, jus = c["jax"]
    opt = jts.make_optimizer(dict(jdefault_config(), training=dict(
        jdefault_config()["training"], learning_rate=LR)))
    state = jts.TrainState(jp, jup, jus, opt.init({"model": jp, "unet": jup}),
                           jnp.asarray(0, jnp.int32))
    mesh = jmake_mesh((2, 2))
    new, metrics = jts.make_train_step(opt, c["jst"], {}, donate=False,
                                       mesh=mesh)(
        jreplicate(state, mesh), jshard_batch(c["raw"], mesh), c["key"])
    return (jax.tree.map(np.asarray, new),
            {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def pixel_ranks(step_case, tmp_path_factory):
    """The port's step on a (2, 2) mesh of four gloo ranks."""
    c = step_case
    args = (c["kw"], *[torch_ranks._numpy(t) for t in c["port"]], {},
            c["raw"], c["draws"], LR, True, [2, 2])
    return run_ranks(torch_ranks.train_step, 4,
                     tmp_path_factory.mktemp("pixel_step"), *args)


def test_pixel_mesh_step_matches_jax_pixel_sharded_step(
        step_case, jax_pixel_step, pixel_ranks):
    jnew, jm = jax_pixel_step
    r0 = pixel_ranks[0]
    # every rank ends the step with the same state and metrics
    leaves = lambda r: (tts.tree_leaves(r["params"])
                        + tts.tree_leaves(r["unet"])
                        + tts.tree_leaves(r["state"]))
    for r in pixel_ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(leaves(r0),
                                                        leaves(r)))
        assert r["metrics"] == r0["metrics"]
    m = r0["metrics"]
    assert set(m) == set(jm), (sorted(m), sorted(jm))
    for k, ref in jm.items():
        assert abs(m[k] - ref) <= 1e-4 * max(abs(ref), 1e-3), (k, m[k], ref)
    for a, r in zip(tts.tree_leaves(r0["state"]),
                    _jax_leaves(jnew.unet_state, r0["state"])):
        assert _rel(a, r) < 1e-5
    d = np.concatenate([
        np.abs(a - r).ravel() / LR
        for a, r in zip(tts.tree_leaves(r0["params"]) + tts.tree_leaves(
            r0["unet"]), _jax_leaves(jnew.params, r0["params"])
            + _jax_leaves(jnew.unet_params, r0["unet"]))])
    assert d.max() <= 2.0 and (d > 0.02).mean() < 1e-3, (d.max(),
                                                          (d > 0.02).mean())


def test_pixel_mesh_step_is_the_one_process_step(step_case, pixel_ranks):
    """The (2, 2) step against the port's own step on the global batch in
    one process: the same metrics (``grad_norm`` among them) and U-Net
    BatchNorm state, to float32 summation order."""
    c = step_case
    one = torch_ranks.train_step(
        c["kw"], *[torch_ranks._numpy(t) for t in c["port"]], {}, c["raw"],
        c["draws"], LR, mesh_on=False)
    m = pixel_ranks[0]["metrics"]
    for k, ref in one["metrics"].items():
        assert abs(m[k] - ref) <= 1e-5 * max(abs(ref), 1.0), (k, m[k], ref)
    for a, r in zip(tts.tree_leaves(pixel_ranks[0]["state"]),
                    tts.tree_leaves(one["state"])):
        assert _rel(a, r) < 1e-5


# -- fit on a (1, 2) mesh from a YAML -----------------------------------------

def test_cli_train_on_a_pixel_mesh_from_yaml_equals_one_process_fit(
        tmp_path):
    """``cli/train`` on two gloo ranks through the launcher, the config
    written by ``save_config`` with ``parallel.mesh_shape: [1, 2]`` (a
    52-row face: bands of 28/24 rows), against ``fit`` in one process on
    the same batch: per iteration the same metrics.jsonl values, the same
    final parameters, and a sharded checkpoint whose ``meta.json`` names
    both processes."""
    from speech2lip_tpu_torch import config as tconfig
    from speech2lip_tpu_torch.core import checkpoint as tckpt
    from speech2lip_tpu_torch.data import synthetic as tsyn
    from speech2lip_tpu_torch.parallel.distributed import launch

    root = str(tmp_path / "tree")
    cfg = tsyn.synthetic_config(root, tsyn.make_synthetic_tree(
        root, n_frames=10, face=52, lip_h=16, lip_w=24))
    cfg["training"].update(
        batch_size=2, print_every=1, checkpoint_every=0, backup_every=0,
        validate_every=0, visualize_every=0, use_local_ensemble=False,
        add_noise_uv=False, add_noise_audio=False, use_syncloss=False,
        use_perceptual_loss=False)
    one = dict(cfg, training=dict(cfg["training"],
                                  out_dir=str(tmp_path / "one")))
    two = dict(cfg, training=dict(cfg["training"], sharded_ckpt=True,
                                  out_dir=str(tmp_path / "two")),
               parallel=dict(cfg["parallel"], mesh_shape=[1, 2]))
    path = str(tmp_path / "cfg.yaml")
    tconfig.save_config(path, two)
    assert "  mesh_shape:\n  - 1\n  - 2\n" in open(path).read()
    assert tconfig.load_config(path) == json.loads(json.dumps(two))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    launch(2, "speech2lip_tpu_torch.cli.train",
           [path, "--max-iters", "2", "--device", "cpu"], cwd=repo,
           env=dict(os.environ, OMP_NUM_THREADS="1"))
    torch_ranks.fit(json.loads(json.dumps(one)), 2)
    recs = {n: [json.loads(line) for line in open(
        tmp_path / n / "metrics.jsonl")] for n in ("one", "two")}
    assert [r["it"] for r in recs["one"]] == [r["it"] for r in recs["two"]]
    assert [r["it"] for r in recs["one"]] == [1, 2]
    for a, b in zip(recs["one"], recs["two"]):
        bound = 1e-5 if a["it"] == 1 else 1e-3
        for k in ("train/loss", "train/loss_rgb", "train/psnr",
                  "train/grad_norm", "train/loss_canonical_depth_photo"):
            assert abs(a[k] - b[k]) <= bound * max(1.0, abs(a[k])), (
                k, a[k], b[k])
    ck = tmp_path / "two" / "model.ckpt"
    meta = json.load(open(ck / "meta.json"))
    assert meta["processes"] == 2 and meta["scalars"]["it"] == 2
    dense, _ = tckpt.load(str(tmp_path / "one" / "model.ckpt"))
    with np.load(ck / "shards-p0.npz") as z:
        sharded = {k.rsplit("#", 1)[0]: z[k] for k in z.files}
    assert set(sharded) == set(dense)
    for k, v in dense.items():
        if k.startswith(("params", "unet")):
            scale = max(1e-6, float(np.abs(v).max()))
            assert float(np.abs(v - sharded[k]).max()) <= max(
                1e-5 * scale, 2.5 * cfg["training"]["learning_rate"]), k
    log = open(tmp_path / "two" / "train.log").read()
    assert "pixel=2 data_index=0 pixel_index=0" in log
    assert "global batch 2" in log
