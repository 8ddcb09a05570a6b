"""The port's 3DMM tracker (preprocess/tracker.py) against the JAX
package's, on the JAX tests' 6-frame world (synthetic assets, seeded poses
and expressions, true landmarks).

Tolerances: the losses within 1e-5 relative; phases a/b after 20 Adam
steps each within 1e-4 (float32 sums in another order, carried through
Adam's sign-like first steps); ``find_focal`` the same candidate; the
photometric losses of phases c and d and their gradients, evaluated once at
48^2 on the same parameters and frames, within 1e-5 relative.  The JAX
package marks a whole photometric fit slow, so the JAX side evaluates each
loss once (its ``fit`` closures rebuilt here from the same functions), and
a 2-step photometric ``fit`` runs on the port only.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.preprocess import face_3dmm as jb
from speech2lip_tpu.preprocess import tracker as jt
from speech2lip_tpu_torch.ops.rasterize import (Fragments,
                                                interpolate_attributes,
                                                rasterize,
                                                recompute_barycentrics)
from speech2lip_tpu_torch.preprocess import face_3dmm as tb
from speech2lip_tpu_torch.preprocess import synthetic_world as sw
from speech2lip_tpu_torch.preprocess import tracker as tt

torch.set_num_threads(2)

H = W = 48
FOCAL = 60.0
DIMS = dict(n_verts=150, id_dim=6, exp_dim=4, tex_dim=6, seed=1)
PACK = {"id": (1, 6), "exp": (6, 4), "euler": (6, 3), "trans": (6, 3),
        "focal": (), "tex": (1, 6), "light": (6, 27)}


@pytest.fixture(scope="module")
def world():
    ta = tb.synthetic_assets(**DIMS)
    truth = sw.true_params(ta, 6)
    imgs, lms = sw.render_world(ta, truth, H, FOCAL)
    return jb.synthetic_assets(**DIMS), ta, truth, imgs, lms


def _cfg(mod, **kw):
    return mod.TrackerConfig(id_dim=6, exp_dim=4, tex_dim=6, img_h=H,
                             img_w=W, batch_size=3, **kw)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 3, 68, 2)).astype(np.float32)
    assert float(tt.cal_lan_loss(torch.from_numpy(a), torch.from_numpy(b))) \
        == pytest.approx(float(jt.cal_lan_loss(a, b)), rel=1e-5)
    pred, gt = rng.uniform(0, 255, (2, 2, 8, 8, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 8, 8)) > 0.3).astype(np.float32)
    assert float(tt.cal_col_loss(*map(torch.from_numpy, (pred, gt, mask)))) \
        == pytest.approx(float(jt.cal_col_loss(pred, gt, mask)), rel=1e-5)
    x = rng.standard_normal((9, 7)).astype(np.float32)
    assert float(tt.cal_lap_loss(torch.from_numpy(x))) == pytest.approx(
        float(jt.cal_lap_loss(x)), rel=1e-5)


def test_landmark_phases_match_jax(world):
    ja, ta, _, _, lms = world
    out_j = jt.FaceTracker(ja, lms, _cfg(jt, iters_pose=20,
                                         iters_idexp=20)).fit(FOCAL)
    tr = tt.FaceTracker(ta, lms, _cfg(tt, iters_pose=20, iters_idexp=20))
    out_t = tr.fit(FOCAL)
    for k, shape in PACK.items():
        assert out_t[k].shape == shape and out_t[k].dtype == np.float32, k
        np.testing.assert_allclose(out_t[k], out_j[k], atol=1e-4, err_msg=k)
    # the fit moved away from the start point
    assert np.abs(out_t["euler"]).max() > 1e-3


def test_find_focal_matches_jax(world):
    ja, ta, _, _, lms = world
    kw = dict(iters_focal_pose=40, iters_focal_idexp=30)
    grid = dict(lo=30, hi=91, step=30, frame_stride=2)   # 30, 60, 90
    want = jt.FaceTracker(ja, lms, _cfg(jt, **kw)).find_focal(**grid)
    got = tt.FaceTracker(ta, lms, _cfg(tt, **kw)).find_focal(**grid)
    assert got == want


def _photo_params(truth, rng):
    """Phase c's parameters near (not at) the truth, key frames 0, 2, 4."""
    sel = [0, 2, 4]
    q = {"id": 0.1 * rng.standard_normal((1, 6)),
         "exp_sel": truth["exp"][sel] + 0.05 * rng.standard_normal((3, 4)),
         "euler_sel": truth["euler"][sel] + 0.02 * rng.standard_normal((3, 3)),
         "trans_sel": truth["trans"][sel] + 0.02 * rng.standard_normal((3, 3)),
         "tex": 0.3 * rng.standard_normal((1, 6)),
         "light": 0.1 * rng.standard_normal((3, 27))}
    return sel, {k: v.astype(np.float32) for k, v in q.items()}


def _jax_pix_colors(tr, a, idb, texb, exp, euler, trans, light, focal):
    geo = jb.forward_geo(a, idb, exp)
    rott = jb.rot_trans_pts(geo, jb.euler2rot(euler), trans)
    normals = jb.vertex_normals(rott, a.tris, a.vert_tris)
    colors = jb.sh_illumination(texb, normals, light)
    pix = jb.proj_pts(rott, focal, tr.cxy)
    return pix.at[:, :, 2].multiply(-1.0), colors


def _jax_loss_c(tr, q, imgs, lms, weights, focal):
    """The JAX ``fit``'s phase-c loss, from the same functions."""
    a, bs = tr.assets, q["exp_sel"].shape[0]
    w_lan, w_id, w_exp = weights
    idb = jnp.broadcast_to(q["id"], (bs, q["id"].shape[1]))
    geo = jb.get_3dlandmarks(a, idb, q["exp_sel"], q["euler_sel"],
                             q["trans_sel"], focal, tr.cxy)
    proj = jb.forward_transform(geo, q["euler_sel"], q["trans_sel"], focal,
                                tr.cxy)
    loss_lan = jt.cal_lan_loss(proj[:, :, :2], lms)
    texb = jnp.broadcast_to(jb.forward_tex(a, q["tex"]),
                            (bs, a.point_num, 3))
    pix, colors = _jax_pix_colors(tr, a, idb, texb, q["exp_sel"],
                                  q["euler_sel"], q["trans_sel"],
                                  q["light"], focal)
    loss_col = tr._chunked_col_loss(pix, colors, imgs, a)
    return (loss_col + loss_lan * w_lan + w_id * jnp.mean(q["id"] ** 2)
            + w_exp * jnp.mean(q["exp_sel"] ** 2))


def _jax_loss_d(tr, q, imgs, lms, id_, texv, pre, w_lan, focal):
    """The JAX ``_phase_d``'s window loss, from the same functions."""
    a, bs = tr.assets, q["exp"].shape[0]
    idb = jnp.broadcast_to(id_, (bs, id_.shape[1]))
    geo_l = jb.get_3dlandmarks(a, idb, q["exp"], q["euler"], q["trans"],
                               focal, tr.cxy)
    proj = jb.forward_transform(geo_l, q["euler"], q["trans"], focal, tr.cxy)
    loss_lan = jt.cal_lan_loss(proj[:, :, :2], lms)
    loss_regexp = jnp.mean(q["exp"] ** 2)
    texb = jnp.broadcast_to(texv, (bs, a.point_num, 3))
    pix, colors = _jax_pix_colors(tr, a, idb, texb, q["exp"], q["euler"],
                                  q["trans"], q["light"], focal)
    loss_col = tr._chunked_col_loss(pix, colors, imgs, a)
    all_exp = jnp.concatenate([pre[0], q["exp"]])
    all_euler = jnp.concatenate([pre[1], q["euler"]])
    all_trans = jnp.concatenate([pre[2], q["trans"]])
    nb = all_exp.shape[0]
    geo_r = jb.forward_geo_sub(a, jnp.broadcast_to(id_, (nb, id_.shape[1])),
                               all_exp, a.keyinds)
    rott_r = jb.rot_trans_pts(geo_r, jb.euler2rot(all_euler), all_trans)
    loss_lap = jt.cal_lap_loss(rott_r.reshape(nb, -1).T)
    return 0.5 * loss_col + w_lan * loss_lan + 1e5 * loss_lap + loss_regexp


def _hold(loss_t, q_t, loss_j, grads_j):
    grads_t = torch.autograd.grad(loss_t, list(q_t.values()))
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    for (k, g), want in zip(zip(q_t, grads_t), grads_j):
        want = np.asarray(want)
        np.testing.assert_allclose(
            g.numpy(), want, atol=1e-5 * max(1e-6, np.abs(want).max()),
            err_msg=k)


def test_photometric_loss_c_matches_jax(world):
    ja, ta, truth, imgs, lms = world
    sel, q = _photo_params(truth, np.random.default_rng(1))
    tr_j = jt.FaceTracker(ja, lms, _cfg(jt))
    tr_t = tt.FaceTracker(ta, lms, _cfg(tt))
    keys = list(q)
    weights = (3.0, 2.0, 1.0)
    loss_j, grads_j = jax.value_and_grad(
        lambda qq: _jax_loss_c(tr_j, dict(zip(keys, qq)),
                               jnp.asarray(imgs[sel]), jnp.asarray(lms[sel]),
                               weights, FOCAL))([jnp.asarray(q[k])
                                                 for k in keys])
    q_t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in q.items()}
    loss_t = tr_t.photo_loss(q_t, torch.from_numpy(imgs[sel]),
                             torch.from_numpy(lms[sel]), weights, FOCAL)
    _hold(loss_t, q_t, loss_j, grads_j)


@pytest.mark.parametrize("n_pre", [0, 3])
def test_photometric_loss_d_matches_jax(world, n_pre):
    ja, ta, truth, imgs, lms = world
    rng = np.random.default_rng(2)
    sel = np.arange(3, 6)
    q = {"exp": truth["exp"][sel] + 0.05 * rng.standard_normal((3, 4)),
         "euler": truth["euler"][sel] + 0.02 * rng.standard_normal((3, 3)),
         "trans": truth["trans"][sel] + 0.02 * rng.standard_normal((3, 3)),
         "light": 0.1 * rng.standard_normal((3, 27))}
    q = {k: v.astype(np.float32) for k, v in q.items()}
    id_ = (0.1 * rng.standard_normal((1, 6))).astype(np.float32)
    tex = (0.3 * rng.standard_normal((1, 6))).astype(np.float32)
    pre = tuple(truth[k][3 - n_pre:3] for k in ("exp", "euler", "trans"))
    tr_j = jt.FaceTracker(ja, lms, _cfg(jt))
    tr_t = tt.FaceTracker(ta, lms, _cfg(tt))
    keys = list(q)
    texv_j = jb.forward_tex(ja, jnp.asarray(tex))
    loss_j, grads_j = jax.value_and_grad(
        lambda qq: _jax_loss_d(tr_j, dict(zip(keys, qq)),
                               jnp.asarray(imgs[sel]), jnp.asarray(lms[sel]),
                               jnp.asarray(id_), texv_j,
                               tuple(map(jnp.asarray, pre)), 8.0, FOCAL))(
        [jnp.asarray(q[k]) for k in keys])
    q_t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in q.items()}
    loss_t = tr_t.window_loss(
        q_t, torch.from_numpy(imgs[sel]), torch.from_numpy(lms[sel]),
        torch.from_numpy(id_), tb.forward_tex(ta, torch.from_numpy(tex)),
        tuple(map(torch.from_numpy, pre)), 8.0, FOCAL)
    _hold(loss_t, q_t, loss_j, grads_j)


def test_chunked_photometric_loss_equals_whole(world):
    """The chunked, checkpointed term equals cal_col_loss of the whole
    batch's render, values and gradients."""
    _, ta, truth, imgs, lms = world
    _, q = _photo_params(truth, np.random.default_rng(3))
    tr = tt.FaceTracker(ta, lms, _cfg(tt, photo_chunk=2))
    whole = tt.FaceTracker(ta, lms, _cfg(tt, photo_chunk=3))
    texv = tb.forward_tex(ta, torch.from_numpy(q["tex"]))
    light = torch.from_numpy(q["light"]).requires_grad_(True)
    args = (torch.from_numpy(q["id"]), texv, torch.from_numpy(q["exp_sel"]),
            torch.from_numpy(q["euler_sel"]), torch.from_numpy(q["trans_sel"]),
            light, FOCAL)
    frames = torch.from_numpy(imgs[[0, 2, 4]])
    got = [tr.col_loss(*tr._pix_colors(*args), frames),
           whole.col_loss(*whole._pix_colors(*args), frames)]
    pix, colors = tr._pix_colors(*args)
    frag = rasterize(pix.detach(), ta.tris, H, W)
    bary = recompute_barycentrics(frag.pix_to_face, pix, ta.tris)
    render = torch.clamp(interpolate_attributes(
        Fragments(frag.pix_to_face, bary, frag.zbuf), ta.tris, colors),
        0, 255)
    hit = (frag.pix_to_face >= 0).float()
    got.append(tt.cal_col_loss(render * hit[..., None], frames, hit))
    grads = [torch.autograd.grad(g, light)[0] for g in got]
    for g, gr in zip(got[1:], grads[1:]):
        assert float(g.detach()) == pytest.approx(float(got[0].detach()),
                                                  rel=1e-6)
        torch.testing.assert_close(gr, grads[0], rtol=1e-5, atol=1e-7)


def test_fit_with_images_runs(world):
    """A port-only photometric fit: 2 steps of phase c, 2 of phase d."""
    _, ta, _, imgs, lms = world
    tr = tt.FaceTracker(ta, lms, _cfg(tt, iters_pose=10, iters_idexp=8,
                                      iters_photo=2, iters_window=2))
    timings = {}
    out = tr.fit(FOCAL, images=imgs, timings=timings)
    assert set(timings) == {"phase_a_pose", "phase_b_idexp",
                            "phase_c_photometric", "phase_d_window"}
    for k, shape in PACK.items():
        assert out[k].shape == shape and np.isfinite(out[k]).all(), k
    assert np.abs(out["light"]).max() > 0 and np.abs(out["tex"]).max() > 0


def test_mesh_over_devices_raises(world):
    """A mesh asks for as many ranks as the group has (``ValueError``
    otherwise, as the JAX mesh asks for devices), on either axis; a mesh
    of one rank, or of one data index, leaves the tracker on one device."""
    from speech2lip_tpu_torch.parallel.mesh import Mesh, make_mesh
    _, ta, _, _, lms = world
    for shape in ((2, 1), (1, 2)):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            tt.FaceTracker(ta, lms, _cfg(tt), mesh=make_mesh(shape))
    assert tt.FaceTracker(ta, lms, _cfg(tt), mesh=make_mesh()).mesh is None
    assert tt.FaceTracker(ta, lms, _cfg(tt), mesh=Mesh(
        1, 2, 1, torch.device("cpu"))).mesh is None


def test_bench_preprocess_tool_runs(capsys):
    from speech2lip_tpu_torch.tools import bench_preprocess
    report = bench_preprocess.main(
        ["--frames", "3", "--verts", "120", "--image-size", "32",
         "--budget-scale", "0.002", "--profile", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(report))
    assert report["backend"] == "cpu" and report["find_focal_s"] > 0
    assert report["photo_iter_ms"] > 0 and report["raster_ms"] > 0
    assert report["photo_frames"] == 3 and report["photo_top_ops_ms"]
    for k in ("phase_a_pose_s", "phase_b_idexp_s", "phase_c_photometric_s",
              "phase_d_window_s"):
        assert report[k] > 0
    # --scaling: phases c/d again on two gloo ranks, launched
    rep = bench_preprocess.main(
        ["--frames", "3", "--verts", "120", "--image-size", "32",
         "--budget-scale", "0.002", "--no-focal", "--scaling", "--devices",
         "2", "--clips", "100", "--device", "cpu"])
    assert rep["devices"] == 2 and rep["phase_c_photometric_ranks_s"] > 0
    assert rep["phase_cd_speedup_at_devices"] > 0
    assert [r["clip_frames"] for r in rep["extrapolation"]] == [100]
