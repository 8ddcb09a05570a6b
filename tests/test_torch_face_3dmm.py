"""The port's 3DMM (preprocess/face_3dmm.py) against the JAX package's, on
seeded synthetic assets and parameters.

Tolerances: ``synthetic_assets`` and ``load_assets`` arrays equal; the
forward functions within 1e-5 of max|ref| (float32 matmuls and reductions
in another order); ``render_mesh`` images within 1e-3 on the 0-255 scale
where the fragments agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.preprocess import face_3dmm as jb
from speech2lip_tpu_torch.preprocess import face_3dmm as tb

torch.set_num_threads(2)

DIMS = dict(n_verts=300, id_dim=6, exp_dim=4, tex_dim=6, seed=1)
N, FOCAL, SIZE = 3, 40.0, 64
CXY = (SIZE / 2.0, SIZE / 2.0)


def _equal_assets(ja, ta):
    for name in ja._fields:
        want = np.asarray(getattr(ja, name))
        got = getattr(ta, name)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert np.array_equal(want, got), name


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    p = {"id": rng.standard_normal((N, 6)), "exp": rng.standard_normal((N, 4)),
         "euler": 0.1 * rng.standard_normal((N, 3)),
         "trans": np.tile([[0.0, 0.0, -4.0]], (N, 1)),
         "tex": rng.standard_normal((N, 6)),
         "gamma": 0.1 * rng.standard_normal((N, 27))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return (jb.synthetic_assets(**DIMS), tb.synthetic_assets(**DIMS), p)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=tol * max(1.0, np.abs(want).max()))


def test_synthetic_assets_equal_jax():
    _equal_assets(jb.synthetic_assets(**DIMS), tb.synthetic_assets(**DIMS))


def test_load_assets_equal_jax(tmp_path):
    tb.save_reference_schema(tb.synthetic_assets(**DIMS), str(tmp_path))
    _equal_assets(jb.load_assets(str(tmp_path), 6, 4, 6),
                  tb.load_assets(str(tmp_path), 6, 4, 6))


def test_forward_functions_match_jax(world):
    ja, ta, p = world
    J = {k: jnp.asarray(v) for k, v in p.items()}
    T = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(tb.forward_geo(ta, T["id"], T["exp"]),
           jb.forward_geo(ja, J["id"], J["exp"]))
    _close(tb.forward_tex(ta, T["tex"]), jb.forward_tex(ja, J["tex"]))
    _close(tb.euler2rot(T["euler"]), jb.euler2rot(J["euler"]))
    ids = np.arange(0, 300, 7)
    _close(tb.forward_geo_sub(ta, T["id"], T["exp"], torch.from_numpy(ids)),
           jb.forward_geo_sub(ja, J["id"], J["exp"], jnp.asarray(ids)))
    _close(tb.get_3dlandmarks(ta, T["id"], T["exp"], T["euler"], T["trans"],
                              FOCAL, CXY),
           jb.get_3dlandmarks(ja, J["id"], J["exp"], J["euler"], J["trans"],
                              FOCAL, CXY))
    gj = jb.forward_geo(ja, J["id"], J["exp"])
    gt = tb.forward_geo(ta, T["id"], T["exp"])
    _close(tb.forward_transform(gt, T["euler"], T["trans"], FOCAL, CXY),
           jb.forward_transform(gj, J["euler"], J["trans"], FOCAL, CXY))
    rj = jb.rot_trans_pts(gj, jb.euler2rot(J["euler"]), J["trans"])
    rt = tb.rot_trans_pts(gt, tb.euler2rot(T["euler"]), T["trans"])
    _close(rt, rj)
    _close(tb.proj_pts(rt, FOCAL, CXY), jb.proj_pts(rj, FOCAL, CXY))
    nj = jb.vertex_normals(rj, ja.tris, ja.vert_tris)
    nt = tb.vertex_normals(rt, ta.tris, ta.vert_tris)
    _close(nt, nj)
    _close(tb.sh_illumination(tb.forward_tex(ta, T["tex"]), nt, T["gamma"]),
           jb.sh_illumination(jb.forward_tex(ja, J["tex"]), nj, J["gamma"]))


def test_render_mesh_matches_jax(world):
    ja, ta, p = world
    J = {k: jnp.asarray(v) for k, v in p.items()}
    T = {k: torch.from_numpy(v) for k, v in p.items()}
    rj = jb.rot_trans_pts(jb.forward_geo(ja, J["id"], J["exp"]),
                          jb.euler2rot(J["euler"]), J["trans"])
    rt = tb.rot_trans_pts(tb.forward_geo(ta, T["id"], T["exp"]),
                          tb.euler2rot(T["euler"]), T["trans"])
    ij, fj = jb.render_mesh(ja, rj, jb.forward_tex(ja, J["tex"]), J["gamma"],
                            FOCAL, SIZE, SIZE, tile=16,
                            max_faces_per_tile=128, chunk=4)
    it, ft = tb.render_mesh(ta, rt, tb.forward_tex(ta, T["tex"]),
                            T["gamma"], FOCAL, SIZE, SIZE)
    same = np.asarray(fj.pix_to_face) == ft.pix_to_face.numpy()
    assert same.mean() >= 0.999
    hit = np.asarray(fj.pix_to_face) >= 0
    assert hit.any() and not hit.all()
    np.testing.assert_allclose(it.numpy()[same], np.asarray(ij)[same],
                               atol=1e-3)
    assert it.numpy()[~hit & same].max() == 0.0
    assert it.numpy()[hit].mean() > 1.0
