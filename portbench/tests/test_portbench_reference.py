"""The plain references agree with the port's plain CPU path at a small
size, in float32 (the port's kernel wrappers run their plain versions on
CPU tensors)."""

import copy

import pytest
import torch

from portbench.reference import compare
from portbench.reference import serve as ref
from portbench.tests import small
from portbench.traffic import draws as D
from portbench.traffic import frames as FR
from portbench.traffic import weights as W


def _f32(c):
    c.config = copy.deepcopy(c.config)
    c.config["config"]["model"]["compute_dtype"] = "float32"
    return c


def _weights(seed=7):
    g = D.generator(seed, "weights", "cpu")
    up, us = W.unet_leaves(W.SERVED)
    return tuple(W.make_tree(l, g, "cpu")
                 for l in (W.talking_face_leaves(W.SERVED), up, us))


def test_dub_reference_is_the_renderer():
    from speech2lip_tpu_torch.infer.renderer import Renderer
    c = _f32(small.cell("serve.dub-b32"))
    geo, t = c.config["geometry"], c.traffic
    store = FR.make_identity(D.generator(7, "frames", "cpu"), 8, 0, geo,
                             t["motion"], "cpu")
    win = FR.warp_window(store["coord"], FR.expanded_lip_box(geo["lip"]))
    w = _weights()
    out = Renderer(c.config["config"], *w, device="cpu", window=win)(
        store, geo["lip"]["x"], geo["lip"]["y"])
    r = ref.dub(c.config["config"], w, store, geo["lip"]["x"],
                geo["lip"]["y"])
    assert compare.rms_gap(out["lip"], r["lip"]) < 1e-5
    assert compare.rms_gap(out["face"], r["face"]) < 1e-5
    assert compare.max_gap(out["face"], r["face"]) < 1e-5


def test_avatar_reference_is_the_static_scene_path():
    """The kernel path's semantics (the U-Net on the crop, align-corners
    upsampling there) in float32 through the wrappers' plain versions."""
    from speech2lip_tpu_torch.infer.static_scene import StaticSceneRenderer
    c = _f32(small.cell("serve.avatar-b8"))
    geo = c.config["geometry"]
    face = geo["face"]
    can = FR.canonical_face(face, D.generator(7, "frames", "cpu"), "cpu")
    coord = FR.identity_grid(face, "cpu")
    scene = {"rgb_face_zero": can, "rgb_face_ori": FR.warp(can, coord[None])[0],
             "mask_lip_canonical": FR.lip_mask(face, geo["lip"], "cpu"),
             "coord": coord}
    win = FR.warp_window(coord[None], FR.expanded_lip_box(geo["lip"]))
    w = _weights()
    prog = StaticSceneRenderer(c.config["config"], *w, base=scene, window=win,
                               lip_x=geo["lip"]["x"], lip_y=geo["lip"]["y"],
                               device="cpu", use_kernels=True,
                               compute_dtype=torch.float32)
    assert prog.geo is not None  # the crop path, not the whole frame
    audio = torch.randn(3, 16, 29, generator=torch.Generator().manual_seed(1))
    t = torch.arange(3.0)
    got = prog(audio, t)
    static = ref.static_face(w, scene["rgb_face_ori"])
    r = ref.avatar(c.config["config"], w, scene, audio, t, win,
                   geo["lip"]["x"], geo["lip"]["y"], static)
    assert compare.rms_gap(got, r) < 1e-5
    assert compare.max_gap(got, r) < 1e-5


def test_train_reference_follows_the_step(tmp_path):
    """The loop's batch equals the reference's read of the files, and the
    step's first loss and gradient norm equal the reference's."""
    c = small.cell("train.stage1-b1")
    c.build_dir = tmp_path
    s = small.session(c, seed=11)
    s.setup()
    batches, batch_gap = s._ref_batches()
    assert batch_gap == 0.0
    r = s._follow(batches, "f32")
    p = s._program()
    assert p["loss"][0] == pytest.approx(r["loss"][0], rel=1e-6)
    assert p["grad_norm"][0] == pytest.approx(r["grad_norm"][0], rel=1e-3)
    g = s.check()
    assert g["loss1_gap"] < 1e-5 and g["grad_gap"] < 1e-2
