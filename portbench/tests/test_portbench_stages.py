"""The training driver runs the stage its configuration states.  Stage 1
(``train.stage1-b1``) draws its weights and its step's draws as it always
has, from the ``weights`` and ``draws`` streams alone, with the sync loss
off and stage 1's operation count; the sync stage's draws and SyncNet
follow the program's layout; the identity's face box lies inside the face
at every size."""

import numpy as np
import pytest
import torch

from portbench.counts import flops
from portbench.tests import small
from portbench.traffic import draws as D
from portbench.traffic import identity as ID
from portbench.traffic import weights as W


def _equal(a, b):
    la, lb = W.tree_leaves(a), W.tree_leaves(b)
    assert W.tree_paths(a) == W.tree_paths(b)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 41])
def test_stage1_setup_draws_as_before(seed, tmp_path, monkeypatch):
    streams = []
    gen = D.generator

    def spy(s, stream, device):
        streams.append(stream)
        return gen(s, stream, device)
    monkeypatch.setattr(D, "generator", spy)
    c = small.cell("train.stage1-b1")
    c.build_dir = tmp_path
    s = small.session(c, seed)
    s.setup()
    assert sorted(streams) == ["draws", "weights"]
    assert not s.st.sync_on and not s.st.postnet_frozen
    assert set(s.frozen) == {"lpips"}
    assert s.state.it == 3
    # the weights: one stream, the lip MLP, the U-Net and LPIPS in turn
    wg = gen(seed, "weights", small.CPU)
    params = W.make_tree(W.talking_face_leaves(W.INIT), wg, small.CPU)
    up_l, us_l = W.unet_leaves(W.INIT)
    up, us = (W.make_tree(l, wg, small.CPU) for l in (up_l, us_l))
    lp = W.make_tree(W.lpips_leaves(), wg, small.CPU)
    got = dict(s.init[0])
    got.pop("canonical_depth")
    _equal(got, params)
    _equal(s.init[1], up)
    _equal(s.init[2], us)
    _equal(s.frozen["lpips"], lp)
    # the checked steps' draws: the stream's first draws, stage 1's keys
    dg = gen(seed, "draws", small.CPU)
    for k in s.checked:
        want = D.step_draws(dg, 1, s.st.face_h, s.st.face_w, small.CPU)
        assert set(k["draws"]) == {"lip", "hole1", "hole2", "apply_u"}
        _equal(k["draws"], want)
        assert "loss_sync" not in k["terms"]
    s.window_run(0.05)
    ctx = s.context()
    assert ctx["model_ops"] == s.iters * flops.train_iter_ops(
        s.st.lip_h, s.st.lip_w, s.st.face_h, s.st.face_w, 1)


def test_sync_draws_follow_the_programs_order():
    """With ``sync_frames`` the draws are the program's ``draw_noise`` of
    the sync stage from the same generator, and the stage-1 entries are
    the tensors drawn without it."""
    from speech2lip_tpu_torch.train import train_step as ts
    st = ts.StepStatics(lip_h=4, lip_w=6, lip_x=0, lip_y=0, face_h=8,
                        face_w=8, focal=1.0, sync_on=True)
    prog = ts.draw_noise(st, 2, "cpu", torch.Generator().manual_seed(3))
    mine = D.step_draws(torch.Generator().manual_seed(3), 2, 8, 8, "cpu",
                        True, 2 * st.sync_T)
    assert mine["sync_lip"]["eps_u"].shape == (10,)
    _equal(mine, prog)
    plain = D.step_draws(torch.Generator().manual_seed(3), 2, 8, 8, "cpu")
    _equal(plain, {k: v for k, v in mine.items() if k != "sync_lip"})


def test_syncnet_leaves_are_the_programs_tree():
    """The SyncNet the driver makes has the leaf names and shapes of the
    program's (``weights.random_syncnet``), which ``models/syncnet``
    reads."""
    from speech2lip_tpu_torch import weights as PW
    prog = PW.random_syncnet(0)
    mine = tuple(W.make_tree(l, torch.Generator().manual_seed(1), "cpu")
                 for l in W.syncnet_leaves())
    for a, b in zip(mine, prog):
        assert W.tree_paths(a) == W.tree_paths(b)
        assert [x.shape for x in W.tree_leaves(a)] == \
            [x.shape for x in W.tree_leaves(b)]


@pytest.mark.parametrize("face", [64, 320, 500])
def test_face_box_lies_inside_the_face(face, tmp_path):
    m = ID.face_margin(face)
    assert 0 < m < face - m
    if face == 500:
        assert m == 40      # the May identity's box, as it was written
    p = dict(small.cell("train.stage1-b1").traffic["identity"], face=face,
             n_frames=2, lip={"x": face // 4, "y": face // 2,
                              "h": face // 8, "w": face // 4})
    ID.write(p, tmp_path)
    box = np.load(tmp_path / "face_bbox_dict.npy", allow_pickle=True).item()
    assert set(box) == {"00001.jpg", "00002.jpg"}
    for v in box.values():
        assert v.tolist() == [m, m, face - m, face - m, 1.0]
