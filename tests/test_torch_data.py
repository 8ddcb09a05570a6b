"""The port's own copies of the JAX package's numpy-only data helpers
(speech2lip_tpu_torch.data) give the same arrays, byte for byte."""

import numpy as np
import pytest

from speech2lip_tpu.data import synthetic as jsyn
from speech2lip_tpu.data import windows as jwin
from speech2lip_tpu.models.talking_face import expanded_lip_box
from speech2lip_tpu_torch.data import synthetic as tsyn
from speech2lip_tpu_torch.data import windows as twin


def _same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("n,face,lip_h,lip_w,seed,with_sync", [
    (2, 64, 16, 24, 0, False), (3, 96, 32, 32, 5, True),
    (1, 500, 80, 120, 0, False)])
def test_synthetic_batch_equal(n, face, lip_h, lip_w, seed, with_sync):
    got, ggeo = tsyn.synthetic_batch(n, face=face, lip_h=lip_h, lip_w=lip_w,
                                     seed=seed, with_sync=with_sync)
    ref, rgeo = jsyn.synthetic_batch(n, face=face, lip_h=lip_h, lip_w=lip_w,
                                     seed=seed, with_sync=with_sync)
    assert ggeo == rgeo and sorted(got) == sorted(ref)
    for k in ref:
        _same(got[k], ref[k])


@pytest.mark.parametrize("face,margin,align", [(64, 4, 8), (160, 16, 8),
                                               (128, 0, 1)])
def test_compute_warp_window_equal(face, margin, align):
    raw, geo = tsyn.synthetic_batch(3, face=face, lip_h=16, lip_w=24, seed=2)
    rng = np.random.default_rng(face)
    # jittered grids, so the window is not the box itself
    coords = [raw["coord"][i] + rng.uniform(-0.05, 0.05, (1, 1, 2)).astype(
        np.float32) for i in range(3)]
    box = expanded_lip_box(16, 24, geo["lip_x"], geo["lip_y"])
    got = twin.compute_warp_window(coords, box, face, face, margin=margin,
                                   align=align)
    ref = jwin.compute_warp_window(coords, box, face, face, margin=margin,
                                   align=align)
    assert got is not None and got == ref
    assert all(type(v) is int for v in got)
    # no pixel lands in a box outside the frame
    far = (face + 10, face + 20, face + 10, face + 20)
    assert twin.compute_warp_window(coords, far, face, face) is None
    assert jwin.compute_warp_window(coords, far, face, face) is None
    assert twin._round_window(3, 5, 40, 61, face, face) == \
        jwin._round_window(3, 5, 40, 61, face, face)
