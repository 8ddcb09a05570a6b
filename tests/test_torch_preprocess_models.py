"""The port's preprocessing nets (FAN, S3FD, DSFD, BiSeNet) and the new
``ops/nn.conv2d`` padding and dilation forms against the JAX package's, on
weights from the JAX ``init``s carried over by ``weights.*_from_jax`` and
inputs made from a numpy seed.

Tolerances: forwards within 1e-4 of max|ref| (float32 convolutions summed
in another order); ``decode_heatmaps``, ``nms`` and the parsing classes
exact (>= 99.9% of pixels for the classes); detections within 1e-3 px
with the same count; convs within 1e-5 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.models import bisenet as jbis
from speech2lip_tpu.models import dsfd as jdsfd
from speech2lip_tpu.models import fan as jfan
from speech2lip_tpu.models import s3fd as js3fd
from speech2lip_tpu.ops import nn as jnn
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.models import bisenet as tbis
from speech2lip_tpu_torch.models import dsfd as tdsfd
from speech2lip_tpu_torch.models import fan as tfan
from speech2lip_tpu_torch.models import s3fd as ts3fd
from speech2lip_tpu_torch.ops import nn as tnn

torch.set_num_threads(2)

np_tree = lambda t: jax.tree.map(np.asarray, t)


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=tol * np.abs(want).max())


def _image(seed, shape, hi):
    return np.random.default_rng(seed).uniform(0, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("k,stride,dilation,size,padding", [
    (1, 1, 1, 9, "SAME"), (1, 2, 1, 10, "SAME"), (3, 1, 1, 9, "SAME"),
    (3, 2, 1, 10, "SAME"), (3, 2, 1, 9, "SAME"), (7, 2, 1, 12, "SAME"),
    (3, 1, 2, 11, 2), (3, 2, 2, 12, "SAME"), (7, 2, 1, 12, 3),
    (3, 2, 1, 10, ((0, 1), (0, 1)))])
def test_conv2d_matches_jax(k, stride, dilation, size, padding):
    p = jnn.conv2d_init(jax.random.PRNGKey(k * 10 + stride), 5, 7, (k, k))
    x = _image(size, (2, size, size + 1, 5), 1.0)
    want = jnn.conv2d(p, jnp.asarray(x), stride=stride, padding=padding,
                      dilation=dilation)
    got = tnn.conv2d({n: torch.tensor(np.asarray(v))
                      for n, v in p.items()}, torch.from_numpy(x),
                     stride=stride, padding=padding, dilation=dilation)
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-5)


def test_conv2d_keeps_its_default_padding():
    """Existing callers: no padding argument still means 1 on each side."""
    w = torch.randn(3, 3, 4, 6, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 8, 8, 4, generator=torch.Generator().manual_seed(1))
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                      w.permute(3, 2, 0, 1), padding=1)
    torch.testing.assert_close(tnn.conv2d({"w": w}, x),
                               want.permute(0, 2, 3, 1))


def test_fan_matches_jax():
    p, s = jfan.init(jax.random.PRNGKey(0), n_modules=2)
    x = _image(0, (2, 64, 64, 3), 1.0)
    want = jfan.apply(p, s, jnp.asarray(x))
    got = tfan.apply(*weights.fan_from_jax(np_tree(p), np_tree(s)),
                     torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 16, 16, 68)
        _close(g, w)


def test_decode_heatmaps_exact():
    rng = np.random.default_rng(1)
    hm = rng.standard_normal((3, 16, 16, 68)).astype(np.float32)
    hm[0, 0, 0, :] = 9.0          # a peak on the border
    hm[1, 5, 7, :] = 9.0          # a tie with the neighbours below
    hm[1, 6, 7, :] = 9.0
    np.testing.assert_array_equal(
        tfan.decode_heatmaps(torch.from_numpy(hm)).numpy(),
        np.asarray(jfan.decode_heatmaps(jnp.asarray(hm))))


def test_s3fd_matches_jax():
    p = js3fd.init(jax.random.PRNGKey(1))
    x = _image(2, (1, 96, 96, 3), 255.0)
    want = js3fd.apply(p, jnp.asarray(x))
    got = ts3fd.apply(weights.s3fd_from_jax(np_tree(p)), torch.from_numpy(x))
    for (gc, gr), (wc, wr) in zip(got, want):
        _close(gc, wc)
        _close(gr, wr)


def test_dsfd_matches_jax():
    p, s = jdsfd.init(jax.random.PRNGKey(2), depths=(1, 1, 1, 1))
    x = _image(3, (1, 96, 96, 3), 255.0)
    want = jdsfd.apply(p, s, jnp.asarray(x))
    got = tdsfd.apply(*weights.dsfd_from_jax(np_tree(p), np_tree(s)),
                      torch.from_numpy(x))
    assert len(got) == 6
    for (gc, gr), (wc, wr) in zip(got, want):
        _close(gc, wc)
        _close(gr, wr)


def test_bisenet_matches_jax():
    p, s = jbis.init(jax.random.PRNGKey(3))
    x = _image(4, (1, 64, 64, 3), 1.0)
    want = jbis.apply(p, s, jnp.asarray(x))
    got = tbis.apply(*weights.bisenet_from_jax(np_tree(p), np_tree(s)),
                     torch.from_numpy(x))
    _close(got, want)


def test_parse_face_matches_jax():
    p, s = jbis.init(jax.random.PRNGKey(5))
    img = _image(5, (80, 72, 3), 1.0)
    want = np.asarray(jbis.parse_face(p, s, jnp.asarray(img)))
    got = tbis.parse_face(*weights.bisenet_from_jax(np_tree(p), np_tree(s)),
                          torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (512, 512)
    assert (got == want).mean() >= 0.999


def _boxes(seed, n):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(5, 30, (n, 2))
    conf = rng.uniform(0.5, 1.0, (n, 1))
    b = np.concatenate([xy, xy + wh, conf], 1).astype(np.float32)
    return b[np.argsort(-b[:, 4])]


@pytest.mark.parametrize("seed,iou", [(0, 0.3), (1, 0.5), (2, 0.1)])
def test_nms_matches_jax(seed, iou):
    boxes = _boxes(seed, 60)
    np.testing.assert_array_equal(ts3fd.nms(boxes, iou),
                                  js3fd.nms(boxes, iou))
    assert ts3fd.nms(boxes[:0], iou).shape == (0, 5)


def _same_detections(got, want):
    assert got.shape == want.shape and len(want) > 0
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-5)


def _face_sized(params, prefix):
    """The regression heads scaled by 0.05: an init's heads regress boxes
    thousands of pixels wide (exp of a large offset), where float32's
    relative rounding alone exceeds 1e-3 px; scaled, the boxes stay near
    their anchors' sizes, as a trained detector's do."""
    params = np_tree(params)
    for k in params:
        if k.startswith(prefix):
            params[k] = {n: v * np.float32(0.05)
                         for n, v in params[k].items()}
    return params


def test_detect_faces_match_jax():
    """S3FD and DSFD detections of one frame at a threshold that keeps a
    few hundred anchors, through decode and NMS."""
    img = _image(6, (96, 96, 3), 255.0)
    p = _face_sized(js3fd.init(jax.random.PRNGKey(7)), "reg_")
    want = js3fd.detect_faces(p, jnp.asarray(img), threshold=0.6)
    got = ts3fd.detect_faces(weights.s3fd_from_jax(p),
                             torch.from_numpy(img), threshold=0.6)
    _same_detections(got, want)
    p, s = jdsfd.init(jax.random.PRNGKey(8), depths=(1, 1, 1, 1))
    p = _face_sized(p, "reg")
    want = jdsfd.detect_faces(p, s, jnp.asarray(img), threshold=0.5)
    got = tdsfd.detect_faces(*weights.dsfd_from_jax(np_tree(p), np_tree(s)),
                             torch.from_numpy(img), threshold=0.5)
    _same_detections(got, want)


def test_random_trees_have_the_jax_shapes():
    """weights.random_* build the JAX inits' shapes (a shallow DSFD and a
    one-module FAN here); a tree of another layout raises."""
    def shapes(tree):
        return {k: tuple(v.shape) for k, v in _flat(tree)}

    def _flat(tree, pre=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from _flat(v, f"{pre}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from _flat(v, f"{pre}/{i}")
        else:
            yield pre, tree

    pairs = [(weights.random_fan(0, n_modules=1),
              jfan.init(jax.random.PRNGKey(0), n_modules=1)),
             (weights.random_s3fd(0), js3fd.init(jax.random.PRNGKey(0))),
             (weights.random_dsfd(0, depths=(1, 2, 1, 1)),
              jdsfd.init(jax.random.PRNGKey(0), depths=(1, 2, 1, 1))),
             (weights.random_bisenet(0), jbis.init(jax.random.PRNGKey(0)))]
    for got, want in pairs:
        assert shapes(got) == shapes(np_tree(want))
    p, s = np_tree(jfan.init(jax.random.PRNGKey(0), n_modules=1))
    p["conv1"]["w"] = p["conv1"]["w"][:, :, :, :32]
    with pytest.raises(ValueError, match="fan"):
        weights.fan_from_jax(p, s)
    p, s = np_tree(jdsfd.init(jax.random.PRNGKey(0), depths=(1, 1, 1, 1)))
    del p["layer2"][0]["down"]
    with pytest.raises(ValueError, match="dsfd"):
        weights.dsfd_from_jax(p, s)
