"""The port's tiny-landmarks trainer (tools/train_tiny_landmarks.py)
against the JAX tool's dataset, and its training loop.

The landmarks of ``make_dataset`` equal the JAX tool's (the same numpy
draws through the same 3DMM, within 1e-4 px); the clean renders equal the
JAX package's ``render_mesh`` of those draws within 1e-3 on the 0-255
scale where the fragments agree (the JAX tool augments its renders with
JAX's PRNG, which the port does not draw).  A few steps lower the loss;
the checkpoint loads through ``tiny_landmarks.load``; the committed
checkpoint's bytes do not change.
"""

import hashlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.preprocess import face_3dmm as jb
from speech2lip_tpu_torch.models import tiny_landmarks as tl
from speech2lip_tpu_torch.tools import train_tiny_landmarks as ttl

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_train_tiny_landmarks",
        os.path.join(ROOT, "tools", "train_tiny_landmarks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dataset_matches_jax_tool():
    n, seed = 6, 3
    _, lms_j = _jax_tool().make_dataset(n, seed, chunk=4)
    imgs_t, lms_t = ttl.make_dataset(n, seed, chunk=4, augment=False)
    np.testing.assert_allclose(lms_t.numpy(), np.asarray(lms_j), atol=1e-4)
    # the clean renders of the same draws through the JAX package
    ja = jb.synthetic_assets(**ttl.DIMS)
    rng = np.random.default_rng(seed)
    want = []
    for s in range(0, n, 4):
        p = {k: jnp.asarray(v) for k, v in
             ttl.draw_params(rng, min(4, n - s)).items()}
        rott = jb.rot_trans_pts(jb.forward_geo(ja, p["id"], p["exp"]),
                                jb.euler2rot(p["euler"]), p["trans"])
        img, _ = jb.render_mesh(ja, rott, jb.forward_tex(ja, p["tex"]),
                                p["light"], ttl.FOCAL, ttl.SIZE, ttl.SIZE,
                                chunk=8, **ttl.RK)
        want.append(np.asarray(img))
    want = np.concatenate(want)
    # float32 lighting sums in another order: 1e-5 of the 0-255 range; a
    # pixel on a shared edge may take the other face
    close = np.abs(imgs_t.numpy() * 255.0 - want).max(-1) <= 255 * 1e-5
    assert close.mean() >= 0.999
    assert want.max() > 25.0


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_training_lowers_the_loss_and_writes_a_loadable_checkpoint(
        tmp_path, capsys):
    before = _digest(tl.CKPT)
    out = str(tmp_path / "tiny.ckpt")
    report = ttl.main(["--steps", "40", "--batch", "16", "--n-train", "32",
                       "--n-val", "8", "--lr", "1e-3", "--out", out,
                       "--device", "cpu"])
    assert report["last_loss"] < report["first_loss"]
    params = tl.load(out)
    assert set(params) == {"conv0", "conv1", "conv2", "conv3", "fc1", "fc2"}
    frames = torch.rand(2, 64, 80, 3, generator=torch.Generator()
                        .manual_seed(0))
    assert tl.detect(params, frames).shape == (2, 68, 2)
    with pytest.raises(SystemExit):
        ttl.main(["--out", tl.CKPT, "--device", "cpu"])
    assert _digest(tl.CKPT) == before
