"""The port's new-audio path against the JAX package: the MFCC input
vectors, the DeepSpeech RNN, the feature windows and the wav -> windows
pipeline, on inputs made from a numpy seed.

Tolerances: the MFCC is the same numpy code (1e-12); the RNN computes in
float32 with the fused gate product split in two GEMMs, so sums run in
another order (rtol 1e-5); the windowing is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2lip_tpu.models import deepspeech as jds
from speech2lip_tpu.ops import mfcc as jmfcc
from speech2lip_tpu.preprocess import audio_features as jaf
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.models import deepspeech as tds
from speech2lip_tpu_torch.ops import mfcc as tmfcc
from speech2lip_tpu_torch.preprocess import audio_features as taf

torch.set_num_threads(2)

HIDDEN, T = 32, 64
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def ds_params():
    """Seeded JAX DeepSpeech weights at input 494, hidden 32, as numpy,
    and the port's tree carried over by ``deepspeech_from_jax``."""
    jp = jax.tree.map(np.asarray, jds.init(jax.random.PRNGKey(3),
                                           hidden=HIDDEN))
    return jp, weights.deepspeech_from_jax(jp)


def _wav(seed, n, dtype=np.int16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 0.2
    x += 0.5 * np.sin(np.arange(n) * 2 * np.pi * 220 / 16000)
    return (x * 8000).astype(np.int16) if dtype == np.int16 else \
        (x / 2).astype(dtype)


def test_mfcc_input_vector_equal():
    sig = _wav(0, 24000)
    got = tmfcc.deepspeech_input_vector(sig)
    ref = jmfcc.deepspeech_input_vector(sig)
    assert got.shape == ref.shape == (75, 494)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_jax(ds_params, reverse):
    jp, tp = ds_params
    xs = np.random.default_rng(1).standard_normal(
        (T, 2 * HIDDEN)).astype(np.float32)
    ref = np.asarray(jds._lstm_scan(jp["lstm_fw"], jnp.asarray(xs),
                                    reverse=reverse))
    got = tds._lstm_scan(tp["lstm_fw"], torch.from_numpy(xs),
                         reverse=reverse).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_deepspeech_apply_matches_jax(ds_params):
    jp, tp = ds_params
    # context windows scaled so the clipped ReLU at 20 bites in fc1
    x = (40 * np.random.default_rng(2).standard_normal(
        (T, 494))).astype(np.float32)
    ref = np.asarray(jds.apply(jp, jnp.asarray(x)))
    got = tds.apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == (T, 29)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    h1 = np.maximum(x @ jp["fc1"]["w"] + jp["fc1"]["b"], 0)
    assert (h1 > 20).any(), "the clip at 20 is not exercised"


def test_random_deepspeech_matches_init_shapes_and_bounds():
    shapes = jax.eval_shape(lambda k: jds.init(k, hidden=48),
                            jax.random.PRNGKey(0))
    tp = weights.random_deepspeech(5, hidden=48)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    assert len(flat_j) == 14
    for path, s in flat_j.items():
        keys = [p.key for p in path]
        t = tp[keys[0]][keys[1]]
        assert tuple(t.shape) == s.shape and t.dtype == torch.float32
        if keys[1] == "bias":
            assert not t.any()
            continue
        fan_in = t.shape[0] if keys[1] == "kernel" else (
            tp[keys[0]]["w"].shape[0])
        assert float(t.abs().max()) <= 1 / np.sqrt(fan_in)
        assert float(t.abs().max()) > 0.9 / np.sqrt(fan_in)
    with pytest.raises(ValueError, match="deepspeech lstm_fw"):
        bad = jax.tree.map(np.asarray, jds.init(jax.random.PRNGKey(0),
                                                hidden=8))
        bad["lstm_fw"]["kernel"] = bad["lstm_fw"]["kernel"][:, :16]
        weights.deepspeech_from_jax(bad)


def test_make_windows_and_interpolate_exact():
    f = np.random.default_rng(4).standard_normal((37, 29)).astype(np.float32)
    for win, stride in ((16, 2), (16, 1), (8, 3)):
        np.testing.assert_array_equal(taf.make_windows(f, win, stride),
                                      jaf.make_windows(f, win, stride))
    for rate_out, n in ((25.0, 18), (29.97, 22)):
        np.testing.assert_array_equal(
            taf.interpolate_features(f, 50.0, rate_out, n),
            jaf.interpolate_features(f, 50.0, rate_out, n))


# (waveform, rate, num_frames): int16 at 16 kHz and float at 22.05 kHz
# (peak-normalised, resampled), each through both windowing variants
WAV_CASES = [(np.int16, 16000, None), (np.int16, 16000, 21),
             (np.float32, 22050, None), (np.float32, 22050, 30)]


@pytest.mark.parametrize("dtype,rate,num_frames", WAV_CASES)
def test_wav_to_windows_matches_jax(ds_params, dtype, rate, num_frames):
    jp, tp = ds_params
    wav = _wav(6, int(rate * 0.9), dtype)
    ref = jaf.wav_to_deepspeech_windows(wav, rate, jp, num_frames=num_frames,
                                        batch_t=64)
    got = taf.wav_to_deepspeech_windows(wav, rate, tp, num_frames=num_frames,
                                        batch_t=64, device="cpu")
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == ref.shape and got.shape[1:] == (16, 29)
    if num_frames is not None:
        assert got.shape[0] == num_frames
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_batch_t_padding_changes_the_windows_in_both(ds_params):
    """T is zero-padded to a multiple of batch_t before the RNN; fc1 of a
    zero row is its bias, so the backward LSTM starts from another state
    and the windows depend on batch_t, in the JAX package and the port."""
    jp, tp = ds_params
    wav = _wav(7, 16000)   # 50 RNN steps: padded to 64 or to 128
    out = {}
    for bt in (64, 128):
        ref = jaf.wav_to_deepspeech_windows(wav, 16000, jp, batch_t=bt)
        got = taf.wav_to_deepspeech_windows(wav, 16000, tp, batch_t=bt,
                                            device="cpu")
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        out[bt] = (ref, got)
    for k in (0, 1):
        assert np.abs(out[64][k] - out[128][k]).max() > 1e-4
