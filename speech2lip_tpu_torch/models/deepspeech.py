"""DeepSpeech-0.1.0 acoustic model (counterpart of
``speech2lip_tpu/models/deepspeech.py``):

    input [T, 494] (26 MFCC x (9+1+9) context)
    -> 3 x (Linear 2048 + clipped ReLU min(relu(x), 20))
    -> bidirectional LSTM (2048 units, TF BasicLSTMCell)
    -> Linear 2048 + clipped ReLU -> Linear 29 logits (a-z, ', space, blank)

Parameters are the JAX package's tree (``weights.deepspeech_from_jax`` /
``weights.random_deepspeech``): linear ``w`` [in, out], and per LSTM one
fused gate kernel [in + hidden, 4 * hidden] in TF's (i, j, f, o) order with
a bias.  Each LSTM cell is written out by hand: ``torch.nn.LSTM`` orders
its gates (i, f, g, o) and has no forget bias.  The fused product is split:
the input half is one GEMM over all T steps, and only the recurrent half,
``h @ kernel[in:]``, runs step by step.  Everything computes in float32
with TF32 off, as the JAX model does; the JAX package runs it under
``lax.scan`` with no Pallas kernel, so ``torch.matmul`` is the port too.
"""

from __future__ import annotations

import torch

INPUT_DIM = 26 * 19  # 494
HIDDEN = 2048
N_LOGITS = 29
RELU_CLIP = 20.0


def _linear(p, x):
    return x @ p["w"] + p["b"]


def _clipped_relu(x):
    return torch.clamp(x, 0.0, RELU_CLIP)


def _lstm_scan(params, xs: torch.Tensor, reverse: bool = False,
               forget_bias: float = 1.0) -> torch.Tensor:
    """xs [T, D] -> outputs [T, H]: TF BasicLSTMCell, gates (i, j, f, o),
    ``forget_bias`` added inside the forget gate's sigmoid; ``reverse``
    walks the steps from the last (the backward direction)."""
    kernel, bias = params["kernel"], params["bias"]
    d = xs.shape[-1]
    hidden = kernel.shape[1] // 4
    gates_x = xs @ kernel[:d] + bias          # [T, 4H], one GEMM
    w_h = kernel[d:]                          # [H, 4H]
    h = xs.new_zeros(hidden)
    c = xs.new_zeros(hidden)
    out = [None] * xs.shape[0]
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    for t in steps:
        i, j, f, o = (gates_x[t] + h @ w_h).split(hidden)
        c = c * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(j)
        h = torch.tanh(c) * torch.sigmoid(o)
        out[t] = h
    return torch.stack(out)


def apply(params, x: torch.Tensor) -> torch.Tensor:
    """x [T, 494] context windows -> [T, 29] logits, float32 with TF32
    off (the float32 matmul precision is restored afterwards)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            x = x.float()
            h = _clipped_relu(_linear(params["fc1"], x))
            h = _clipped_relu(_linear(params["fc2"], h))
            h = _clipped_relu(_linear(params["fc3"], h))
            fw = _lstm_scan(params["lstm_fw"], h, reverse=False)
            bw = _lstm_scan(params["lstm_bw"], h, reverse=True)
            h = _clipped_relu(_linear(params["fc5"],
                                      torch.cat([fw, bw], dim=-1)))
            return _linear(params["fc6"], h)
    finally:
        torch.set_float32_matmul_precision(prev)
