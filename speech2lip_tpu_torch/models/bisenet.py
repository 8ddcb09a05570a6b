"""BiSeNet face parser with a ResNet-18 backbone (counterpart of
``speech2lip_tpu/models/bisenet.py``).

ResNet-18 features at strides 8/16/32, a context path with two
attention-refinement modules and a global-pool tail, a feature-fusion
module over the stride-8 feature and the refined context, and a 19-class
head upsampled to the input size.  Eval-mode BatchNorm; the parameter
tree is the JAX package's (``weights.bisenet_from_jax``).  Used by STEP5's
head mask and as STEP1's last-resort face box.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speech2lip_tpu_torch.ops import nn as tnn

N_CLASSES = 19
# (name, cin, cout) of the four ResNet-18 stages, two blocks each
LAYERS = (("layer1", 64, 64), ("layer2", 64, 128), ("layer3", 128, 256),
          ("layer4", 256, 512))
# ImageNet normalisation of the parsing entry
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _conv_bn_relu(params, state, x, stride=1, padding=1):
    x = tnn.conv2d(params["conv"], x, stride=stride, padding=padding)
    return tnn.relu(tnn.batchnorm(params["bn"], state["bn"], x))


def _basic_block(params, state, x, stride):
    r = tnn.conv2d(params["c1"]["conv"], x, stride=stride, padding=1)
    r = tnn.relu(tnn.batchnorm(params["c1"]["bn"], state["c1"]["bn"], r))
    r = tnn.conv2d(params["c2"]["conv"], r, padding=1)
    r = tnn.batchnorm(params["c2"]["bn"], state["c2"]["bn"], r)
    if "down" in params:
        x = tnn.conv2d(params["down"]["conv"], x, stride=stride, padding=0)
        x = tnn.batchnorm(params["down"]["bn"], state["down"]["bn"], x)
    return tnn.relu(x + r)


def _arm(params, state, x):
    feat = _conv_bn_relu(params["conv"], state["conv"], x)
    att = feat.mean(dim=(1, 2), keepdim=True)
    att = tnn.conv2d(params["atten"], att, padding=0)
    att = tnn.batchnorm(params["atten_bn"], state["atten_bn"], att)
    return feat * torch.sigmoid(att)


def _resize_nearest(x, h, w):
    """Nearest resize by the floor index i * in // out, as the JAX
    package computes it."""
    hh, ww = x.shape[1:3]
    ry = torch.arange(h, device=x.device) * hh // h
    rx = torch.arange(w, device=x.device) * ww // w
    return x[:, ry][:, :, rx]


def apply(params, state, x: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, 3] RGB in [0, 1] -> [B, H, W, n_classes] logits."""
    x = ((x - torch.tensor(_MEAN, dtype=x.dtype, device=x.device))
         / torch.tensor(_STD, dtype=x.dtype, device=x.device))
    h0, w0 = x.shape[1:3]

    y = _conv_bn_relu(params["stem"], state["stem"], x, stride=2, padding=3)
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1)
    y = y.permute(0, 2, 3, 1)
    for name, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2),
                         ("layer4", 2)):
        for i, (p, s) in enumerate(zip(params[name], state[name])):
            y = _basic_block(p, s, y, stride if i == 0 else 1)
        if name == "layer2":
            feat8 = y
        elif name == "layer3":
            feat16 = y
    feat32 = y

    # context path
    avg = feat32.mean(dim=(1, 2), keepdim=True)
    avg = _conv_bn_relu(params["avg"], state["avg"], avg, padding=0)
    f32 = _arm(params["arm32"], state["arm32"], feat32) + avg
    f32 = _resize_nearest(f32, feat16.shape[1], feat16.shape[2])
    f32 = _conv_bn_relu(params["head32"], state["head32"], f32)
    f16 = _arm(params["arm16"], state["arm16"], feat16) + f32
    f16 = _resize_nearest(f16, feat8.shape[1], feat8.shape[2])
    f16 = _conv_bn_relu(params["head16"], state["head16"], f16)

    # feature fusion, the stride-8 feature as the spatial path
    fcat = torch.cat([feat8, f16], dim=-1)
    feat = _conv_bn_relu(params["ffm"], state["ffm"], fcat, padding=0)
    att = feat.mean(dim=(1, 2), keepdim=True)
    att = tnn.relu(tnn.conv2d(params["ffm_a1"], att, padding=0))
    att = torch.sigmoid(tnn.conv2d(params["ffm_a2"], att, padding=0))
    feat = feat * att + feat

    out = _conv_bn_relu(params["out"], state["out"], feat)
    out = tnn.conv2d(params["out_final"], out, padding=0)
    return tnn.upsample_bilinear(out, h0, w0)


def parse_face(params, state, image: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] float RGB in [0, 1] -> [512, 512] class map: the frame
    resized (``jax.image.resize``'s linear resize) to the 512^2 eval size,
    then the argmax."""
    x = tnn.resize_linear(image[None], 512, 512)
    with torch.no_grad():
        logits = apply(params, state, x)
    return torch.argmax(logits[0], dim=-1)
