"""Model weights made from a seed on the device, in the parameter trees the
port's entry points take (the JAX package's layout: linear ``w`` [in, out],
conv1d LIO, conv2d HWIO, BatchNorm ``scale``/``bias`` and its state
``mean``/``var``).

One ``torch.rand`` call on the device draws every leaf of a tree; each leaf
is an affine map of its slice.  Two draws: ``init`` is the JAX package's
(weights and biases uniform in +-1/sqrt(fan_in)), where training starts;
``served`` stands for a trained model, whose layers keep their signal:
weights uniform in +-sqrt(6/fan_in) (He's bound for ReLU layers), small
biases, and the heads biased to image values (0.3-0.7), so the lip follows
the audio and the face follows the U-Net's input as a trained model's do.
Nothing here imports the program: the benchmark hands the same trees to
the program and to the plain reference.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from portbench.counts.flops import SYNC_AUDIO, SYNC_FACE

# (path, shape, lo, hi); lo == hi is a constant leaf
Leaf = Tuple[Tuple[Any, ...], Tuple[int, ...], float, float]


INIT, SERVED = "init", "served"


def _bound(fan_in: int, draw: str) -> float:
    return (6.0 / fan_in) ** 0.5 if draw == SERVED else fan_in ** -0.5


def _lin(path, i: int, o: int, draw: str, head: bool = False) -> List[Leaf]:
    w = _bound(i, draw)
    b = i ** -0.5
    if head and draw == SERVED:
        # an image head: values around 0.3-0.7, a quarter of the plain bound
        return [(path + ("w",), (i, o), -b / 4, b / 4),
                (path + ("b",), (o,), 0.3, 0.7)]
    return [(path + ("w",), (i, o), -w, w), (path + ("b",), (o,), -b, b)]


def talking_face_leaves(draw: str = INIT, width: int = 256, depth: int = 8,
                        skip: int = 4, audio_in: int = 29, out_ch: int = 3
                        ) -> List[Leaf]:
    """The lip renderer's leaves (``models/talking_face``) but the
    canonical depth, which training takes from the identity."""
    leaves: List[Leaf] = []
    for i, (ci, co) in enumerate(((audio_in, 32), (32, 32), (32, 64),
                                  (64, 64))):
        w, b = _bound(3 * ci, draw), (3 * ci) ** -0.5
        leaves += [(("audio_enc", "conv", i, "w"), (3, ci, co), -w, w),
                   (("audio_enc", "conv", i, "b"), (co,), -b, b)]
    for i in range(2):
        leaves += _lin(("audio_enc", "fc", i), 64, 64, draw)
    for name, i in (("fc_uv", 42), ("fc_uv_skip", 42), ("fc_audio", 64),
                    ("fc_audio_skip", 64), ("fc_time", 20),
                    ("fc_time_skip", 20)):
        leaves += _lin((name,), i, width, draw)
    for i in range(depth):
        leaves += _lin(("trunk", i), 2 * width if i - 1 == skip else width,
                       width, draw)
    leaves += _lin(("output",), width, out_ch, draw, head=True)
    return leaves


UNET_BLOCKS = (("inc", 3, 64, 64), ("down1", 64, 128, 128),
               ("down2", 128, 128, 128), ("up1", 256, 128, 64),
               ("up2", 128, 64, 64))


def unet_leaves(draw: str = INIT) -> Tuple[List[Leaf], List[Leaf]]:
    """(params, state) leaves of the light U-Net (``models/unet_light``).
    ``served``: BatchNorm at a random eval state (scale U(0.8, 1.2),
    bias and mean U(-0.1, 0.1), var U(0.5, 1.5)), so that folding it
    matters; ``init``: at its initial values (1, 0, 0, 1), as training
    starts."""
    params: List[Leaf] = []
    state: List[Leaf] = []
    for name, cin, cmid, cout in UNET_BLOCKS:
        for conv, ci, co in (("conv1", cin, cmid), ("conv2", cmid, cout)):
            b = _bound(9 * ci, draw)
            params.append(((name, conv, "w"), (3, 3, ci, co), -b, b))
        for bn, c in (("bn1", cmid), ("bn2", cout)):
            if draw == SERVED:
                params += [((name, bn, "scale"), (c,), 0.8, 1.2),
                           ((name, bn, "bias"), (c,), -0.1, 0.1)]
                state += [((name, bn, "mean"), (c,), -0.1, 0.1),
                          ((name, bn, "var"), (c,), 0.5, 1.5)]
            else:
                params += [((name, bn, "scale"), (c,), 1.0, 1.0),
                           ((name, bn, "bias"), (c,), 0.0, 0.0)]
                state += [((name, bn, "mean"), (c,), 0.0, 0.0),
                          ((name, bn, "var"), (c,), 1.0, 1.0)]
    b = 64 ** -0.5
    params += [(("outc", "w"), (1, 1, 64, 3), -b, b),
               (("outc", "b"), (3,), *((0.3, 0.7) if draw == SERVED
                                       else (-b, b)))]
    return params, state


ALEX = ((64, 11), (192, 5), (384, 3), (256, 3), (256, 3))


def lpips_leaves() -> List[Leaf]:
    """LPIPS (AlexNet v0.1) leaves: convs HWIO + bias, uniform in
    +-1/sqrt(fan_in); the linear heads non-negative, as trained ones are."""
    leaves: List[Leaf] = []
    c = 3
    for i, (co, k) in enumerate(ALEX):
        b = (k * k * c) ** -0.5
        leaves += [(("convs", i, "w"), (k, k, c, co), -b, b),
                   (("convs", i, "b"), (co,), -b, b)]
        leaves.append((("lins", i, "w"), (1, 1, co, 1), 0.0, co ** -0.5))
        c = co
    return leaves


def syncnet_leaves() -> Tuple[List[Leaf], List[Leaf]]:
    """(params, state) leaves of the frozen SyncNet expert: per encoder
    (``face``, ``audio``) a list of blocks, each ``conv`` (HWIO ``w`` and
    ``b``, uniform in +-1/sqrt(fan_in)) and ``bn`` (scale U(0.8, 1.2),
    bias U(-0.1, 0.1)); the state ``bn`` mean U(-0.1, 0.1), var U(0.5,
    1.5): a frozen net's eval state."""
    params: List[Leaf] = []
    state: List[Leaf] = []
    for name, spec, c in (("face", SYNC_FACE, 15), ("audio", SYNC_AUDIO, 1)):
        for i, (co, (kh, kw), _, _) in enumerate(spec):
            b = (kh * kw * c) ** -0.5
            params += [((name, i, "conv", "w"), (kh, kw, c, co), -b, b),
                       ((name, i, "conv", "b"), (co,), -b, b),
                       ((name, i, "bn", "scale"), (co,), 0.8, 1.2),
                       ((name, i, "bn", "bias"), (co,), -0.1, 0.1)]
            state += [((name, i, "bn", "mean"), (co,), -0.1, 0.1),
                      ((name, i, "bn", "var"), (co,), 0.5, 1.5)]
            c = co
    return params, state


def _put(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    last = path[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append(None)
    node[last] = value


def make_tree(leaves: List[Leaf], generator: torch.Generator, device,
              dtype=torch.float32) -> Dict[str, Any]:
    """The tree of ``leaves`` drawn by one ``torch.rand`` on ``device``
    from ``generator``, each leaf an affine map of its slice, cast to
    ``dtype``."""
    total = sum(_numel(s) for _, s, _, _ in leaves)
    u = torch.rand(total, generator=generator, device=device,
                   dtype=torch.float32)
    tree: Dict[str, Any] = {}
    off = 0
    for path, shape, lo, hi in leaves:
        n = _numel(shape)
        leaf = (lo + (hi - lo) * u[off:off + n]).reshape(shape)
        _put(tree, path, leaf.to(dtype).contiguous())
        off += n
    return tree


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in the order the program's ``train_step.tree_leaves`` takes
    them: dict insertion order, depth first."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> List[str]:
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in tree_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]
