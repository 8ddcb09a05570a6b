"""The port's training step (speech2lip_tpu_torch.train) against the JAX
package's, on the CPU: the same parameters (JAX init through the weight
bridges), the same synthetic batch, and the JAX step's random draws rebuilt
from its key with its split sequence and handed to the port.  Face 64, lip
16x24, 2 frames, the full 256-wide MLP, the U-Net at base 16; the JAX side
jits, with hat_sample's Pallas kernels in interpret mode.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import speech2lip_tpu.ops.pallas.hat_sample as jhs
import speech2lip_tpu.ops.pallas.window_sample as jws
from speech2lip_tpu.core.config import default_config as jdefault_config
from speech2lip_tpu.data.synthetic import synthetic_batch
from speech2lip_tpu.data.windows import compute_warp_window
from speech2lip_tpu.models import lpips as jlpips
from speech2lip_tpu.models import syncnet as jsyncnet
from speech2lip_tpu.models import talking_face as jtf
from speech2lip_tpu.models import unet_light as junet
from speech2lip_tpu.ops.grid_sample import grid_sample_np
from speech2lip_tpu.train import losses as jlosses
from speech2lip_tpu.train import train_step as jts
from speech2lip_tpu.train import trainer as jtrainer
from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.models import lpips as tlpips
from speech2lip_tpu_torch.models import syncnet as tsyncnet
from speech2lip_tpu_torch.models import unet_light as tunet
from speech2lip_tpu_torch.ops.kernels import hat_sample as ths
from speech2lip_tpu_torch.ops.kernels import window_sample as tws
from speech2lip_tpu_torch.train import losses as tlosses
from speech2lip_tpu_torch.train import train_step as tts
from speech2lip_tpu_torch.train import trainer as ttrainer
from test_torch_kernels import _tf_params, unet_params

torch.set_num_threads(2)

FACE, LIP_H, LIP_W, B, T = 64, 16, 24, 2, 5
# float32 bounds, relative to the largest reference magnitude: losses sum
# ~10^4 terms, gradients pass the U-Net, LPIPS and the warp in another
# summation order
LOSS_TOL = 1e-4
# every gradient leaf against the largest gradient of any leaf
GRAD_TOL = 1e-4
# each gradient leaf against its own scale: the deep MLP layers' gradients
# are ~1e-4 of the output layer's, and the JAX package's float32 CPU
# gradients there sit up to 1e-3 of the leaf's scale from a float64
# evaluation of the port (whose float32 gradients sit within 5e-7 of it)
LEAF_TOL = 2e-3


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setattr(jws, "INTERPRET", True)
    monkeypatch.setattr(jhs, "INTERPRET", True)
    jws.window_sample.clear_cache()
    yield
    jws.window_sample.clear_cache()


def _init_like(init, key, rng):
    """Leaves of ``init(key)``'s own tree (``jax.eval_shape``), drawn with
    numpy as ``conv2d_init`` draws them, uniform(+-1/sqrt(fan_in)): the
    JAX PRNG would compile once per leaf shape, ~10 s for LPIPS and
    SyncNet.  BatchNorm leaves come back as ones (``_randomize_bn``)."""
    def fill(t):
        if isinstance(t, dict) and "w" in t:
            bound = 1.0 / np.sqrt(np.prod(t["w"].shape[:-1]))
            return {k: rng.uniform(-bound, bound, v.shape).astype(np.float32)
                    for k, v in t.items()}
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(v) for v in t)
        return np.ones(t.shape, np.float32)
    return fill(jax.eval_shape(init, key))


def _randomize_bn(tree, rng):
    """JAX SyncNet init holds identity BatchNorms; make them matter."""
    for blk in tree:
        c = blk["bn"]["mean"].shape[0] if "mean" in blk["bn"] else \
            blk["bn"]["scale"].shape[0]
        if "mean" in blk["bn"]:
            blk["bn"] = {"mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        else:
            blk["bn"] = {"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                         "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32)}


@pytest.fixture(scope="module")
def setup():
    raw, geo = synthetic_batch(B, face=FACE, lip_h=LIP_H, lip_w=LIP_W,
                               with_sync=True)
    # the points path's premise: target and masks are identity constants
    for k in ("rgb_face_zero", "mask_head_canonical", "mask_face_canonical"):
        raw[k] = np.broadcast_to(raw[k][:1], raw[k].shape).copy()
    box = jtf.expanded_lip_box(LIP_H, LIP_W, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window([raw["coord"][i] for i in range(B)], box,
                                 FACE, FACE, margin=4)
    rng = np.random.default_rng(7)
    cfg = jdefault_config()
    cfg["model"]["canonical_depth_height"] = FACE
    cfg["model"]["canonical_depth_width"] = FACE
    jp = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(1), cfg))
    jp["canonical_depth"] = rng.uniform(0.8, 1.2, (FACE, FACE)).astype(
        np.float32)
    jup, jus = unet_params(16, seed=1)
    jlp = _init_like(jlpips.init, jax.random.PRNGKey(2), rng)
    jsp, jss = _init_like(jsyncnet.init, jax.random.PRNGKey(3), rng)
    for tree in (jsp, jss):
        for name in ("face", "audio"):
            _randomize_bn(tree[name], rng)
    ds = types.SimpleNamespace(
        mask_head_canonical=raw["mask_head_canonical"][0],
        mask_face_canonical=raw["mask_face_canonical"][0],
        rgb_face_zero=raw["rgb_face_zero"][0])
    jpts = jax.tree.map(np.asarray, jtrainer._depth_loss_points(ds))
    # the dataset's host static warps of the blackaug branch
    warped = grid_sample_np(raw["rgb_face_zero"], raw["coord"])
    m = grid_sample_np((raw["rgb_face_zero"] > 0).astype(np.float32),
                       raw["coord"])
    static = {"warped_base": warped,
              "blackaug_face_mask": (m == 1.0).astype(np.float32)}
    return types.SimpleNamespace(
        raw=raw, geo=geo, window=window, ds=ds, static=static,
        jax=dict(params=jp, unet=jup, state=jus, lpips=jlp,
                 syncnet=(jsp, jss), pts=jpts))


def _statics(s, **kw):
    base = dict(lip_h=LIP_H, lip_w=LIP_W, lip_x=s.geo["lip_x"],
                lip_y=s.geo["lip_y"], face_h=FACE, face_w=FACE,
                focal=s.geo["focal"], window=s.window,
                face_bbox=(8, 8, 56, 56))
    base.update(kw)
    return jts.StepStatics(**base), tts.StepStatics(**base)


def _jax_draws(key, st, b):
    """The JAX step's draws from ``key``, in its split sequence."""
    keys = jax.random.split(key, 8)

    def lip(k, n):
        k, k_uv, k_audio = jax.random.split(k, 3)
        d = {"eps_u": jax.random.uniform(k, (n,))}
        if st.add_noise_uv:
            d["uv"] = jax.random.normal(k_uv, (st.lip_h * st.lip_w, 2))
        if st.add_noise_audio:
            d["audio"] = jax.random.normal(k_audio, (n, 64))
        return d

    draws = {"lip": lip(keys[0], b)}
    if st.use_blackaug:
        k1, k2, k3 = jax.random.split(keys[1], 3)
        shape = (b, st.face_h, st.face_w, 1)
        draws.update(hole1=jax.random.normal(k1, shape),
                     hole2=jax.random.normal(k2, shape),
                     apply_u=jax.random.uniform(k3, ()))
    if st.sync_on:
        draws["sync_lip"] = lip(keys[2], b * st.sync_T)
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), draws)


def _key_with_blackaug_applied():
    """A step key whose 50% black-hole flag is on, so both noises act."""
    for seed in range(32):
        k = jax.random.PRNGKey(seed)
        k3 = jax.random.split(jax.random.split(k, 8)[1], 3)[2]
        if float(jax.random.uniform(k3, ())) > 0.5:
            return k
    raise AssertionError("no key turns the black-hole augmentation on")


def _port_inputs(s, static=False, dtype=torch.float32):
    p, up, us = weights.from_jax(s.jax["params"], s.jax["unet"],
                                 s.jax["state"])
    frozen = {"lpips": weights.lpips_from_jax(s.jax["lpips"]),
              "syncnet": weights.syncnet_from_jax(*s.jax["syncnet"]),
              "depth_pts": ttrainer.depth_loss_points(
                  s.ds.mask_head_canonical, s.ds.mask_face_canonical,
                  s.ds.rgb_face_zero)}
    raw = dict(s.raw, **s.static) if static else s.raw
    batch = {k: torch.from_numpy(np.array(v)) for k, v in raw.items()}
    return p, up, us, frozen, batch


def _jax_inputs(s, pts: bool, static=False):
    frozen = {"lpips": s.jax["lpips"], "syncnet": s.jax["syncnet"]}
    if pts:
        frozen["depth_pts"] = s.jax["pts"]
    raw = dict(s.raw, **s.static) if static else s.raw
    return frozen, jax.tree.map(jnp.asarray, raw)


def _jax_leaves(tree, like):
    """Leaves of the JAX numpy ``tree`` in the order of the port's tree
    ``like`` (which may hold fewer entries)."""
    if isinstance(like, dict):
        return [x for k in like for x in _jax_leaves(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for i, v in enumerate(like)
                for x in _jax_leaves(tree[i], v)]
    return [np.asarray(tree, np.float32)]


def _rel(got, ref):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    return float(np.max(np.abs(got - ref))) / max(1e-6, float(np.max(
        np.abs(ref))))


def _check_metrics(got, ref, tol):
    ref = {k: float(v) for k, v in ref.items()}
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k, v in ref.items():
        assert abs(float(got[k]) - v) <= tol * max(abs(v), 1e-3), (k, got[k],
                                                                   v)


def _jax_grad_fn(st, frozen, batch, key, us):
    def loss(tr):
        return jts.compute_losses(tr["model"], tr["unet"], us, frozen,
                                  batch, key, st)
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


# the four branches of the canonical-depth loss
BRANCHES = {
    "inverse_warp": dict(pallas_gather=False),           # full-frame gather
    "crop": dict(pallas_gather=False, depth_loss_box="box"),
    "points": dict(pallas_gather=True),                  # K7, frozen pts
    "hat_full_frame": dict(pallas_gather=True, pts=False),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_stage1_losses_and_grads_match_jax(interp, setup, branch):
    s = setup
    kw = dict(BRANCHES[branch])
    pts = kw.pop("pts", kw.get("pallas_gather", False))
    if kw.get("depth_loss_box") == "box":
        kw["depth_loss_box"] = ttrainer.depth_loss_box(
            s.ds.mask_head_canonical, s.ds.mask_face_canonical,
            max_pixels=FACE * FACE)
        assert kw["depth_loss_box"] == jtrainer._depth_loss_box(
            s.ds, max_pixels=FACE * FACE)
    jst, tst = _statics(s, **kw)
    static = branch == "points"  # the trainer's path: host static warps
    key = _key_with_blackaug_applied()
    jfrozen, jbatch = _jax_inputs(s, pts, static)
    jtrain = {"model": s.jax["params"], "unet": s.jax["unet"]}
    (_, (jmetrics, jstate)), jgrads = _jax_grad_fn(
        jst, jfrozen, jbatch, key, s.jax["state"])(jtrain)

    p, up, us, frozen, batch = _port_inputs(s, static)
    if not pts:
        del frozen["depth_pts"]
    grads, metrics, new_state, _ = tts.loss_and_grads(
        p, up, us, frozen, batch, _jax_draws(key, jst, B), tst)
    jg = _jax_leaves(jgrads, {"model": p, "unet": up})
    jmetrics = dict(jmetrics, grad_norm=float(optax.global_norm(jg)))
    _check_metrics(metrics, jmetrics, LOSS_TOL)
    names = [f"model.{i}" for i in range(len(tts.tree_leaves(p)))] + [
        f"unet.{i}" for i in range(len(tts.tree_leaves(up)))]
    scale = max(float(np.max(np.abs(r))) for r in jg)
    for name, g, r in zip(names, grads, jg):
        diff = float(np.max(np.abs(g.numpy() - r)))
        assert diff < GRAD_TOL * scale, (branch, name, diff)
        assert _rel(g, r) < LEAF_TOL, (branch, name, _rel(g, r))
    # train-mode BatchNorm: the updated running statistics
    for a, r in zip(tts.tree_leaves(new_state),
                    _jax_leaves(jstate, new_state)):
        assert _rel(a, r) < LOSS_TOL


def test_sync_stage_train_step_matches_jax(interp, setup):
    """The sync stage (sync loss on, post-net frozen) through one
    ``make_train_step`` step of each package: every loss term and the
    gradient norm agree, Adam moves the model the same way, and the frozen
    U-Net comes back bit-identical."""
    s = setup
    jst, tst = _statics(s, pallas_gather=True, sync_on=True,
                        postnet_frozen=True)
    key = _key_with_blackaug_applied()
    jfrozen, jbatch = _jax_inputs(s, True, static=True)
    cfg = jdefault_config()
    cfg["training"]["learning_rate"] = 1e-3
    jopt = jts.make_optimizer(cfg)
    jtrain = {"model": s.jax["params"], "unet": s.jax["unet"]}
    jstate = jts.TrainState(s.jax["params"], s.jax["unet"], s.jax["state"],
                            jopt.init(jtrain), jnp.asarray(0, jnp.int32))
    jnew, jmetrics = jts.make_train_step(jopt, jst, jfrozen, donate=False)(
        jstate, jbatch, key)

    p, up, us, frozen, batch = _port_inputs(s, static=True)
    opt = tts.make_optimizer(cfg)
    step = tts.make_train_step(opt, tst, frozen)
    new, metrics = step(tts.init_train_state(p, up, us, opt), batch,
                        _jax_draws(key, jst, B))
    assert "loss_sync" in metrics and new.it == 1
    _check_metrics(metrics, jmetrics, LOSS_TOL)
    # frozen U-Net: parameters and BN state untouched, in both packages
    for a, ref in zip(tts.tree_leaves(new.unet_params),
                      tts.tree_leaves(up)):
        assert torch.equal(a, ref)
    for a, r in zip(_jax_leaves(jnew.unet_params, up),
                    _jax_leaves(s.jax["unet"], up)):
        assert np.array_equal(a, r)
    for a, r in zip(tts.tree_leaves(new.unet_state),
                    _jax_leaves(s.jax["state"], new.unet_state)):
        assert np.array_equal(a.numpy(), r)
    # the model's first Adam step is lr * g / (|g| + eps): elements whose
    # gradient is near noise level (|g| ~ eps) move by a fraction of the
    # step that the last float32 bits set (measured up to 43%).  All but 1%
    # of the elements agree to 2% of the step, and none by a whole step
    d = np.concatenate([
        np.abs(a.numpy() - r).ravel() / 1e-3
        for a, r in zip(tts.tree_leaves(new.params),
                        _jax_leaves(jnew.params, p))])
    assert d.max() < 1.0 and (d > 0.02).mean() < 0.01


def test_bfloat16_losses_near_jax(interp, setup):
    """Mixed precision, forward: bf16 rounds at other places in the two
    packages (JAX's hat weights, the port's float32 sampling sums), a few
    bf16 ulps of each loss term."""
    s = setup
    jst, tst = _statics(s, pallas_gather=True, compute_dtype="bfloat16")
    key = _key_with_blackaug_applied()
    jfrozen, jbatch = _jax_inputs(s, True)
    total, (jmetrics, jstate) = jax.jit(
        lambda: jts.compute_losses(s.jax["params"], s.jax["unet"],
                                   s.jax["state"], jfrozen, jbatch, key,
                                   jst))()
    p, up, us, frozen, batch = _port_inputs(s)
    with torch.no_grad():
        _, (metrics, new_state) = tts.compute_losses(
            p, up, us, frozen, batch, _jax_draws(key, jst, B), tst)
    _check_metrics(metrics, jmetrics, 2e-2)
    for a in tts.tree_leaves(new_state):
        assert a.dtype == torch.float32


def test_optimizer_schedule_matches_optax():
    opt = tts.Adam(0.1, milestones=[3, 5], gamma=0.5)
    sched = optax.piecewise_constant_schedule(0.1, {3: 0.5, 5: 0.5})
    for count in range(8):
        # optax's rates are float32
        assert abs(opt.lr(count) - float(sched(count))) < 1e-7 * opt.lr(count)
    # three Adam steps on a small tree, against optax.adam
    rng = np.random.default_rng(0)
    params = [rng.standard_normal((4, 3)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32)
              for p in params] for _ in range(3)]
    jopt = optax.adam(sched)
    jstate = jopt.init([jnp.asarray(p) for p in params])
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for g in grads:
        upd, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = opt.update([torch.from_numpy(x) for x in g], tstate)
        tp = [a + u for a, u in zip(tp, tupd)]
    for a, r in zip(tp, jp):
        assert float(np.max(np.abs(a.numpy() - np.asarray(r)))) < 1e-6


@pytest.mark.parametrize("tr,device,expect", [
    ({}, "cuda", False),
    ({"compute_dtype": "bfloat16", "batch_size": 8}, "cuda", True),
    ({"compute_dtype": "bfloat16", "batch_size": 8}, "cpu", False),
    ({"compute_dtype": "bfloat16", "batch_size": 2}, "cuda", False),
    ({"pallas_gather": True}, "cpu", True),
    ({"pallas_gather": False, "compute_dtype": "bfloat16",
      "batch_size": 8}, "cuda", False),
])
def test_resolve_pallas_gather(tr, device, expect):
    assert ttrainer.resolve_pallas_gather(tr, device) is expect


def test_depth_loss_support_matches_jax(setup):
    s = setup
    assert (ttrainer.depth_loss_box(s.ds.mask_head_canonical,
                                    s.ds.mask_face_canonical)
            == jtrainer._depth_loss_box(s.ds))
    got = ttrainer.depth_loss_points(s.ds.mask_head_canonical,
                                     s.ds.mask_face_canonical,
                                     s.ds.rgb_face_zero)
    for k, v in s.jax["pts"].items():
        assert np.array_equal(got[k].numpy(), v), k
    empty = np.zeros_like(s.ds.mask_head_canonical)
    assert ttrainer.depth_loss_box(empty, s.ds.mask_face_canonical) is None
    assert ttrainer.depth_loss_points(empty, s.ds.mask_face_canonical,
                                      s.ds.rgb_face_zero) is None


def test_frozen_nets_and_losses_match_jax(setup):
    s = setup
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    tl = weights.lpips_from_jax(s.jax["lpips"])
    # jit: eager JAX compiles each op of the nets apart (~10 s here)
    ref = jax.jit(jlosses.perceptual_loss)(s.jax["lpips"], jnp.asarray(x),
                                           jnp.asarray(y))
    got = tlosses.perceptual_loss(tl, torch.from_numpy(x),
                                  torch.from_numpy(y))
    assert _rel(got, ref) < 1e-5
    ref = jax.jit(jlpips.lpips_distance)(s.jax["lpips"],
                                         jnp.asarray(x) * 2 - 1,
                                         jnp.asarray(y) * 2 - 1)
    got = tlpips.lpips_distance(tl, torch.from_numpy(x) * 2 - 1,
                                torch.from_numpy(y) * 2 - 1)
    assert _rel(got, ref) < 1e-5

    mel = rng.standard_normal((2, 80, 16, 1)).astype(np.float32)
    win = rng.uniform(0, 1, (2, T, 96, 96, 3)).astype(np.float32)
    faces = jlosses.sync_window_to_syncnet_input(jnp.asarray(win))
    tfaces = tlosses.sync_window_to_syncnet_input(torch.from_numpy(win))
    assert _rel(tfaces, faces) == 0.0
    ja, jv, _ = jax.jit(jsyncnet.apply)(*s.jax["syncnet"], jnp.asarray(mel),
                                        faces)
    ta, tv = tsyncnet.apply(*weights.syncnet_from_jax(*s.jax["syncnet"]),
                            torch.from_numpy(mel), tfaces)
    assert _rel(ta, ja) < 1e-5 and _rel(tv, jv) < 1e-5
    lab = np.array([1.0, 0.0], np.float32)
    assert _rel(tlosses.cosine_bce_loss(ta, tv, torch.from_numpy(lab)),
                jlosses.cosine_bce_loss(ja, jv, jnp.asarray(lab))) < 1e-5
    mse = np.array(0.0123, np.float32)
    assert _rel(tlosses.psnr_from_mse(torch.from_numpy(mse)),
                jlosses.psnr_from_mse(jnp.asarray(mse))) < 1e-6
    normal = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    normal[0, 0, 0, 0] = 1e-6  # the threshold itself is a hole-free pixel
    assert np.array_equal(
        tlosses.black_hole_noise(torch.from_numpy(normal)).numpy(),
        np.asarray(normal >= 1e-6, np.float32))


def test_unet_train_mode_matches_jax():
    jp, js = unet_params(16, seed=4)
    _, up, us = weights.from_jax(_tf_params(), jp, js)
    x = np.random.default_rng(6).uniform(0, 1, (2, 20, 28, 3)).astype(
        np.float32)
    ref, rstate = jax.jit(lambda p, s, x: junet.apply(p, s, x, train=True))(
        jp, js, jnp.asarray(x))
    got, state = tunet.apply(up, us, torch.from_numpy(x), train=True)
    assert _rel(got, ref) < 1e-4
    for a, r in zip(tts.tree_leaves(state), _jax_leaves(rstate, state)):
        assert _rel(a, r) < 1e-5
    # eval mode hands the state back as it came
    _, same = tunet.apply(up, us, torch.from_numpy(x))
    assert all(same[blk][bn][k] is us[blk][bn][k] for blk in us
               for bn in us[blk] for k in us[blk][bn])


def test_train_step_launches_nothing_on_cpu(setup):
    """On CPU tensors the K2/K7 wrappers run their plain versions."""
    s = setup
    _, tst = _statics(s, pallas_gather=True)
    p, up, us, frozen, batch = _port_inputs(s)
    before = (tws.launches, ths.dsrc_launches, ths.dgrid_launches)
    opt = tts.Adam(1e-4)
    new, metrics = tts.make_train_step(opt, tst, frozen)(
        tts.init_train_state(p, up, us, opt), batch,
        tts.draw_noise(tst, B, generator=torch.Generator().manual_seed(0)))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert (tws.launches, ths.dsrc_launches, ths.dgrid_launches) == before
