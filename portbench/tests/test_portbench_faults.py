"""``correct`` catches a broken timed path.  Each test skips the harness's
look for the card and drives the rest of a run on the CPU at a small size,
with the cell's own limits: the sound run comes out correct, and each fault
the cell can have comes out not correct.  (One card: no exchange between
cards to leave out; batch 1 in training: no half batch to leave out.)"""

import pytest

from portbench.core import harness
from portbench.tests import small


def _run(name, tmp_path=None):
    c = small.cell(name)
    if tmp_path is not None:
        c.build_dir = tmp_path
    return harness.run(c, 2 ** 31 + 101, 0.3, False, small.CPU, 0.0)


def _answer_altered(out):
    out = dict(out)
    face = out["face"].clone()
    face[1] = face[1] * 1.1
    out["face"] = face
    return out


def _half_batch(out):
    """The batch's second half left out: its frames repeat the first
    half's."""
    out = dict(out)
    for k in ("lip", "face"):
        if k in out:
            v = out[k].clone()
            h = v.shape[0] // 2
            v[h:2 * h] = v[:h]
            out[k] = v
    return out


@pytest.mark.parametrize("cell", ["serve.dub-b32", "serve.avatar-b8"])
def test_serving_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_answer_altered, _half_batch])
@pytest.mark.parametrize("cell", ["serve.dub-b32", "serve.avatar-b8"])
def test_serving_fault_is_not_correct(cell, fault, monkeypatch):
    from speech2lip_tpu_torch.infer import renderer, static_scene
    if cell == "serve.dub-b32":
        orig = renderer.Renderer.__call__
        monkeypatch.setattr(renderer.Renderer, "__call__",
                            lambda self, *a: fault(orig(self, *a)))
    else:
        orig = static_scene.StaticSceneRenderer.__call__
        monkeypatch.setattr(
            static_scene.StaticSceneRenderer, "__call__",
            lambda self, *a: fault({"face": orig(self, *a)})["face"])
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_training_sound_run_is_correct(tmp_path):
    out = _run("train.stage1-b1", tmp_path)
    assert out["correct"], out["checks"]


def test_training_step_that_keeps_its_state_is_not_correct(tmp_path,
                                                           monkeypatch):
    from speech2lip_tpu_torch.train import train_step as ts
    orig = ts.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def frozen(state, batch, draws):
            _, m = step(state, batch, draws)
            return state, m
        return frozen
    monkeypatch.setattr(ts, "make_train_step", make)
    out = _run("train.stage1-b1", tmp_path)
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_median_gap"]["value"] == pytest.approx(1.0)
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("net", ["params", "unet_params"])
def test_training_step_that_keeps_one_net_is_not_correct(net, tmp_path,
                                                         monkeypatch):
    """One net's update skipped (the lip MLP's, or the U-Net's), the
    other's right: the worst leaf's change catches it."""
    from speech2lip_tpu_torch.train import train_step as ts
    orig = ts.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def half(state, batch, draws):
            s, m = step(state, batch, draws)
            return s._replace(**{net: getattr(state, net)}), m
        return half
    monkeypatch.setattr(ts, "make_train_step", make)
    out = _run("train.stage1-b1", tmp_path)
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_loss_altered_is_not_correct(tmp_path, monkeypatch):
    """The step's reported loss altered where it is produced."""
    from speech2lip_tpu_torch.train import train_step as ts
    orig = ts.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def bent(state, batch, draws):
            s, m = step(state, batch, draws)
            return s, dict(m, loss=m["loss"] * 1.01)
        return bent
    monkeypatch.setattr(ts, "make_train_step", make)
    out = _run("train.stage1-b1", tmp_path)
    assert not out["correct"], out["checks"]
