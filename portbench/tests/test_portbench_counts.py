"""The frozen counts of the yardstick."""

import torch
import pytest

from portbench.counts import flops


def test_unet_convs_of_a_may_frame():
    assert flops.unet_conv_ops(500, 500) / 1e9 == pytest.approx(157.5, abs=0.05)


def test_k3_bound_at_batch_8_is_its_ops():
    # PERF.md's K3 row: 1.274 ms at batch 8, bound by operations
    t, by = flops.bound_s(flops.unet_conv_ops(500, 500, 8),
                          flops.fused_block_bytes(500, 500, 8), "bf16")
    assert by == "ops" and 1e3 * t == pytest.approx(1.274, abs=5e-4)


def test_k1_ops_equal_the_tool_count():
    """K1's count equals ``tools/bench_fused_mlp.ops`` on the renderer's
    arguments at the May lip (9,600 rows) and 8 frames."""
    from speech2lip_tpu_torch.tools import bench_fused_mlp
    w, d = 256, 8
    trunk = [torch.zeros(2 * w if i == 5 else w, w) for i in range(d)]
    a = (torch.zeros(9600, 42), torch.zeros(8, w), torch.zeros(8, w),
         torch.zeros(42, w), torch.zeros(42, w), trunk, None,
         torch.zeros(w, 3), None)
    assert flops.fused_mlp_ops(9600, 8) == bench_fused_mlp.ops(a)
    # about 11.4 GFLOP a frame at batch 8 (the shared projections amortised)
    assert flops.fused_mlp_ops(9600, 8) / 8e9 == pytest.approx(11.39,
                                                               abs=0.01)


def test_serve_and_train_totals():
    s = flops.summary()
    assert s["serve_gflop_frame"] == pytest.approx(169.38, abs=0.01)
    # 3x (ensemble MLP + U-Net + depth warp) + LPIPS 3x on lip and face
    assert 600 < s["train_gflop_iter"] < 700


def test_sync_iteration_at_may_geometry():
    """The sync stage's iteration: six ensemble lip renders (3x), six
    frozen U-Net passes at 500 x 500 (2x), stage 1's depth warp and LPIPS,
    and SyncNet (face encoder 3x, audio encoder 2x)."""
    s = flops.summary()
    assert s["sync_gflop_iter"] == pytest.approx(2766.03, abs=0.01)
    assert flops.syncnet_face_ops() / 1e9 == pytest.approx(2.2238, abs=1e-4)
    assert flops.syncnet_audio_ops() / 1e9 == pytest.approx(0.1968,
                                                            abs=1e-4)
    rows = 4 * 80 * 120
    mlp = rows * (2.0 * 2 * flops.UV_DIM * flops.MLP_WIDTH
                  + flops.mlp_row_ops())
    window = 5 * (3 * mlp + 2 * flops.unet_ops(500, 500))
    assert window / (s["sync_gflop_iter"] * 1e9) == pytest.approx(0.825,
                                                                  abs=1e-3)


def test_alexnet_on_a_frame():
    # 0.714 + 2.286 + 1.194 + 1.592 + 1.062 GFLOP (124^2, 61^2, 30^2 x3)
    assert flops.alexnet_ops(500, 500) / 1e9 == pytest.approx(6.849, abs=1e-3)


def test_avatar_counts_follow_the_benchmark_crop_rule():
    """The avatar's U-Net work is counted over the crop that the
    benchmark's own rule gives, whatever the program under test holds."""
    from portbench.reference import common
    from portbench.tests import small
    s = small.session(small.cell("serve.avatar-b8"))
    s.setup()
    s.window_run(0.05)
    g = common.crop_rule(s.window, s.face, s.face)
    assert g is not None and g["ch"] * g["cw"] < s.face ** 2
    frames = s.batches * s.batch
    s.program = None
    ctx = s.context()
    assert ctx["model_ops"] == flops.serve_frame_ops(
        s.lip["h"], s.lip["w"], g["ch"], g["cw"], frames)
    assert ctx["kernels"]["fused_block"]["bound_s"] == (
        s.batches * flops.fused_block_bound_s(g["ch"], g["cw"], s.batch))
