"""The yardstick's counts against hand counts."""

import pytest

from vince_bench import counts
from vince_bench.flops import resnet


def _config(backbone, frames):
    return {"backbone": backbone, "batch_size": frames, "input_width": 224, "flops": "resnet"}


def test_one_conv():
    # the stem: 7x7, 3 -> 64, stride 2, 224 -> 112: 2 * 112^2 * 3 * 64 * 49 operations
    assert resnet._conv(112, 3, 64, 7) == 2 * 112 * 112 * 3 * 64 * 49 == 236_027_904


def test_one_batch_norm():
    # bn2 of a ResNet50 stage-1 block at 128 frames: [128, 56, 56, 64] bf16 read twice, written once
    act = 2 * 128 * 56 * 56 * 64
    assert counts.bn_train_bytes(128, 56, 56, 64) == 3 * act == 154_140_672
    assert counts.bn_train_bytes(128, 56, 56, 64, stats_fused=True) == 2 * act


def test_k1_at_128_rows():
    # PERF.md's K1 bound at b = 128, K = 65536, D = 128: 0.0642 ms, f32 operations
    assert counts.k1_bound_s(128, 65536, 128) * 1e3 == pytest.approx(0.0642, abs=5e-5)


def test_k2_at_128_frames():
    # PERF.md's K2 bound over a ResNet50 forward's 13 sites at b = 128: 0.315 ms
    sites = counts.k2_sites(_config("ResNet50", 128))
    assert [s[1:] for s in sites] == [(128, 512)] * 4 + [(256, 1024)] * 6 + [(512, 2048)] * 3
    assert sites[0][0] == 128 * 28 * 28 and sites[-1][0] == 128 * 7 * 7
    assert sum(counts.k2_bound_s(*s) for s in sites) * 1e3 == pytest.approx(0.315, abs=5e-4)


def test_k2_sites_follow_the_port_rule():
    # at 448 frames stage 4's M = 448 * 49 = 21952 is no multiple of 128: no K2 there
    assert len(counts.k2_sites(_config("ResNet50", 448))) == 10
    assert counts.k2_sites(_config("ResNet18", 256)) == []


@pytest.mark.parametrize("backbone, gflop", [("ResNet50", 8.18), ("ResNet18", 3.63)])
def test_encoder_forward(backbone, gflop):
    assert resnet.encoder_flops(backbone, 224, 128) / 1e9 == pytest.approx(gflop, abs=0.01)


def test_step_flops():
    c = dict(_config("ResNet50", 448), vince_embedding_size=128, vince_queue_size=65536,
             self_batch_comparison=True)
    expect = (4 * 448 * resnet.encoder_flops("ResNet50", 224, 128)
              + 4 * 448 * (448 + 65536) * 128 + 6 * 448 * 448 * 128)
    assert counts.step_flops(c) == expect
    assert counts.mfu_pct(counts.BF16_FLOPS, 1.0) == 100.0
