"""The counts behind every share of peak, pinned at the cells' shapes."""

from __future__ import annotations

import json
import os

import pytest

from qbench import flops, peaks

from conftest import ROOT


def shape(name: str) -> flops.ModelShape:
    with open(os.path.join(ROOT, "qbench", "configs", f"{name}.json")) as f:
        conf = json.load(f)
    return flops.ModelShape.from_config(conf["model"], conf["data"])


def test_stacked_conv_at_b16_t256_is_perf_md_bound():
    fl = flops.qconv_flops(16, 256, 13, 256, 256)
    assert fl == 16 * 256 * 13 * 2 * 8 * 256 * 256 * 9
    assert fl == pytest.approx(5.03e11, rel=1e-3)
    assert fl / peaks.BF16_FLOPS * 1e3 == pytest.approx(0.508, abs=1e-3)


@pytest.mark.parametrize("b,t,f,cin,cout", [(16, 256, 13, 256, 256), (16, 512, 40, 1, 256),
                                            (32, 2048, 13, 64, 128), (32, 512, 13, 128, 128)])
def test_half_the_expanded_count(b, t, f, cin, cout):
    """8 real products a quaternion product (the bilinear rank of quaternion
    multiplication), where the 4x-expanded real conv spends 16."""
    from qasr_torch.utils.profiling import qconv_flops

    assert 2 * flops.qconv_flops(b, t, f, cin, cout) == qconv_flops(b, t, f, cin, cout)


def test_timit_qcnn_counts():
    m = shape("timit_qcnn")
    conv = 16 * 1 * 256 * 9 * 40 + 9 * 16 * 256 * 256 * 9 * 13
    dense = 16 * 3328 * 256 + 2 * 16 * 256 * 256
    assert flops.frame_flops(m) == conv + dense + 2 * 1024 * 62
    assert flops.conv_frame_flops(m, stacked_only=True) == 9 * 16 * 256 * 256 * 9 * 13
    # a step of B16 at 300 real frames a row: ~1.6e13 model FLOPs
    assert flops.model_flops(m, 16 * 300, train=True) == pytest.approx(1.61e13, rel=0.01)
    assert flops.recurrence_frame_flops(m) == 0


def test_librispeech_qlstm_counts():
    m = shape("librispeech_qlstm")
    assert flops.tower_width(40, m.conv_features) == 13 * 128
    assert flops.lstm_dims(m) == [1664, 512, 512]
    rec = 3 * 2 * 16 * 256 * 1024
    assert flops.recurrence_frame_flops(m) == rec
    conv = 16 * 64 * 9 * 40 + 16 * 9 * 13 * (64 * 64 + 64 * 128 + 128 * 128)
    inputs = 2 * 16 * 1024 * (1664 + 512 + 512)
    assert flops.frame_flops(m) == conv + inputs + rec + 16 * 512 * 256 + 2 * 1024 * 32


def test_least_seconds_takes_the_larger_bound():
    m = shape("timit_qcnn")
    frames = 16 * 256
    fwd = flops.stacked_conv_least_seconds(m, frames, False, peaks.BF16_FLOPS, peaks.HBM_BYTES)
    assert fwd == pytest.approx(9 * 5.025e11 / peaks.BF16_FLOPS, rel=1e-3)  # compute-bound
    both = flops.stacked_conv_least_seconds(m, frames, True, peaks.BF16_FLOPS, peaks.HBM_BYTES)
    assert both == pytest.approx(3 * fwd, rel=1e-6)
    q = shape("librispeech_qlstm")
    fl = 32 * 2048 * flops.recurrence_frame_flops(q)
    fb, bb = flops.recurrence_bytes(q, 32 * 2048, True)
    assert flops.recurrence_least_seconds(q, 32 * 2048, False, peaks.BF16_FLOPS,
                                          peaks.HBM_BYTES) == \
        max(fl / peaks.BF16_FLOPS, fb / peaks.HBM_BYTES)
    assert bb > fb
