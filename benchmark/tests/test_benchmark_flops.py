"""The yardstick's arithmetic against counts made by hand for whisper-small."""

from __future__ import annotations

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from benchlib import flops  # noqa: E402

with open(os.path.join(BENCH, "configs", "whisper-small-int8.json")) as _f:
    SMALL = json.load(_f)["model"]
PEAK = flops.peak_of("NVIDIA H100 80GB HBM3")


def test_encoder_window():
    # stem: conv1 80 -> 768 over 3000 frames, conv2 768 -> 768 over 1500,
    # width 3, 2 operations a multiply-add
    stem = 2 * 80 * 3 * 768 * 3000 + 2 * 768 * 3 * 768 * 1500
    assert stem == 6_414_336_000
    # a layer at 1500 positions: q k v o, fc1 fc2, scores and weighted sum
    layer = 7_077_888_000 + 14_155_776_000 + 6_912_000_000
    assert flops.encoder_flops(SMALL) == stem + 12 * layer == 344_162_304_000


def test_cross_kv_at_1500_positions():
    # K and V of 12 layers, each (1500, 768) @ (768, 768): per request, not
    # per decoded token
    assert flops.cross_kv_flops(SMALL) == 12 * 2 * 2 * 1500 * 768 * 768 == 42_467_328_000


@pytest.mark.parametrize("ctx", [1, 4, 104])
def test_decoder_position(ctx):
    per_layer = 7_077_888 + 9_437_184 + 4 * 768 * ctx + 4 * 768 * 1500
    logits = 2 * 768 * 51865
    assert logits == 79_664_640
    assert flops.decoder_position_flops(SMALL, ctx, logits=True) == 12 * per_layer + logits
    assert flops.decoder_position_flops(SMALL, ctx, logits=False) == 12 * per_layer


def test_request():
    # prefix of 4: 3 prefill positions, then 100 positions with logits
    want = (344_162_304_000 + 42_467_328_000
            + sum(flops.decoder_position_flops(SMALL, c, False) for c in (1, 2, 3))
            + sum(flops.decoder_position_flops(SMALL, c, True) for c in range(4, 104)))
    assert flops.request_flops(SMALL, 4, 100) == want


def test_bytes():
    # int8 linears (1 B) with a 4 B scale an output channel, bf16 tied embedding
    assert flops.decoder_weight_bytes(SMALL, 1.0) == \
        12 * (6 * 768 * 768 + 2 * 768 * 3072 + 4 * (6 * 768 + 3072 + 768)) + 2 * 51865 * 768 \
        == 179_160_576
    # int8 cross-KV of batch 256 over 1500 positions: 7.08 GB of codes,
    # a 4 B scale per (row, head, position) for K and V
    assert flops.kv_bytes(SMALL, 256, 1500, 1.0) == \
        12 * 256 * (2 * 1500 * 768 + 2 * 4 * 12 * 1500) == 7_520_256_000
    assert flops.kv_bytes(SMALL, 2, 10, 2.0) == 12 * 2 * 2 * 10 * 768 * 2


def test_decode_least_time_is_bandwidth_bound_at_batch_256():
    t = flops.decode_least_seconds(SMALL, 256, 4, 100, 1.0, 1.0, 1.0, PEAK)
    step = (flops.decoder_weight_bytes(SMALL, 1.0) + flops.kv_bytes(SMALL, 256, 1500, 1.0)
            ) / PEAK["hbm_bytes_s"]
    assert 100 * step < t < 100 * step * 1.1
    # each part is at least its compute bound
    assert t >= 256 * 100 * flops.decoder_position_flops(SMALL, 4, True) / PEAK["bf16_flops"]


def test_peaks():
    assert PEAK == {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12}
