"""The work model against counts worked out by hand."""

import pytest

from perfbench import work


def test_one_vit_b32_layer_at_batch_256():
    # attention sub-block: M = 256 x 50 = 12,800 rows of width 768, 12 heads
    ops, nbytes = work.i8_attention_layer(256, 50, 768, 12, causal=False)
    assert ops["int8"] == 2 * 12800 * 768 * 2304 + 2 * 12800 * 768 * 768 == 60_397_977_600
    assert ops["bf16"] == 2 * 2 * 256 * 50 * 50 * 768 == 1_966_080_000
    assert nbytes == 2 * 2 * 12800 * 768 + 4 * 768 * 768 + 8 * 4 * 768 + 8 * 768
    ops, nbytes = work.i8_mlp_layer(256, 50, 768, 3072)
    assert ops == {"int8": 2 * 2 * 12800 * 768 * 3072} and ops["int8"] == 120_795_955_200
    # the layer's least time is its operations at the int8 peak
    assert work.bound_s(ops, nbytes) == pytest.approx(120_795_955_200 / 1979e12)


def test_causal_text_layer_counts_the_lower_triangle():
    ops, _ = work.i8_attention_layer(1, 32, 512, 8, causal=True)
    assert ops["bf16"] == 2 * 2 * (32 * 33 / 2) * 512


def test_one_qwen2_1_5b_layer_at_960_rows():
    # q|k|v (1536 -> 1536 + 2 x 256), o, gate|up (2 x 8960), down
    shapes = [(960, 1536, 2048), (960, 1536, 1536), (960, 1536, 17920), (960, 8960, 1536)]
    want = [6_039_797_760, 4_529_848_320, 52_848_230_400, 26_424_115_200]
    for (M, K, N), w in zip(shapes, want):
        ops, _ = work.w8_gemm(M, K, N)
        assert ops == {"bf16": w}
    ops, nbytes = work.w8_gemm(960, 1536, 2048)
    assert nbytes == 2 * (960 * 1536 + 960 * 2048) + 1536 * 2048 + 4 * 2048 == 10_035_200
    # operations bound it: 6.107 us at the bf16 peak against 2.996 us of bytes
    assert work.bound_s(ops, nbytes) == pytest.approx(6_039_797_760 / 989e12)
    assert nbytes / work.PEAK_BYTES_PER_S == pytest.approx(2.9956e-6, rel=1e-4)


def test_decode_attention_and_head():
    assert work.gqa_decode(960, 64, 12, 128) == {"bf16": 2 * 2 * 960 * 12 * 128 * 64}
    assert work.head(960, 1536, 151936) == {"bf16": 2 * 960 * 1536 * 151936}
    # a prefill of T = 8 new positions after 24 cached ones: 8 x 24 + 36 pairs
    assert work.gqa_prefill(1, 8, 32, 12, 128) == {"bf16": 2 * 2 * 12 * 128 * (8 * 24 + 36)}


def test_peak_seconds_sums_each_type_at_its_own_peak():
    ops = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
    assert work.peak_seconds(ops) == pytest.approx(3.0)
