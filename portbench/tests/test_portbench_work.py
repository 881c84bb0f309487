"""Work counts against hand counts at small shapes and against the bytes of
the port's kernel table (PERF.md)."""

import pytest

from portbench import work


def test_k1_bytes_of_the_kernel_table():
    assert work.k1_launch(64)[1] == pytest.approx(134.7e6, rel=1e-3)
    assert work.k1_launch(256)[1] == pytest.approx(539e6, rel=1e-3)


def test_k2_bytes_of_the_kernel_table():
    assert work.k2_launch(32)[1] == pytest.approx(539e6, rel=1e-3)


def test_k4_bytes_of_the_kernel_table():
    """One layer of 321 x 64-token int8 pages, 4096 wide (32 kv heads of 128),
    8 slots holding 9665 tokens, 40-page table rows."""
    lengths = [0, 300, 517, 1024, 1500, 2047, 2500, 1777]
    assert sum(lengths) == 9665
    assert work.k4_launch(lengths, 32, 32, 128, 40)[1] == pytest.approx(81.9e6, rel=1e-3)


def test_hand_counts_at_small_shapes():
    # K1: 2 frames, 3 tokens, width 4 in 2 heads of 2: scores and product.
    assert work.k1_launch(2, tokens=3, width=4, heads=2) == (4 * 2 * 2 * 3 * 3 * 2, 4 * 2 * 3 * 4 * 2)
    # K2: 1 window of 2 frames, 3 tokens, width 4 in 2 heads.
    assert work.k2_launch(1, frames=2, tokens=3, width=4, heads=2) == (
        4 * 1 * 3 * 2 * 2 * 2 * 2, 1 * 2 * 3 * 4 * 4 * 2)
    # K4: two slots of 3 and 5 tokens, 2 heads over 1 kv head of 4, table of 2 pages.
    assert work.k4_launch([3, 5], 2, 1, 4, 2) == (
        4 * 8 * 2 * 4, 8 * (2 * 4 + 2 * 4) + 2 * 2 * 4 * 4 * 2 + 2 * 2 * 2 * 4 + 2 * 2 * 4)


def test_tower_ops_are_the_encoder_count_with_the_temporal_scores():
    vis = {"hidden_size": 1024, "intermediate_size": 4096, "image_size": 224, "patch_size": 14,
           "add_time_attn": True, "num_frames": 8}
    n, d = 257, 1024
    encoder = 32 * n * d * d + 4 * n * n * d  # scripts/profile_torch_encoder.py's count
    patch = 2 * 256 * 588 * d
    assert work.tower_frame_ops(vis, 23) == 23 * (encoder + 4 * n * 8 * d) + patch
    # 256 frames through 23 layers: the 52.4 TFLOP of the kernel table's encode.
    assert 256 * work.tower_frame_ops(vis, 23) == pytest.approx(52.4e12, rel=0.01)


def test_lm_counts():
    lm = {"hidden_size": 8, "intermediate_size": 16, "num_attention_heads": 2,
          "num_key_value_heads": 1, "num_hidden_layers": 3, "vocab_size": 10}
    per_token = 3 * 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16)
    assert work.lm_token_ops(lm) == per_token
    assert work.prefill_ops(lm, 4) == 4 * per_token + 4 * 3 * 2 * 4 * 10 + 2 * 8 * 10
    assert work.decode_ops(lm, 6) == per_token + 4 * 3 * 2 * 4 * 7 + 2 * 8 * 10
