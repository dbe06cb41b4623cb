"""The work counts against hand counts."""

from __future__ import annotations

import pytest

from benchmark import roofline


def test_search_work_by_hand():
    # 2 queries, 3 items, 4 dims: 2 * 3 * 4 multiply-adds, two ops each
    assert roofline.search_flops(2, 3, 4) == 48
    # bf16 corpus 3 x 4 and queries 2 x 4 read once; 2 x 5 answers of an
    # int64 id and an f32 score written once
    assert roofline.search_bytes(2, 3, 4, 5) == (12 + 8) * 2 + 10 * 12


def test_least_time_takes_the_larger_bound():
    ops_bound = roofline.search_least_seconds(4096, 1 << 20, 32, 100)
    assert ops_bound == pytest.approx(2 * 4096 * (1 << 20) * 32 / 989e12)
    bytes_bound = roofline.search_least_seconds(1, 1 << 20, 32, 20)
    assert bytes_bound == pytest.approx(((1 << 20) + 1) * 32 * 2 / 3.35e12
                                        + 20 * 12 / 3.35e12)


def test_training_flops_by_hand():
    config = {"hidden_size": 2, "intermediate_size": 3, "num_hidden_layers": 1}
    # one text of 2 tokens: per token 2 * (4 * 2 * 2 + 2 * 2 * 3) = 56,
    # attention 2 * 2 * n^2 * H = 2 * 2 * 4 * 2 = 32
    assert roofline.encoder_forward_flops(config, 2, 4) == 2 * 56 + 32
    assert roofline.train_step_flops(config, 2, 4) == 3 * (2 * 56 + 32)
    two_layers = dict(config, num_hidden_layers=2)
    assert roofline.encoder_forward_flops(two_layers, 2, 4) == 2 * 144
