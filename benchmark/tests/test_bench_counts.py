"""The yardstick's arithmetic against counts made by hand."""

import pytest
import torch
from fmbench import roofline


def test_kernel1_call_bytes_and_operations():
    K, T, S, R = 3, 4, 2, 2
    D = R + 2
    aux2 = torch.zeros(K, 2, T)
    gths = [torch.zeros(K, T, D), torch.zeros(K, T, D)]
    wvsl = torch.zeros(K, S, D)
    flags = [torch.zeros(K, dtype=torch.int32) for _ in range(3)]
    n_bytes, flops = roofline.kernel1_call(
        (aux2, gths, wvsl, *flags, S, torch.zeros(D, D)), {})
    read = 4 * (K * 2 * T + 2 * K * T * D + K * S * D + D * D) + 3 * 4 * K
    written = 4 * (K * S * D * D + D * D)
    assert n_bytes == read + written
    # 12 tile rows, each the 10 products of a symmetric 4 x 4 Gram
    assert flops == K * T * 10 * 2


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert roofline.bound(3.35e9, 0.0) == pytest.approx((1.0, "bytes"))
    ms, by = roofline.bound(0.0, 989e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_sweep_flops_by_hand():
    # 2 tables over 10 rows at rank 1 (D = 3): Grams 2 * 10 * 9 * 2;
    # 5 entities' factorisations 5 * 27 / 3; 4 scored rows of
    # (2 + 2) * (1 + 1) operations
    assert roofline.sweep_flops(10, 5, 2, 1, 4) == pytest.approx(
        360 + 45 + 32)
