"""The operation and byte counts behind mfu.* and k*_roofline.* against
counts made by hand at small shapes."""

import pytest

from port_bench.metrics import _flops as F


def test_entry_flops():
    assert F.entry_flops(0, 2) == 8  # 2 differences, 2 scales, 2 squares + 1 sum... 3d + 2
    assert F.entry_flops(1, 2) == 2 * 8 + 10


def test_layer_state_by_hand():
    # m = 2, layer 0, d = 1: Gram triangle 3 entries x 5, factor 8/3, two
    # solves 4 + 8/3, back solve 4 + 4
    assert F.layer_state_flops(0, 2, 1) == pytest.approx(15 + 8 / 3 + 4 + 8 / 3 + 4 + 4)


def test_predictive_and_step_by_hand():
    # m = 2, n = 3, layer 0, d = 1: 6 entries x 5, 2 x 4 x 3, 8 x 6
    assert F.predictive_flops(0, 2, 3, 1) == 30 + 24 + 48
    per_layer0 = 3 * (F.layer_state_flops(0, 2, 1) + F.predictive_flops(0, 2, 2, 1) + F.kl_flops(2))
    per_layer0 += -2 * 8 / 3 + (8 / 3 + 16) + 20 + 10 * (4 + 2 + 2)
    assert F.step_flops(1, 1, 2, 2, 1) == pytest.approx(per_layer0)
    assert F.step_flops(3, 1, 2, 2, 1) == pytest.approx(3 * per_layer0)


def test_bounds_by_hand():
    # K1: B = 1, n = 3: 9 flops against 18 words = 72 bytes at float32
    assert F.chol_bound_s(1, 3, "float32") == pytest.approx(max(9 / 67e12, 72 / 3.35e12))
    # B = 2, n = 512 at float64: 2 x 512^3 / 3 flops against 2 x 2 x 512^2 x 8 bytes
    assert F.chol_bound_s(2, 512, "float64") == pytest.approx(
        max(2 * 512**3 / 3 / 67e12, 2 * 2 * 512**2 * 8 / 3.35e12))


def test_cond_step_adds_the_pareto_rows():
    s = dict(B=2, F=2, m=4, d=1, P=3)
    assert F.cond_step_flops(s) == pytest.approx(F.step_flops(2, 2, 4, 4 + 3 + 10, 1) + 20 * 2 * 3 * 10)
    assert F.train_step_flops(s) == F.step_flops(2, 2, 4, 4, 1)
