"""The port's numpy copy of the hypervolume module against the JAX
package's: the exact HV, the paired (rec, optimal) scorer with and without
its front cap, and the Monte-Carlo estimator, on random fronts of 2-4
objectives, to rtol 1e-12."""

import warnings

import numpy as np
import pytest

from mobocmf_tpu.util import hypervolume as JH
from mobocmf_tpu_torch.util import hypervolume as PH
from torch_threads import one_intra_op_thread  # noqa: F401


def _front(seed, n, k):
    """Points near a concave front with dominated ones among them."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(size=(n, k))
    pts = d / np.linalg.norm(d, axis=1, keepdims=True)
    return pts + 0.3 * rng.uniform(size=(n, k)) * (rng.uniform(size=(n, 1)) < 0.3)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_hypervolume_matches_jax(k):
    ref = np.full(k, 1.6)
    for seed in range(3):
        pts = _front(seed, 40, k)
        want = JH.hypervolume(pts, ref)
        assert want > 0
        np.testing.assert_allclose(PH.hypervolume(pts, ref), want, rtol=1e-12)
    assert PH.hypervolume(np.full((3, k), 2.0), ref) == 0.0


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("cap", [None, 12], ids=["uncapped", "front-cap"])
def test_hypervolume_pair_matches_jax(k, cap, monkeypatch):
    """With the cap lowered to 12 points the 3- and 4-objective fronts of
    40 points are summarized, on both sides as in the JAX package."""
    if cap is not None:
        monkeypatch.setattr(JH, "HV_FRONT_CAP", cap)
        monkeypatch.setattr(PH, "HV_FRONT_CAP", cap)
    ref = np.full(k, 1.6)
    opt, rec = _front(5, 40, k), _front(6, 30, k) + 0.05
    want = JH.hypervolume_pair(opt, rec, ref)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = PH.hypervolume_pair(opt, rec, ref)
    assert bool(caught) == bool(cap and k > 2)  # the summarizing path ran
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[0] >= got[1] > 0
    np.testing.assert_allclose(PH.hypervolume_pair(opt, np.zeros((0, k)), ref),
                               JH.hypervolume_pair(opt, np.zeros((0, k)), ref), rtol=1e-12)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_hypervolume_mc_matches_jax(k):
    ref = np.full(k, 1.6)
    pts = _front(9, 25, k)
    want = JH.hypervolume_mc(pts, ref, mc_samples=20000, seed=3)
    np.testing.assert_allclose(PH.hypervolume_mc(pts, ref, mc_samples=20000, seed=3), want,
                               rtol=1e-12)
    # and the estimator agrees with the exact value to its own noise
    exact = PH.hypervolume(pts, ref)
    assert abs(want - exact) < 0.05 * exact


def test_maxmin_subset_and_2d_sweep_match_jax():
    pts = _front(11, 60, 3)
    np.testing.assert_array_equal(PH._maxmin_subset(pts, 10), JH._maxmin_subset(pts, 10))
    p2 = _front(12, 50, 2)
    ref = np.array([1.5, 1.7])
    np.testing.assert_allclose(PH.hypervolume_2d(p2, ref), JH.hypervolume_2d(p2, ref),
                               rtol=1e-12)
    np.testing.assert_allclose(PH._hv_recursive(PH._pareto_filter(pts, np.full(3, 1.6)),
                                                np.full(3, 1.6)),
                               PH.hypervolume(pts, np.full(3, 1.6)), rtol=1e-12)
