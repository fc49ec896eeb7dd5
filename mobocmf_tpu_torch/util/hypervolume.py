"""Hypervolume indicator, minimization convention
(counterpart of mobocmf_tpu/util/hypervolume.py, a numpy copy: the port
imports nothing of the JAX package).

The reference scores BO progress with pymoo's HV inside its example
(examples/toy_synthetic_2D_JESMOCMF/toy_synthetic_2D_JESMOCMF.py:533).
Here: an exact sweep for 2 objectives and the exact WFG recursion (While,
Bradstreet & Barone 2012) for more, so campaign metrics are never
Monte-Carlo noisy; `hypervolume_mc` is an independent estimator for
agreement tests.
"""

from __future__ import annotations

import warnings

import numpy as np

# WFG cost is sharply superlinear in front size. Observed fronts grow over a
# campaign, so above this bound the metric path summarizes the front to a
# max-min subset (the greedy objective-space summarizer the reference
# applies to oversized Pareto sets, moop.py:187-219) and returns the
# slightly conservative exact HV of the subset. The same cap as the JAX
# package, so both score the same fronts the same way.
HV_FRONT_CAP = 512


def _pareto_filter(points: np.ndarray, ref: np.ndarray) -> np.ndarray:
    pts = points[np.all(points < ref, axis=1)]
    if pts.shape[0] == 0:
        return pts
    keep = np.ones(pts.shape[0], dtype=bool)
    for i in range(pts.shape[0]):
        if not keep[i]:
            continue
        dominated = np.all(pts <= pts[i], axis=1) & np.any(pts < pts[i], axis=1)
        if dominated.any():
            keep[i] = False
    return pts[keep]


def hypervolume_2d(points: np.ndarray, ref: np.ndarray) -> float:
    """Exact 2-objective hypervolume by sweeping the sorted front."""
    pts = _pareto_filter(np.asarray(points, dtype=float), np.asarray(ref, dtype=float))
    if pts.shape[0] == 0:
        return 0.0
    pts = pts[np.argsort(pts[:, 0])]
    hv = 0.0
    prev_y = ref[1]
    for x, y in pts:
        if y < prev_y:
            hv += (ref[0] - x) * (prev_y - y)
            prev_y = y
    return float(hv)


def _hv_recursive(pts: np.ndarray, ref: np.ndarray) -> float:
    """Exact HV by dimension-sweep recursion (kept for cross-checking WFG)."""
    k = pts.shape[1]
    if k == 2:
        return hypervolume_2d(pts, ref)
    order = np.argsort(pts[:, -1])
    pts = pts[order]
    hv = 0.0
    prev = ref[-1]
    for i in range(pts.shape[0] - 1, -1, -1):
        z = pts[i, -1]
        if z >= prev:
            continue
        slab = prev - z
        upper = _hv_recursive(pts[: i + 1, :-1], ref[:-1])
        hv += slab * upper
        prev = z
    return hv


def _wfg(pts: np.ndarray, ref: np.ndarray) -> float:
    """Exact WFG hypervolume of a mutually nondominated set `pts` (< ref).

    HV(S) = sum_i exclhv(p_i, S_{>i}) with
    exclhv(p, S) = vol(box(p, ref)) - HV({max(p, s) : s in S} pareto-filtered),
    the exclusive-contribution recursion of While, Bradstreet & Barone (2012).
    Points are pre-sorted by the first objective so limit sets collapse fast;
    dominated limit points are pruned before recursing, which is what keeps
    the recursion polynomial in practice for the 4-objective campaign fronts
    (hundreds of points) that previously fell back to Monte Carlo.
    """
    if pts.shape[1] == 2:
        return hypervolume_2d(pts, ref)
    order = np.argsort(pts[:, 0])
    pts = pts[order]
    hv = 0.0
    for i in range(pts.shape[0]):
        p = pts[i]
        box = float(np.prod(ref - p))
        rest = pts[i + 1 :]
        if rest.shape[0] == 0:
            hv += box
            continue
        limit = np.maximum(rest, p)
        keep = np.ones(limit.shape[0], dtype=bool)
        for j in range(limit.shape[0]):
            if not keep[j]:
                continue
            dom = (
                keep
                & np.all(limit <= limit[j], axis=1)
                & np.any(limit < limit[j], axis=1)
            )
            if dom.any():
                keep[j] = False
        limit = limit[keep]
        hv += box - _wfg(limit, ref)
    return hv


def _maxmin_subset(pts: np.ndarray, size: int) -> np.ndarray:
    """Greedy max-min summary of a front in objective space.

    Host-numpy twin of ``moop.summarize_pareto`` (reference
    moop.py:187-219): seed with each objective's argmin, then repeatedly add
    the point whose distance to the chosen set is largest, so the subset
    spans the front's extremes and spreads evenly between them.
    """
    n, k = pts.shape
    chosen = list(dict.fromkeys(int(np.argmin(pts[:, j])) for j in range(k)))
    dmin = np.min(
        np.linalg.norm(pts[:, None, :] - pts[None, chosen, :], axis=-1), axis=1
    )
    while len(chosen) < size:
        nxt = int(np.argmax(dmin))
        chosen.append(nxt)
        dmin = np.minimum(dmin, np.linalg.norm(pts - pts[nxt], axis=-1))
    return pts[np.array(chosen[:size])]


def hypervolume(points: np.ndarray, ref: np.ndarray) -> float:
    """Exact hypervolume of the region dominated by `points`, bounded by `ref`.

    Exact in every dimensionality: 2-objective sweep, WFG recursion otherwise.

    Runtime bound: the 2-objective sweep is O(n log n) at any front size; the
    WFG recursion is capped at ``HV_FRONT_CAP`` front points (measured costs
    in the constant's comment). Larger k>=3 fronts are summarized to a greedy
    max-min subset first — the returned value is then the exact HV of that
    subset, a tight lower bound on the full front's HV (a warning records the
    summarization). The recursion depth can reach the front size, so the
    interpreter limit is raised for the call.
    """
    points = np.atleast_2d(np.asarray(points, dtype=float))
    ref = np.asarray(ref, dtype=float)
    pts = _pareto_filter(points, ref)
    if pts.shape[0] == 0:
        return 0.0
    if pts.shape[1] == 2:
        return hypervolume_2d(pts, ref)
    if pts.shape[0] > HV_FRONT_CAP:
        warnings.warn(
            f"hypervolume: {pts.shape[0]}-point front exceeds HV_FRONT_CAP="
            f"{HV_FRONT_CAP}; scoring the exact HV of a max-min subset "
            "(tight lower bound)",
            stacklevel=2,
        )
        pts = _pareto_filter(_maxmin_subset(pts, HV_FRONT_CAP), ref)
    return _wfg_exact(pts, ref)


def _wfg_exact(pts: np.ndarray, ref: np.ndarray) -> float:
    """Uncapped exact WFG with recursion-limit handling (callers bound size)."""
    import sys

    old_limit = sys.getrecursionlimit()
    needed = pts.shape[0] + 200
    try:
        if needed > old_limit:
            sys.setrecursionlimit(needed)
        return float(_wfg(pts, ref))
    finally:
        sys.setrecursionlimit(old_limit)


def hypervolume_pair(
    opt_points: np.ndarray, rec_points: np.ndarray, ref: np.ndarray
) -> "tuple[float, float]":
    """(hv_opt, hv_rec) scored on a CONSISTENT basis for recommendation gaps.

    ``hypervolume`` summarizes k>=3 fronts larger than ``HV_FRONT_CAP`` to a
    max-min subset (a lower bound). Scoring a gap 100*(opt-rec)/opt with the
    cap applied to each side INDEPENDENTLY is unsound: when only the optimal
    side caps, its lower bound can fall below the exact rec HV and the gap
    goes negative. This scorer keeps both values exact WFG HVs of explicit
    point sets and, when the optimal front must be summarized, unions the
    (possibly itself capped) rec basis into the optimal basis — so the
    optimal basis dominates-or-contains every point the rec side is credited
    with and ``hv_opt >= hv_rec`` holds by construction. The basis stays
    bounded by 2*HV_FRONT_CAP points.
    """
    ref = np.asarray(ref, dtype=float)
    k = ref.shape[0]
    opt_f = _pareto_filter(
        np.atleast_2d(np.asarray(opt_points, dtype=float)).reshape(-1, k), ref
    )
    rec_f = _pareto_filter(
        np.atleast_2d(np.asarray(rec_points, dtype=float)).reshape(-1, k), ref
    )
    if k == 2 or (
        opt_f.shape[0] <= HV_FRONT_CAP and rec_f.shape[0] <= HV_FRONT_CAP
    ):
        return hypervolume(opt_f, ref), hypervolume(rec_f, ref)
    if rec_f.shape[0] > HV_FRONT_CAP:
        warnings.warn(
            f"hypervolume_pair: {rec_f.shape[0]}-point rec front exceeds "
            f"HV_FRONT_CAP={HV_FRONT_CAP}; scoring a max-min subset",
            stacklevel=2,
        )
        rec_f = _pareto_filter(_maxmin_subset(rec_f, HV_FRONT_CAP), ref)
    hv_rec = _wfg_exact(rec_f, ref) if rec_f.shape[0] else 0.0
    if opt_f.shape[0] > HV_FRONT_CAP:
        warnings.warn(
            f"hypervolume_pair: {opt_f.shape[0]}-point optimal front exceeds "
            f"HV_FRONT_CAP={HV_FRONT_CAP}; scoring a max-min subset unioned "
            "with the rec basis (gap stays >= 0)",
            stacklevel=2,
        )
        opt_f = _pareto_filter(
            np.vstack([_maxmin_subset(opt_f, HV_FRONT_CAP), rec_f])
            if rec_f.shape[0]
            else _maxmin_subset(opt_f, HV_FRONT_CAP),
            ref,
        )
    hv_opt = _wfg_exact(opt_f, ref) if opt_f.shape[0] else 0.0
    return hv_opt, hv_rec


def hypervolume_mc(
    points: np.ndarray, ref: np.ndarray, mc_samples: int = 200_000, seed: int = 0
) -> float:
    """Monte-Carlo HV estimator — independent cross-check for the exact path.

    Not used for campaign metrics (the exact WFG path replaced the old
    size-thresholded fallback); kept for agreement tests and sanity checks.
    """
    points = np.atleast_2d(np.asarray(points, dtype=float))
    ref = np.asarray(ref, dtype=float)
    pts = _pareto_filter(points, ref)
    if pts.shape[0] == 0:
        return 0.0
    lo = pts.min(axis=0)
    rng = np.random.default_rng(seed)
    k = pts.shape[1]
    u = rng.uniform(size=(mc_samples, k)) * (ref - lo) + lo
    dominated = np.zeros(mc_samples, dtype=bool)
    for p in pts:
        dominated |= np.all(u >= p, axis=1)
    vol_box = float(np.prod(ref - lo))
    return vol_box * float(dominated.mean())
