"""The configurations' blackbox problems, frozen copies of the program's.

- `branin_currin`: constrained Branin-Currin with its multi-fidelity
  pairs, copied from mobocmf_tpu_torch/test_functions/synthetic.py
  (`branin_scaled`, `branin_scaled_low`, `currin`, `currin_low`,
  `disk_constraint`), as mobocmf_tpu_torch/examples/
  example_branin_currin_512.py sets it up.
- `prior`: two objectives and two feasibility-calibrated constraints
  sampled from the MFDGP prior by random Fourier features, copied from
  mobocmf_tpu_torch/bench.py::bench_blackboxes,
  test_functions/prior_problem.py::sample_problem and
  sampling/rff.py::sample_prior / eval_sample.

Any other problem is a file of its own, port_bench/blackboxes/<problem>.py,
that defines `make(config, device)`; a configuration names it by its stem.

The copies live here so that a change to the program does not change the
benchmark's data. `make(config, device)` returns the blackboxes as
(name, is_constraint, threshold, [fn per fidelity]), each fn taking an
(n, d) float64 array and returning (n,) float64 values.
"""

from __future__ import annotations

import importlib.util
import math
import re
from pathlib import Path
from typing import Callable, List, NamedTuple, Sequence

import numpy as np
import torch


class Blackbox(NamedTuple):
    name: str
    is_constraint: bool
    threshold: float
    fns: Sequence[Callable[[np.ndarray], np.ndarray]]


# -- Branin-Currin (synthetic.py) -------------------------------------------


def branin(x1, x2):
    b = 5.1 / (4 * np.pi**2)
    c = 5 / np.pi
    t = 1 / (8 * np.pi)
    return (x2 - b * x1**2 + c * x1 - 6) ** 2 + 10 * (1 - t) * np.cos(x1) + 10


def branin_scaled(x):
    x = np.atleast_2d(np.asarray(x, dtype=float))
    return branin(15.0 * x[:, 0] - 5.0, 15.0 * x[:, 1])


def branin_scaled_low(x):
    x = np.atleast_2d(np.asarray(x, dtype=float))
    hf = branin_scaled(x)
    return 10.0 * np.sqrt(np.maximum(hf, 0.0)) + 2.0 * (x[:, 0] - 0.5) - 3.0 * (3.0 * x[:, 1] - 1.0) - 1.0


def disk_constraint(x, radius: float = 0.5):
    x = np.atleast_2d(np.asarray(x, dtype=float))
    return radius**2 - np.sum((x - 0.5) ** 2, axis=1)


def currin(x):
    x = np.atleast_2d(np.asarray(x, dtype=float))
    x1, x2 = x[:, 0], np.maximum(x[:, 1], 1e-12)
    a = 1 - np.exp(-1.0 / (2 * x2))
    b = (2300 * x1**3 + 1900 * x1**2 + 2092 * x1 + 60) / (100 * x1**3 + 500 * x1**2 + 4 * x1 + 20)
    return a * b


def currin_low(x):
    x = np.atleast_2d(np.asarray(x, dtype=float))
    d = 0.05
    xs = [x + np.array([d, d]), np.clip(x + np.array([d, -d]), 0, 1),
          x + np.array([-d, d]), np.clip(x + np.array([-d, -d]), 0, 1)]
    return 0.25 * sum(currin(np.clip(xx, 0.0, 1.0)) for xx in xs)


def branin_currin(config: dict, device) -> List[Blackbox]:
    return [
        Blackbox("branin", False, 0.0, [branin_scaled_low, branin_scaled]),
        Blackbox("currin", False, 0.0, [currin_low, currin]),
        Blackbox("disk", True, 0.0, [disk_constraint, disk_constraint]),
    ]


# -- MFDGP prior draws by random Fourier features (rff.py) --------------------


def _phi(x, w, b, alpha: float, n_features: int):
    return math.sqrt(2.0 * alpha / n_features) * torch.cos(w @ x.mT + b)


def _sample_prior(gen, d: int, num_fidelities: int, n_features: int, dtype, device):
    """rff.sample_prior: per layer (normals, uniforms, seed) drawn in the
    program's order, then theta; deep layers at the fixed prior kernel."""
    layers = []
    for ell in range(num_fidelities):
        cols = d if ell == 0 else 2 * d + 1
        normals = torch.randn((n_features, cols), generator=gen, dtype=dtype, device=device)
        uniforms = torch.rand((n_features, 1 if ell == 0 else 2), generator=gen, dtype=dtype,
                              device=device)
        torch.randint(0, 2**31 - 1, (1,), generator=gen, device=device)  # the unused theta seed
        layers.append((normals, uniforms))
    out = []
    for ell, (g, u) in enumerate(layers):
        if ell == 0:
            theta = torch.randn((n_features,), generator=gen, dtype=dtype, device=device)
            out.append(dict(w=g / (0.25 * d), b=u * (2.0 * math.pi), alpha=1.0, theta=theta))
            continue
        theta = torch.randn((3 * n_features,), generator=gen, dtype=dtype, device=device)
        ls_x1, ls_f, ls_x2 = 10 * 0.25 * d, 1.0, 0.25 * d
        w_x1, w_f, w_x2 = g[:, :d] / ls_x1, g[:, d:d + 1] / ls_f, g[:, d + 1:] / ls_x2
        out.append(dict(w_x1=w_x1, w_x1f=torch.cat([w_x1, w_f], 1), w_x2=w_x2,
                        b_x1=u[:, :1] * 2 * math.pi, b_x2=u[:, 1:] * 2 * math.pi,
                        a_x1=1.0, a_x1f=1.0, a_x2=0.01, nu_lin=1.0, theta=theta))
    return out


def _eval_sample(sample, x: torch.Tensor, layer: int, n_features: int) -> torch.Tensor:
    f = None
    for ell in range(layer + 1):
        s = sample[ell]
        if ell == 0:
            feats = _phi(x, s["w"], s["b"], s["alpha"], n_features)
        else:
            xf = torch.cat([x, f[:, None]], dim=1)
            feats = torch.cat([
                _phi(x, s["w_x1"], s["b_x1"], s["a_x1"], n_features) * f[None, :]
                * math.sqrt(s["nu_lin"]),
                _phi(xf, s["w_x1f"], s["b_x1"], s["a_x1f"], n_features),
                _phi(x, s["w_x2"], s["b_x2"], s["a_x2"], n_features),
            ], dim=0)
        f = s["theta"] @ feats
    return f


def prior(config: dict, device) -> List[Blackbox]:
    """bench_blackboxes: sample_problem(Generator(device).manual_seed(seed),
    probe = default_rng(probe_seed).uniform((500, d))), float32 draws; a
    constraint is kept once 10-90 % of the probe is feasible and the joint
    feasible share stays >= 5 %."""
    d, nf, nfeat = config["d"], config["num_fidelities"], config["rff_features"]
    dtype = torch.float32
    gen = torch.Generator(device=device).manual_seed(config["problem_seed"])
    objs = [_sample_prior(gen, d, nf, nfeat, dtype, device) for _ in range(2)]
    probe = np.random.default_rng(config["probe_seed"]).uniform(size=(500, d))
    probe_t = torch.as_tensor(probe, dtype=dtype, device=device)
    cons, joint = [], np.ones(500, dtype=bool)
    while len(cons) < config["num_constraints"]:
        for _ in range(30):
            cand = _sample_prior(gen, d, nf, nfeat, dtype, device)
            vals = _eval_sample(cand, probe_t, nf - 1, nfeat).cpu().numpy()
            frac = float((vals >= 0).mean())
            if 0.1 <= frac <= 0.9 and (joint & (vals >= 0)).mean() >= 0.05:
                cons.append(cand)
                joint &= vals >= 0
                break
        else:
            raise ValueError("could not sample a constraint with 10-90% feasibility")

    def fns(sample):
        def at(level):
            def fn(xs):
                x = torch.as_tensor(np.atleast_2d(xs), dtype=dtype, device=device)
                return _eval_sample(sample, x, level, nfeat).double().cpu().numpy()
            return fn
        return [at(level) for level in range(nf)]

    return ([Blackbox(f"obj{i + 1}", False, 0.0, fns(s)) for i, s in enumerate(objs)]
            + [Blackbox(f"con{i + 1}", True, 0.0, fns(s)) for i, s in enumerate(cons)])


PROBLEMS = {"branin_currin": branin_currin, "prior": prior}
BLACKBOXES = Path(__file__).resolve().parent / "blackboxes"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def make(config: dict, device) -> List[Blackbox]:
    """The configuration's problem: one of PROBLEMS, or the `make` of its
    file under BLACKBOXES; a name found in both places or in neither raises."""
    name = config["problem"]
    path = BLACKBOXES / f"{name}.py"
    in_file = bool(NAME.fullmatch(name)) and path.is_file()
    if (name in PROBLEMS) == in_file:
        where = "both in" if in_file else "neither in"
        raise ValueError(f"problem {name!r} is {where} problems.PROBLEMS "
                         f"({', '.join(sorted(PROBLEMS))}) {'and' if in_file else 'nor'} {path}")
    if name in PROBLEMS:
        return PROBLEMS[name](config, device)
    spec = importlib.util.spec_from_file_location(f"port_bench_blackbox_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(config, device)


class Data(NamedTuple):
    """One seed's data, handed to the program and to the reference alike:
    x (n, d) float64 holding values of the configuration's dtype, fidelities (n,), the
    standardized targets per blackbox (float64, shared mean and std over
    fidelities as the BO loop standardizes), the standardized thresholds."""

    x: np.ndarray
    fid: np.ndarray
    names: List[str]
    is_con: List[bool]
    ys: List[np.ndarray]
    thresholds: List[float]


def fidelity_counts(config: dict) -> List[int]:
    """Initial points per fidelity, lowest first: the configuration's
    `n_per_fidelity`, else [n_low, n_high]; one count of at least 1 for
    each of its `num_fidelities`."""
    counts = config.get("n_per_fidelity") or [config["n_low"], config["n_high"]]
    if (len(counts) != config["num_fidelities"]
            or not all(isinstance(c, int) and c >= 1 for c in counts)):
        raise ValueError(f"{config.get('name', 'the configuration')}: {list(counts)} initial "
                         f"points per fidelity, wanted {config['num_fidelities']} counts of 1 or more")
    return list(counts)


def design(config: dict, seed: int, device) -> Data:
    """The initial design of `seed`: sum(fidelity_counts) uniform points in
    [0, 1]^d drawn in one call (numpy default_rng(seed)) in the
    configuration's dtype, the fidelities in blocks, lowest first."""
    counts = fidelity_counts(config)
    x = np.random.default_rng(seed).uniform(size=(sum(counts), config["d"]))
    x = x.astype(config["dtype"]).astype(np.float64)
    fid = np.repeat(np.arange(len(counts)), counts)
    names, is_con, ys, thr = [], [], [], []
    for bb in make(config, device):
        y = np.empty(x.shape[0])
        for level in range(config["num_fidelities"]):
            sel = fid == level
            y[sel] = np.asarray(bb.fns[level](x[sel]), dtype=np.float64).reshape(-1)
        mean, std = float(y.mean()), float(y.std())
        std = std if std > 0 else 1.0
        names.append(bb.name)
        is_con.append(bb.is_constraint)
        ys.append((y - mean) / std)
        thr.append((bb.threshold - mean) / std if bb.is_constraint else 0.0)
    return Data(x, fid, names, is_con, ys, thr)
