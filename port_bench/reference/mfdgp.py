"""Plain PyTorch reference of the multi-fidelity deep GP (MFDGP), its ELBO
and the Pareto-conditioned loss, written from the model's equations
(Hernandez-Munoz et al., "Multi-fidelity deep GPs for constrained
multi-objective BO"; the reference code MOBOCMF) for the benchmark's
comparison. It imports nothing of the program under test and runs in
whatever dtype its inputs have (float64 for the comparison).

Parameters are a flat dict of tensors with a leading blackbox dim B:

    l0.raw_lengthscale (B, d)  l0.raw_outputscale (B,)  l0.mean (B, m)  l0.chol_raw (B, m, m)
    l<k>.kx1.raw_lengthscale / .kx1.raw_outputscale / .kf.* / .kx2.* / .klin.raw_variance
    raw_noises (B, F)

Layer 0 is a scale-RBF SVGP on x; layer k > 0 an SVGP on [x, f_{k-1}(x)]
under k = k_x1(x) (k_lin(f) + k_f(f)) + k_x2(x). The inducing inputs of
layer k > 0 are [z_x, mu_{k-1}(Z_{k-1})], the previous layer's mean at its
own inducing inputs. Kernel parameters are softplus-positive, noises
sigmoid-bounded in (lower, upper).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
F32_EPS = float(np.finfo(np.float32).eps)
MIN_VARIANCE = 1e-12


class Consts(NamedTuple):
    z_x: List[torch.Tensor]  # per layer (m, d), shared by the blackboxes
    noise_lower: torch.Tensor  # (B, F)
    noise_upper: torch.Tensor  # (B, F)
    jitter: float
    num_fidelities: int
    floor: float = 0.0  # jitter floor per unit of mean diagonal (4 eps_f32 at float32)


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def inv_softplus(y: np.ndarray) -> np.ndarray:
    y = np.asarray(y, dtype=np.float64)
    return np.where(y > 20.0, y, np.log(np.expm1(np.minimum(y, 20.0))))


def noise(params: Params, c: Consts, layer: int) -> torch.Tensor:
    lo, up = c.noise_lower[:, layer], c.noise_upper[:, layer]
    return lo + (up - lo) * torch.sigmoid(params["raw_noises"][:, layer])


# -- kernels (direct differences, leading blackbox dim) -----------------------


def rbf(raw_ls, raw_os, x1, x2):
    """outputscale * exp(-0.5 sum_d ((x1_d - x2_d) / ls_d)^2): (B, n1, n2)."""
    ls = softplus(raw_ls)[:, None, None, :]
    diff = (x1.unsqueeze(-2) - x2.unsqueeze(-3)) / ls
    return softplus(raw_os)[:, None, None] * torch.exp(-0.5 * torch.sum(diff * diff, -1))


def gram(params: Params, layer: int, a, b):
    """Layer `layer`'s kernel between a and b ((n, d) shared or (B, n, d))."""
    p = f"l{layer}."
    if layer == 0:
        return rbf(params[p + "raw_lengthscale"], params[p + "raw_outputscale"], a, b)
    xa, fa = a[..., :-1], a[..., -1:]
    xb, fb = b[..., :-1], b[..., -1:]
    kx1 = rbf(params[p + "kx1.raw_lengthscale"], params[p + "kx1.raw_outputscale"], xa, xb)
    kf = rbf(params[p + "kf.raw_lengthscale"], params[p + "kf.raw_outputscale"], fa, fb)
    klin = softplus(params[p + "klin.raw_variance"])[:, None, None] * (fa @ fb.mT)
    kx2 = rbf(params[p + "kx2.raw_lengthscale"], params[p + "kx2.raw_outputscale"], xa, xb)
    return kx1 * (klin + kf) + kx2


def gram_diag(params: Params, layer: int, a):
    p = f"l{layer}."
    if layer == 0:
        return softplus(params[p + "raw_outputscale"])[:, None] * torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    f = a[..., -1]
    return (softplus(params[p + "kx1.raw_outputscale"])[:, None]
            * (softplus(params[p + "klin.raw_variance"])[:, None] * f * f
               + softplus(params[p + "kf.raw_outputscale"])[:, None])
            + softplus(params[p + "kx2.raw_outputscale"])[:, None])


# -- layer states, predictive, KL ---------------------------------------------


class State(NamedTuple):
    z: torch.Tensor
    lk: torch.Tensor  # chol(Kzz + j I)
    w_mean: torch.Tensor  # L^-1 m
    w_ls: torch.Tensor  # L^-1 L_S


def jitter_for(k: torch.Tensor, jitter: float, floor: float) -> torch.Tensor:
    """The jitter the configuration states: `jitter`, floored at `floor`
    times the mean |diagonal| (per matrix, not differentiated); a float32
    configuration states the floor 4 eps_f32, a float64 one none."""
    scale = torch.mean(torch.abs(torch.diagonal(k.detach(), dim1=-2, dim2=-1)), dim=-1)
    return torch.clamp(floor * scale, min=jitter)


def states(params: Params, c: Consts) -> List[State]:
    out, chain = [], None
    for ell in range(c.num_fidelities):
        z_x = c.z_x[ell]
        if ell == 0:
            z = z_x
        else:
            z = torch.cat([z_x.expand(chain.shape[:1] + z_x.shape), chain.unsqueeze(-1)], -1)
        k = gram(params, ell, z, z)
        eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
        lk = torch.linalg.cholesky(k + jitter_for(k, c.jitter, c.floor)[:, None, None] * eye)
        mean, ls = params[f"l{ell}.mean"], torch.tril(params[f"l{ell}.chol_raw"])
        sol = torch.linalg.solve_triangular(lk, torch.cat([mean.unsqueeze(-1), ls], -1),
                                            upper=False)
        out.append(State(z, lk, sol[..., 0], sol[..., 1:]))
        # the layer's mean at its inducing inputs: m - j (Kzz + j I)^-1 m
        back = torch.linalg.solve_triangular(lk.mT, sol[..., :1], upper=True)[..., 0]
        chain = mean - c.jitter * back
    return out


def predict(params: Params, st: State, layer: int, x):
    """Marginal q(f(x)) of one layer: (mu, var), each (B, n)."""
    kzx = gram(params, layer, st.z, x)
    w = torch.linalg.solve_triangular(st.lk, kzx, upper=False)
    mu = (w.mT @ st.w_mean.unsqueeze(-1))[..., 0]
    b = st.w_ls.mT @ w
    var = gram_diag(params, layer, x) - torch.sum(w * w, -2) + torch.sum(b * b, -2)
    return mu, torch.clamp(var, min=MIN_VARIANCE)


def forward(params: Params, c: Consts, sts: List[State], x, eps) -> List[Tuple]:
    """Every layer's (mu, var) at x (n, d), sampling each layer's output
    with eps (B, F-1, n) before it feeds the next."""
    outs, f = [], None
    for ell in range(c.num_fidelities):
        if ell == 0:
            mu, var = predict(params, sts[0], 0, x)
        else:
            xb = x.expand(f.shape[:1] + x.shape)
            mu, var = predict(params, sts[ell], ell, torch.cat([xb, f.unsqueeze(-1)], -1))
        outs.append((mu, var))
        if ell + 1 < c.num_fidelities:
            f = mu + torch.sqrt(var) * eps[:, ell, :]
    return outs


def kl(params: Params, c: Consts, sts: List[State]) -> torch.Tensor:
    total = 0.0
    for ell, st in enumerate(sts):
        ls = torch.tril(params[f"l{ell}.chol_raw"])
        logdet = lambda l: 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(l, dim1=-2, dim2=-1))), -1)  # noqa: E731
        total = total + 0.5 * (torch.sum(st.w_ls ** 2, (-2, -1)) + torch.sum(st.w_mean ** 2, -1)
                               - st.w_mean.shape[-1] - logdet(ls) + logdet(st.lk))
    return total


def expected_log_prob(y, mu, var, nz):
    return -0.5 * (torch.log(2.0 * math.pi * nz) + ((y - mu) ** 2 + var) / nz)


def data_term(params, c, outs, y, fid, w):
    total = 0.0
    for i in range(c.num_fidelities):
        mu, var = outs[i]
        ll = expected_log_prob(y, mu, var, noise(params, c, i)[:, None])
        total = total + torch.sum(torch.where(fid == i, ll, torch.zeros_like(ll)) * w, -1)
    return total


def neg_elbo(params: Params, c: Consts, x, y, fid, w, eps, num_data):
    """(-ELBO, scaled KL) per blackbox, full batch with row weights w."""
    sts = states(params, c)
    outs = forward(params, c, sts, x, eps)
    scaled_kl = kl(params, c, sts) * torch.sum(w) / num_data
    return -(data_term(params, c, outs, y, fid, w) - scaled_kl), scaled_kl


# -- the conditioned loss -----------------------------------------------------


def ndtr(x):
    return 0.5 * torch.erfc(-x / math.sqrt(2.0))


def cond_loss(params: Params, c: Consts, num_obj: int, x, ys, fid, w, pareto_set, front,
              front_mask, thresholds, x_tilde, eps, eps_const: float = 1e-8):
    """Objectives then constraints stacked on dim 0: the ELBO terms, the
    Pareto data term of each objective (front at the top fidelity), theta of
    each constraint at the Pareto set and omega at x_tilde, full batch."""
    n = x.shape[0]
    top = c.num_fidelities - 1
    sts = states(params, c)
    rows = torch.cat([x, pareto_set, x_tilde], 0)
    outs = forward(params, c, sts, rows, eps)
    nb, npar = n, pareto_set.shape[0]
    outs_b = [(mu[:, :nb], var[:, :nb]) for mu, var in outs]
    mu_top, var_top = outs[top]
    mu_p, var_p = mu_top[:, nb:nb + npar], var_top[:, nb:nb + npar]
    mu_t, var_t = mu_top[:, nb + npar:], var_top[:, nb + npar:]
    n_real = torch.sum(w)
    elbo = data_term(params, c, outs_b, ys, fid, w) - kl(params, c, sts) * torch.sum(w) / n_real
    losses = -elbo / torch.clamp(torch.sum(w), min=1.0) * n_real
    fw = front_mask.to(x.dtype)
    ll = expected_log_prob(front.mT, mu_p[:num_obj], var_p[:num_obj],
                           noise(params, c, top)[:num_obj, None])
    obj_terms = losses[:num_obj] - torch.sum(ll * fw, -1)
    cdf = ndtr((mu_p[num_obj:] - thresholds[:, None]) / torch.sqrt(var_p[num_obj:]))
    theta = torch.sum((math.log(1.0 - eps_const) * cdf + math.log(eps_const) * (1.0 - cdf)) * fw, -1)
    con_terms = losses[num_obj:] - theta
    g_c = (mu_t[num_obj:] - thresholds[:, None]) / torch.sqrt(var_t[num_obj:])
    g_f = (front[:, :, None] - mu_t[None, :num_obj]) / torch.sqrt(var_t[None, :num_obj])
    q = torch.prod(ndtr(g_c), 0)[None, :] * torch.prod(ndtr(g_f), 1)
    omega = torch.sum((math.log(eps_const) * q + math.log(1.0 - eps_const) * (1.0 - q)) * fw[:, None])
    return torch.sum(obj_terms) + torch.sum(con_terms) - omega


# -- Adam ---------------------------------------------------------------------


def adam_steps(params: Params, masks: Dict[str, float], lr: float, loss_fn, steps: int,
               state: Optional[tuple] = None):
    """`steps` Adam steps (b1 0.9, b2 0.999, eps 1e-8) on the sum of
    loss_fn(params, step)'s first output, gradients multiplied by their
    leaf's mask, from a fresh state or from `state` = (first moments,
    second moments, steps already taken). Returns (params after, [outputs
    of each step], the first masked gradient)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    if state is None:
        state = ({k: torch.zeros_like(v) for k, v in p.items()},
                 {k: torch.zeros_like(v) for k, v in p.items()}, 0)
    m = {k: state[0][k].clone() for k in p}
    v2 = {k: state[1][k].clone() for k in p}
    outs, first = [], None
    for t in range(state[2] + 1, state[2] + steps + 1):
        out = loss_fn(p, t - 1 - state[2])
        grads = torch.autograd.grad(torch.sum(out[0]), list(p.values()), allow_unused=True)
        outs.append(tuple(o.detach() for o in out))
        g = {k: (torch.zeros_like(p[k]) if gk is None else gk) * masks[k]
             for k, gk in zip(p, grads)}
        if first is None:
            first = {k: gk.clone() for k, gk in g.items()}
        with torch.no_grad():
            for k in p:
                m[k] = 0.9 * m[k] + 0.1 * g[k]
                v2[k] = 0.999 * v2[k] + 0.001 * g[k] * g[k]
                mhat = m[k] / (1 - 0.9 ** t)
                vhat = v2[k] / (1 - 0.999 ** t)
                p[k] -= lr * mhat / (torch.sqrt(vhat) + 1e-8)
    return {k: v.detach() for k, v in p.items()}, outs, first


def masks_for(params: Params, kind: str) -> Dict[str, float]:
    """all_free: every leaf; fix_cond: the variational means and factors only."""
    if kind == "all_free":
        return {k: 1.0 for k in params}
    if kind == "fix_cond":
        return {k: float(k.endswith(".mean") or k.endswith(".chol_raw")) for k in params}
    raise ValueError(kind)


# -- initialization (host, float64) --------------------------------------------


def _median_lengthscale(x: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, -1)[np.triu_indices(n, k=1)]
    if d2.size == 0:
        return np.asarray(1.0)
    med = max(float(np.median(d2)), 0.0)
    return np.asarray(np.sqrt(med) if med > 0 else 1.0)


def _rbf_np(ls, os_, a, b):
    diff = (a[:, None, :] - b[None, :, :]) / ls
    return os_ * np.exp(-0.5 * np.sum(diff * diff, -1))


def init(x: np.ndarray, y: np.ndarray, fid: np.ndarray, num_fidelities: int, jitter: float,
         held=np.float32):
    """One blackbox's initial parameters (B = 1), as values of the dtype
    `held` in float64 arrays, from its padded training rows: per layer the median
    lengthscale of the layer's fidelity rows, inducing x = every row, each
    inducing value the target of the nearest row of that fidelity; q(u) =
    N(values, 1e-8 I) below the top layer and N(values, K0 (1e-2 std_top^2)^2)
    at it; noises in (1e-8, 0.1 std_f), initially 1e-2 std_top at the top and
    1e-6 below. Returns (params, z_x per layer, noise lower, noise upper)."""
    def _f32(a):  # the configuration's dtype, held in float64
        return np.asarray(a, dtype=np.float64).astype(held).astype(np.float64)

    d = x.shape[1]
    y_top = float(np.std(y[fid == num_fidelities - 1]))
    params, zs, lo, up, raw_noise = {}, [], [], [], []
    for ell in range(num_fidelities):
        sel = fid == ell
        z = x
        d2 = np.sum((z[:, None, :] - x[sel][None, :, :]) ** 2, -1)
        values = y[sel][np.argmin(d2, axis=1)]
        zs.append(z)
        ls0 = np.broadcast_to(_median_lengthscale(x[sel]), (d,))
        p = f"l{ell}."
        if ell == 0:
            kp = {"raw_lengthscale": inv_softplus(ls0), "raw_outputscale": inv_softplus(1.0)}
        else:
            kp = {"kx1.raw_lengthscale": inv_softplus(10.0 * ls0),
                  "kx1.raw_outputscale": inv_softplus(1.0),
                  "kf.raw_lengthscale": inv_softplus(np.ones(1)),
                  "kf.raw_outputscale": inv_softplus(1.0),
                  "kx2.raw_lengthscale": inv_softplus(ls0),
                  "kx2.raw_outputscale": inv_softplus(0.01),
                  "klin.raw_variance": inv_softplus(1.0)}
        kp = {k: _f32(v) for k, v in kp.items()}
        if ell == num_fidelities - 1:
            sp = lambda r: np.log1p(np.exp(-np.abs(r))) + np.maximum(r, 0)  # noqa: E731
            zf = z if ell == 0 else np.concatenate([z, values[:, None]], 1)
            if ell == 0:
                k0 = _rbf_np(sp(kp["raw_lengthscale"]), sp(kp["raw_outputscale"]), zf, zf)
            else:
                xa, fa = zf[:, :-1], zf[:, -1:]
                k0 = (_rbf_np(sp(kp["kx1.raw_lengthscale"]), sp(kp["kx1.raw_outputscale"]), xa, xa)
                      * (sp(kp["klin.raw_variance"]) * fa @ fa.T
                         + _rbf_np(sp(kp["kf.raw_lengthscale"]), sp(kp["kf.raw_outputscale"]), fa, fa))
                      + _rbf_np(sp(kp["kx2.raw_lengthscale"]), sp(kp["kx2.raw_outputscale"]), xa, xa))
            cov = (k0 + jitter * np.eye(len(z))) * (1e-2 * y_top ** 2) ** 2
            scale = float(np.mean(np.diag(cov)))
            for rel in (0.0, 1e-12, 1e-9, 1e-6, 1e-3):
                try:
                    chol = np.linalg.cholesky(cov + rel * scale * np.eye(len(z)))
                    break
                except np.linalg.LinAlgError:
                    continue
            else:
                raise np.linalg.LinAlgError("init covariance not factorizable")
        else:
            chol = np.sqrt(1e-8) * np.eye(len(z))
        params.update({p + k: v for k, v in kp.items()})
        params[p + "mean"] = _f32(values)
        params[p + "chol_raw"] = _f32(chol)
        std_f = float(np.std(y[fid == ell]))
        lo.append(1e-8)
        up.append(0.1 * std_f)
        init_noise = 1e-2 * y_top if ell == num_fidelities - 1 else 1e-6
        t = np.clip((init_noise - 1e-8) / (0.1 * std_f - 1e-8), 1e-12, 1 - 1e-12)
        raw_noise.append(np.log(t) - np.log1p(-t))
    params["raw_noises"] = _f32(raw_noise)
    return params, [_f32(z) for z in zs], _f32(lo), _f32(up)


def init_stacked(x, ys, fid, num_fidelities: int, jitter: float, dtype, device,
                 held=np.float32):
    """init() of every blackbox stacked on dim 0, as tensors, and the Consts;
    `held` is the configuration's dtype, which the values are rounded to
    (its jitter floor: 4 eps at float32, none at float64)."""
    parts = [init(x, y, fid, num_fidelities, jitter, held) for y in ys]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    params = {k: torch.stack([t(p[0][k]) for p in parts]) for k in parts[0][0]}
    consts = Consts(z_x=[t(z) for z in parts[0][1]],
                    noise_lower=torch.stack([t(p[2]) for p in parts]),
                    noise_upper=torch.stack([t(p[3]) for p in parts]),
                    jitter=jitter, num_fidelities=num_fidelities,
                    floor=4.0 * F32_EPS if held == np.float32 else 0.0)
    return params, consts
