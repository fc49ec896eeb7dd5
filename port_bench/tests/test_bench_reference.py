"""The plain reference against the program's own float64 arithmetic at a
small size (a witness on the CPU): the same initial model, the same
negative ELBO and KL at the same draws."""

import json

import numpy as np
import torch

from port_bench import cells
from port_bench.reference import mfdgp as Ref
from port_bench.tests._small import SEED, SMALL


def test_reference_init_and_elbo_match_the_program_at_f64():
    from mobocmf_tpu_torch.mlls.elbo import elbo_terms
    from mobocmf_tpu_torch.util.tree import tree_map

    cfg = json.loads(open(cells.problems.__file__.replace("problems.py", "configs/b128_f64.json")).read())
    cfg.update(SMALL["config"])
    tr = {"kind": "train", "mask": "all_free", "lr": "lr_2", "warmup_steps": 2, "trace_steps": 2,
          "tail_steps": 3}
    cell = cells.build(cfg, tr, SEED, "cpu")
    x_p, f_p, w_p = cell.padded()
    ys = [cell.padded_y(cell.data.ys[i]) for i in cell.order()]
    p0, c = Ref.init_stacked(x_p, ys, f_p, 2, cfg["jitter"], torch.float64, "cpu", cell.held)
    for k in p0:
        assert torch.allclose(p0[k], cell.p0[k].double(), rtol=0, atol=1e-9), k
    ph = cell.phase
    models = [cell.fitter.models_objs[n] for n in cell.fitter.obj_names] + \
             [cell.fitter.models_cons[n] for n in cell.fitter.con_names]
    params = tree_map(lambda t: t.double(), cell.trainer.stack_models(models).params)
    consts = tree_map(lambda t: t.double(), ph.consts)
    eps = cell.first["draws"][0][0].double()
    x, w, fid = torch.as_tensor(x_p), torch.as_tensor(w_p), torch.as_tensor(f_p)
    y = torch.as_tensor(np.stack(ys))
    n = float(cell.data.x.shape[0])
    elbo, kl = elbo_terms(params, consts, ph.config, x, y, fid, eps,
                          torch.tensor(n, dtype=torch.float64), weights=w)
    loss, kl_ref = Ref.neg_elbo(p0, c, x, y, fid, w, eps, n)
    assert torch.allclose(-elbo, loss, rtol=1e-9) and torch.allclose(kl, kl_ref, rtol=1e-9)
    cell.close()
