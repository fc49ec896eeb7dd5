"""Problems and designs at any number of fidelities: the existing
configurations' designs bitwise as before, problems found by file, the
DTLZ2 copy against the program's, and rehearsals at F = 3 through the
harness (cells.build, the window, the program's outputs and the
reference's, compare.judge under the cells' own limits), with faults that
turn them false."""

import hashlib
import json

import numpy as np
import pytest
import torch

from port_bench import cells, compare, faults, problems
from port_bench import run as R
from port_bench.tests._small import SEED, small

# problems.design at each configuration's full size on the CPU (one
# thread: the prior's float32 draws sum in another order on more), as
# the harness before n_per_fidelity drew them
DIGESTS = {
    ("bc512_f64", 0): "098c53566225ff27343bc490c821914ac9a2de411e44d4e7ceec2932eb8908a2",
    ("bc512_f64", SEED): "ef19e3babcbbf1bfd4de0a20a46b6d06cb17562ba3a7ee4688b66c02557f8f53",
    ("b128_f64", 0): "52a2aa2c8456553465028ba3c49f502595205ea46460b595d05c6c6b797bddf6",
    ("b128_f64", SEED): "6b2b567534dc4eb754a95753f1a294860e1ce97735cddb27fa0517482965b6ff",
}

# the example's DTLZ2 (examples/example_dtlz2_2048.py) as a configuration
DTLZ2 = {"name": "dtlz2_f3", "problem": "dtlz2_mf", "num_objectives": 4, "d": 6,
         "num_fidelities": 3, "n_per_fidelity": [1020, 510, 510], "dtype": "float64",
         "jitter": 2e-06, "lr_1": 0.003, "lr_2": 0.001, "pareto_set_size": 50}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(name: str) -> dict:
    return R.load_json(R.HERE / "configs" / f"{name}.json")


def digest(data: problems.Data) -> str:
    h = hashlib.sha256()
    for a in (data.x, data.fid.astype(np.int64), *data.ys, np.asarray(data.thresholds, np.float64)):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(repr((data.names, data.is_con)).encode())
    return h.hexdigest()


@pytest.mark.parametrize("name, seed", sorted(DIGESTS))
def test_designs_bitwise_as_before(name, seed):
    data = problems.design(config(name), seed, "cpu")
    assert data.fid.dtype == np.int64 and digest(data) == DIGESTS[name, seed]


def test_fidelities_in_blocks_from_one_draw():
    cfg = dict(DTLZ2, n_per_fidelity=[5, 3, 2])
    data = problems.design(cfg, SEED, "cpu")
    assert (data.fid == [0] * 5 + [1] * 3 + [2] * 2).all()
    assert (data.x == np.random.default_rng(SEED).uniform(size=(10, 6))).all()
    assert data.names == ["obj1", "obj2", "obj3", "obj4"] and not any(data.is_con)


@pytest.mark.parametrize("counts", [[20, 8], [20, 8, 8, 8], [20, 0, 8], [20, 8.0, 8]])
def test_counts_that_do_not_fit_raise(counts):
    with pytest.raises(ValueError, match="per fidelity"):
        problems.design(dict(DTLZ2, n_per_fidelity=counts), SEED, "cpu")


def test_problem_from_its_file(tmp_path, monkeypatch):
    (tmp_path / "flat.py").write_text(
        "import numpy as np\n"
        "from port_bench.problems import Blackbox\n"
        "def make(config, device):\n"
        "    fn = lambda x: np.full(len(x), float(config['d']))\n"
        "    return [Blackbox('flat', False, 0.0, [fn] * config['num_fidelities'])]\n")
    monkeypatch.setattr(problems, "BLACKBOXES", tmp_path)
    (bb,) = problems.make({"problem": "flat", "d": 3, "num_fidelities": 2}, "cpu")
    assert bb.name == "flat" and (bb.fns[1](np.zeros((2, 3))) == 3.0).all()


def test_problem_in_both_places_or_in_neither_raises(tmp_path, monkeypatch):
    (tmp_path / "prior.py").write_text("def make(config, device):\n    return []\n")
    monkeypatch.setattr(problems, "BLACKBOXES", tmp_path)
    with pytest.raises(ValueError, match=r"both in problems.PROBLEMS .* and .*prior.py"):
        problems.make({"problem": "prior"}, "cpu")
    for name in ("nowhere", "../tests/_small"):
        with pytest.raises(ValueError, match=r"neither in problems.PROBLEMS .* nor .*\.py"):
            problems.make({"problem": name}, "cpu")


@pytest.mark.parametrize("level", [0, 1, 2])
def test_dtlz2_mf_is_the_programs_objective(level):
    from mobocmf_tpu_torch.examples.example_dtlz2_2048 import NUM_OBJ, mf_objective
    x = np.random.default_rng(SEED).uniform(size=(64, 6))
    mine = problems.make(dict(DTLZ2, num_objectives=NUM_OBJ), "cpu")
    for i, bb in enumerate(mine):
        want = mf_objective(i)[level](x)
        np.testing.assert_allclose(bb.fns[level](x), want, rtol=0, atol=1e-15)


def test_small_sizes_per_configuration():
    assert small(config("bc512_f64"))["config"] == {"n_low": 20, "n_high": 8}
    assert small(DTLZ2)["config"] == {"n_per_fidelity": [20, 8, 8]}
    assert small(DTLZ2)["traffic"] == small(config("b128_f64"))["traffic"]


def rehearse(cfg: dict, traffic: str) -> dict:
    """The cell's set-up, window, outputs and the reference's, at small()'s
    sizes on the CPU; the numbers compared."""
    shrink = small(cfg)
    tr = dict(R.load_json(R.HERE / "traffic" / f"{traffic}.json"), **shrink["traffic"])
    cell = cells.build(dict(cfg, **shrink["config"]), tr, SEED, "cpu")
    cell.window(0.3)
    prog = cell.program()
    cell.close()
    return compare.numbers(prog, cell.reference(torch.float64, torch.device("cpu")))


def limits(traffic: str) -> list:
    bench = R.load_json(R.ROOT / "BENCHMARK.json")
    return [R.load_json(R.HERE / "limits" / f"{w['name']}.json") for w in bench["workloads"]
            if w["traffic"] == traffic]


def test_dtlz2_at_three_fidelities_is_correct():
    nums = rehearse(DTLZ2, "train")
    assert {"loss", "kl", "grad", "change", "loss_tail", "kl_tail", "change_tail"} <= set(nums)
    assert all(compare.judge(nums, lim) for lim in limits("train")), nums


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_fault_turns_dtlz2_at_three_fidelities_false(fault):
    with faults.FAULTS[fault]():
        nums = rehearse(DTLZ2, "train")
    assert not any(compare.judge(nums, lim) for lim in limits("train")), nums


def test_prior_at_three_fidelities_conditioned_is_correct():
    cfg = dict(config("b128_f64"), num_fidelities=3, n_per_fidelity=[80, 40, 40])
    nums = rehearse(cfg, "cond")
    assert all(compare.judge(nums, lim) for lim in limits("cond")), nums
