"""The harness and its reference load no module of JAX or of the JAX
package (top-level names compared whole: mobocmf_tpu_torch begins with
mobocmf_tpu), and the reference loads nothing of the program."""

import subprocess
import sys

from port_bench import run as R


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=R.ROOT, check=True,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    mods = _loaded("import port_bench.run, port_bench.cells, port_bench.calibrate, "
                   "port_bench.faults, port_bench.trace, port_bench.reference.mfdgp\n"
                   "from port_bench.cells import KINDS\n"
                   "import mobocmf_tpu_torch.fit.fitter, mobocmf_tpu_torch.fit.conditioned")
    assert not mods & set(R.FORBIDDEN)
    assert "mobocmf_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import port_bench.reference.mfdgp, port_bench.compare, port_bench.problems")
    assert not mods & (set(R.FORBIDDEN) | {"mobocmf_tpu_torch"})


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mobocmf_tpu_torch.fit", sys)
    monkeypatch.setitem(sys.modules, "mobocmf_tpuish", sys)
    assert "mobocmf_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mobocmf_tpu.fit", sys)
    assert "mobocmf_tpu" in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in R.forbidden_modules()
