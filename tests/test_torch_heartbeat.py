"""The port's stall watchdog (mobocmf_tpu_torch/util/heartbeat.py): the
cases of tests/test_heartbeat.py, run on the port's copy.

The watchdog `os._exit`s the process by design, so firing behavior is tested
in subprocesses; the no-fire path runs in-process and disarms afterwards.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str):
    return subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {REPO!r})\n" + code],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        timeout=120,
    )


def test_port_watchdog_fires_on_stall():
    res = _run(
        "from mobocmf_tpu_torch.util import heartbeat\n"
        "import time\n"
        "heartbeat.start(0.5, poll_s=0.1)\n"
        "heartbeat.beat('phase-x')\n"
        "time.sleep(30)\n"  # no further beats: must be killed long before this
        "print('SHOULD NOT REACH')\n"
    )
    assert res.returncode == 86, res.stdout
    assert "phase-x" in res.stdout  # diagnoses WHERE it hung
    assert "SHOULD NOT REACH" not in res.stdout


def test_port_watchdog_quiet_on_steady_beats():
    res = _run(
        "from mobocmf_tpu_torch.util import heartbeat\n"
        "import time\n"
        "heartbeat.start(1.0, poll_s=0.1)\n"
        "for i in range(20):\n"
        "    time.sleep(0.1)\n"
        "    heartbeat.beat(f'step{i}')\n"
        "heartbeat.stop()\n"
        "print('DONE')\n"
    )
    assert res.returncode == 0, res.stdout
    assert "DONE" in res.stdout


def test_port_watchdog_inactive_by_default():
    # beat() without start() must be a harmless no-op
    from mobocmf_tpu_torch.util import heartbeat

    heartbeat.beat("idle")  # no watchdog armed; nothing happens


def test_port_boconfig_env_var_arms_watchdog():
    # run_bo_loop arms from MOBOCMF_STALL_TIMEOUT_S when the config is unset;
    # a tiny invalid call is enough to reach the arming code path
    res = _run(
        "import os\n"
        "os.environ['MOBOCMF_STALL_TIMEOUT_S'] = '3600'\n"
        "import numpy as np\n"
        "from mobocmf_tpu_torch.bo.loop import BOConfig, run_bo_loop\n"
        "cfg = BOConfig(num_bo_iterations=0, seed=0, log_dir=None, device='cpu')\n"
        "run_bo_loop([], np.zeros((2, 2)), np.zeros(2), cfg)\n"
        "from mobocmf_tpu_torch.util import heartbeat\n"
        "assert heartbeat._thread is not None and heartbeat._thread.is_alive()\n"
        "print('ARMED OK')\n"
    )
    assert res.returncode == 0, res.stdout
    assert "ARMED OK" in res.stdout
