"""The CPU path's first sine and cosine.

torch 2.13 for the CPU (MKL, OpenMP) computes the first parallel sine or
cosine of a process differently on one thread's share of the lanes in a
few percent of processes; every later call agrees with every other.
That made the plain path's first trace of a process differ from its
second, and tests that compare it with the JAX package's flaky in
six-worker runs (tests/test_torch_sweep.py::
test_fused_plain_matches_pallas, tests/test_torch_trace.py::
test_trace_plain_matches_pallas). _device.resolve runs
_device.warm_cpu_math the first time a process asks for the CPU, before
any plain-path call.

Each child below is a fresh OpenMP and MKL state: a process forked right
after the imports, before any torch op has run (the driving subprocess
starts no thread before it forks). Without the warm-up a few percent of
such children disagree with themselves; with it none may.
"""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILDREN = 600

_DRIVER = r"""
import os, sys
import numpy as np
import torch
from rsoderh_raytracing_tpu_torch import _device

x = np.random.default_rng(0).uniform(-3.0, 3.0, 8192).astype(np.float32)
differ, running = 0, []
for _ in range(int(sys.argv[1])):
    pid = os.fork()
    if pid == 0:
        torch.set_num_threads(2)
        _device.resolve("cpu")
        t = torch.from_numpy(x)
        same = torch.equal(torch.sin(t), torch.sin(t)) and torch.equal(torch.cos(t), torch.cos(t))
        os._exit(0 if same else 1)
    running.append(pid)
    if len(running) >= 4:
        differ += os.waitstatus_to_exitcode(os.waitpid(running.pop(0), 0)[1]) != 0
for pid in running:
    differ += os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1]) != 0
print("differ", differ)
"""


def test_first_sine_and_cosine_equal_the_second():
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, str(CHILDREN)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["differ", "0"], proc.stdout


def test_the_cpu_warms_once_and_the_card_never(monkeypatch):
    """One warm-up a process, over at least 2,048 lanes a thread; none for
    the card."""
    from rsoderh_raytracing_tpu_torch import _device

    calls = []
    monkeypatch.setattr(torch, "sin", lambda x, _sin=torch.sin: calls.append(x.numel()) or _sin(x))
    monkeypatch.setattr(_device, "_warm", False)
    if torch.cuda.is_available():
        _device.resolve("cuda")
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _device.resolve("cuda")
    assert calls == []
    _device.resolve("cpu")
    _device.resolve("cpu")
    assert calls == [max(8192, 2048 * torch.get_num_threads())]
