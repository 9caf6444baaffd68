"""Multi-host (2-process) halo solver test.

Spawns two subprocesses that each initialize ``jax.distributed`` on CPU
(4 virtual devices per process, gloo collectives), build the identical
host-side context, and solve over the 8-device *global* mesh via
HaloContext; each worker asserts the answer matches its process-local
single-device solve (see multihost_worker.py).  This is the runnable spec
for BASELINE config 5 (N>=2 hosts) — multi-host GPU clusters follow the
same code path with a network between processes.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_halo_solve():
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert "MULTIHOST_OK" in out, f"worker {pid} no OK marker:\n{out[-4000:]}"


def test_order_steps_dcn_first():
    from gravo_mg.parallel.multihost import order_steps_dcn_first

    # 8 devices, 4 per process: shift 4 crosses for every device (8 DCN
    # transfers); shifts 1/-1 cross only at the process boundary (2);
    # shift 0 never crosses.
    steps = [(0, None, None), (1, None, None), (4, None, None),
             (-1, None, None)]
    ordered = order_steps_dcn_first(steps, 8, 4)
    assert ordered[0][0] == 4
    assert ordered[-1][0] == 0
    # single-host: pure |shift| ordering, no crossing
    ordered1 = order_steps_dcn_first(steps, 8, 8)
    assert [s for s, _, _ in ordered1] == [4, 1, -1, 0]
