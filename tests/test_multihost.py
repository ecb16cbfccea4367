"""Launch the real two-process jax.distributed run (BASELINE config 5 shape)
on localhost: 2 processes x 4 CPU devices -> one 8-device global mesh with a
cross-process psum ledger."""

import os
import subprocess
import sys

import pytest


@pytest.mark.slow
def test_two_process_distributed_reconcile():
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "multihost_worker.py")
    env = dict(os.environ)
    # Both workers stay on the CPU: a JAX process reserves most of a card's
    # memory when it starts, so two processes cannot share one card.
    env["JAX_PLATFORMS"] = "cpu"
    port = 19901
    procs = [
        subprocess.Popen([sys.executable, worker, str(i), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out, f"worker {i} no OK:\n{out[-3000:]}"
    # Both processes computed the same global ledger.
    l0 = [ln for ln in outs[0].splitlines() if "MULTIHOST_OK" in ln][0]
    l1 = [ln for ln in outs[1].splitlines() if "MULTIHOST_OK" in ln][0]
    assert l0.split("ledger=")[1] == l1.split("ledger=")[1]
