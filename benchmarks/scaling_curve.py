"""Scaling curve: full-chain windows/s vs device count on the forced-CPU
mesh (BASELINE.json: "near-linear samples/s at 1 chip -> 1 host -> >=2
hosts").

The curve runs on the 8-virtual-device CPU mesh — the SAME shard_map
programs a multi-card host runs, with XLA's CPU collectives standing in
for the cards' links.  It shows that per-device work shrinks with mesh
size and that the psum ledger/collective overhead does not grow with the
mesh.  The virtual devices share one host's cores, so its numbers are
CPU numbers, never device numbers: ``chip_smoke.py --four-cards`` times
the same sharded session on four GPUs.  Prints one JSON row per mesh size.

Each mesh size runs in a fresh subprocess (device count is fixed at
process start by XLA_FLAGS).

Usage: python benchmarks/scaling_curve.py [WINDOWS]
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

CHILD = r"""
import json, sys, time
import numpy as np
import jax
import jax.numpy as jnp

ndev = int(sys.argv[1])
windows = int(sys.argv[2])
sys.path.insert(0, {root!r})
from qtpu.pipeline import AliceSession, BobSession, PipelineConfig, pump_sessions
from qtpu.parallel import make_mesh
from qtpu.link import make_direct_pair

B = 64   # blocks per window (divisible by every mesh size)
# max_retries=0: the retry programs would otherwise compile at the first
# failed block, anywhere in the measured region, and CPU compile time
# (~seconds) would swamp the per-point signal.
cfg = PipelineConfig(n=4096, blocks_per_window=B, qber_test_bits=1024,
                     max_inflight_windows=2, drain_windows=4,
                     max_retries=0)
mesh = make_mesh("blocks", num=ndev)
la, lb = make_direct_pair()
alice = AliceSession(cfg, 0x5E55, la)
bob = BobSession(cfg, 0x5E55, lb, mesh=mesh)
total = (windows + 7) * cfg.n * B
rng = np.random.default_rng(0)
a_bits = rng.integers(0, 2, total).astype(np.uint8)
b_bits = a_bits ^ (rng.random(total) < 0.02).astype(np.uint8)
alice.push_sifted(a_bits)
bob.push_sifted(b_bits)

def pump_until(n):
    for _ in range(10**6):
        if bob.window_id >= n:
            return
        progressed = False
        if alice.can_start_window():
            alice.start_window(); progressed = True
        m = lb.recv()
        if m is not None:
            bob.on_message(m); progressed = True
        m = la.recv()
        if m is not None:
            alice.on_message(m); progressed = True
        if not progressed and not bob.flush():
            return

pump_until(4)                       # warmup/compile (incl. first retry)
t0 = time.perf_counter()
pump_until(4 + windows)
dt = time.perf_counter() - t0
done = bob.window_id - 4
pump_sessions(alice, bob, la, lb)
assert np.array_equal(alice.final_key_bits(), bob.final_key_bits())
print(json.dumps({{"devices": ndev, "windows": done,
                  "elapsed_s": round(dt, 3),
                  "windows_per_s": round(done / dt, 3),
                  "sifted_bits_per_s": round(done * cfg.n * B / dt, 0)}}))
"""


def main() -> None:
    windows = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    child_src = CHILD.format(root=ROOT)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    rows = []
    for ndev in (1, 2, 4, 8):
        out = subprocess.run(
            [sys.executable, "-c", child_src, str(ndev), str(windows)],
            capture_output=True, text=True, env=env, timeout=1800)
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if not line:
            print(f"devices={ndev} FAILED:\n{out.stdout}\n{out.stderr}",
                  file=sys.stderr)
            sys.exit(1)
        rows.append(json.loads(line[-1]))
        print(json.dumps(rows[-1]))


if __name__ == "__main__":
    main()
