"""Worker for the two-process jax.distributed test (BASELINE config 5).

Each process contributes 4 forced CPU devices; the global mesh has 8. The
sharded reconcile step (DP decode + global psum ledger) must produce the
same global ledger on both processes — the multi-host mechanism of SURVEY.md
§6.8 exercised for real, not just on a forced single-process mesh.

Usage: python multihost_worker.py <process_id> <coordinator_port>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from qtpu.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compile cache: the first collective's Gloo context init times
# out (30 s) if the two processes' compile times diverge under host load;
# cached compiles keep the rendezvous gap near zero.
enable_compile_cache()

proc_id = int(sys.argv[1])
port = int(sys.argv[2])

jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=proc_id)

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from qtpu import prng
from qtpu.accounting import LEDGER_FIELDS
from qtpu.ldpc.codes import make_regular_code
from qtpu.parallel import make_mesh
from qtpu.stream import DeviceStream
from qtpu.window_programs import make_header, make_window_programs

assert len(jax.devices()) == 8, f"global devices: {jax.devices()}"
assert len(jax.local_devices()) == 4

mesh = make_mesh("blocks")
code = make_regular_code(1024)
pay = np.arange(code.n, dtype=np.int64)
empty = np.zeros(0, np.int64)
B, k_pb = 16, 8
kwargs = dict(max_iters=20, alg="minsum", verify_hash_bits=64, l_max=128,
              batch=B, k_pb=k_pb, s_max=32)
progs = make_window_programs(code, pay, empty, empty, mesh=mesh, **kwargs)
# Alice's side mirrored LOCALLY on each process (unsharded jit runs on the
# local default device): same v2 programs, same protocol keys -> identical
# syndromes/hashes/test bits on both processes with zero cross-process work.
local = make_window_programs(code, pay, empty, empty, **kwargs)

# Identical global data on both processes (same seed); sharding splits it.
rng = np.random.default_rng(0)
keys = rng.integers(0, 2, (B, code.n)).astype(np.uint8)
bob = keys ^ (rng.random((B, code.n)) < 0.02).astype(np.uint8)
wkey = prng.key_data(prng.derive(prng.root_key(3), "win", 0))
pkey = prng.key_data(prng.derive(prng.root_key(7), "punct", 0))
from qtpu.window_programs import choose_affine
a, ainv = choose_affine(iter([7]), code.n)
header_host = make_header(0, 0, wkey, pkey, test_bits_pb=k_pb,
                          affine=(a, ainv, 3))
with jax.default_device(jax.local_devices()[0]):
    sa, sb = DeviceStream(1 << 16), DeviceStream(1 << 16)
    sa.push(keys.reshape(-1))
    sb.push(bob.reshape(-1))
    _, syn, hashes, test, shortv = local.alice(sa.arena,
                                               jnp.asarray(header_host))
    syn_host, hash_host, test_host, short_host = (
        np.asarray(syn), np.asarray(hashes), np.asarray(test),
        np.asarray(shortv))
    arena_host = np.asarray(sb.arena)

sh = NamedSharding(mesh, P("blocks", None))
rep = NamedSharding(mesh, P())
def mk(h, sharding):
    return jax.make_array_from_callback(np.asarray(h).shape, sharding,
                                        lambda idx: np.asarray(h)[idx])
mag = np.float32(np.log(0.98 / 0.02))

hat, rx, rxp, pin, stats, ledger = progs.bob(
    mk(arena_host, rep), mk(header_host, rep), mk(test_host, sh),
    mk(short_host, sh), mk(syn_host, sh), mk(hash_host, sh), mk(mag, rep))
# The ledger is replicated over the GLOBAL mesh; a cross-process fetch is
# not allowed — any local shard holds the full (psum'd) value.
gl = np.asarray(ledger.addressable_shards[0].data)
idx = {f: i for i, f in enumerate(LEDGER_FIELDS)}
assert gl[idx["syndrome_bits"]] == B * code.m
assert gl[idx["qber_test_bits"]] == B * k_pb
assert gl[idx["blocks_ok"]] + gl[idx["blocks_failed"]] == B
assert gl[idx["blocks_ok"]] == B, "all blocks should verify at 2%"
print(f"MULTIHOST_OK proc={proc_id} ledger={gl.tolist()}", flush=True)
