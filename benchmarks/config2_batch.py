"""BASELINE config 2: 1024 concurrent n=4096 blocks, QBER sweep 1-5%,
layered XLA decoder."""
import json, os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, jax, jax.numpy as jnp
from qtpu.ldpc.codes import make_regular_code
from qtpu.ldpc.encode import make_batch_encoder
from qtpu.ldpc.decode import make_batch_decoder, channel_llr

dev = jax.devices()[0]
code = make_regular_code(4096)
B = 1024
dec = make_batch_decoder(code, max_iters=60, alg="layered")
enc = make_batch_encoder(code)
rng = np.random.default_rng(0)
out = []
for q in (0.01, 0.02, 0.03, 0.04, 0.05):
    keys = rng.integers(0, 2, (B, code.n)).astype(np.uint8)
    bob = keys ^ (rng.random((B, code.n)) < q).astype(np.uint8)
    syn = jax.device_put(np.asarray(enc(jnp.asarray(keys))))
    llr = jax.device_put(np.asarray(channel_llr(jnp.asarray(bob), q)))
    res = dec(llr, syn); res.bits.block_until_ready()
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        res = dec(llr, syn)
    res.bits.block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    iters = np.asarray(res.iterations)
    fer = 1.0 - float(np.asarray(res.converged).mean())
    out.append({"qber": q, "gbit_s": round(B * code.n / dt / 1e9, 3),
                "iters_mean": round(float(iters.mean()), 2),
                "iters_p99": int(np.percentile(iters, 99)), "fer": fer})
print(json.dumps({"config": 2, "batch": B, "sweep": out,
                  "device": {"platform": dev.platform, "kind": dev.device_kind,
                             "count": len(jax.devices())}}))
