"""Device-time decomposition of the per-window programs (amortized).

Times each fused window program of the production rung in isolation with
N back-to-back dispatches and one final block — the device cost free of
host round trips.  This is the table that says where
the window cycle's device milliseconds go.

Usage: python benchmarks/profile_programs.py [REPS]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def bench(fn, *args, reps: int = 20, name: str = "") -> float:
    import jax
    out = fn(*args)          # compile + warm
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"  {name:24s} {ms:8.2f} ms/call")
    return ms


def main() -> None:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    import jax
    import jax.numpy as jnp
    from qtpu.pipeline import AliceSession, BobSession, production_config
    from qtpu.window_programs import make_header
    import collections

    cfg = production_config()
    qa, qb = collections.deque(), collections.deque()
    from qtpu.link import DirectLink
    alice = AliceSession(cfg, 0x5E55, DirectLink(qa, qb))
    bob = BobSession(cfg, 0x5E55, DirectLink(qb, qa))

    # The rung the 3% prior selects.
    q, r, s, k_pb = 0.03, *(None,) * 3
    bob.qest.update_prior(0.03 * 1e6, 1e6)
    q, r, s, k_pb = bob._choose()
    print(f"rung={r} s={s} k_pb={k_pb} P={alice.payload_per_block(r)} "
          f"B={cfg.blocks_per_window}")
    prog_a = alice.programs(r)
    prog_b = bob.programs(r)
    P = alice.payload_per_block(r)
    B = cfg.blocks_per_window

    # Stream arena with one window of bits.
    take = alice.window_payload_bits(r)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, take).astype(np.uint8)
    alice.stream.push(bits)
    bob.stream.push(bits ^ (rng.random(take) < 0.03).astype(np.uint8))
    header_a = jnp.asarray(make_header(
        0, s, alice._window_key(0), alice._private_key(0), test_bits_pb=k_pb,
        affine=alice._affine_for(0, P)))
    header_b = jnp.asarray(make_header(
        0, s, bob._window_key(0), test_bits_pb=k_pb,
        affine=bob._affine_for(0, P)))

    res = {}
    res["alice_program"] = bench(prog_a.alice, alice.stream.arena, header_a,
                                 reps=reps, name="alice(frame+enc+hash)")
    payload, syn, hashes, test_bits, short_vals = prog_a.alice(
        alice.stream.arena, header_a)

    def pad(arr, w):
        arr = np.asarray(arr)
        if arr.shape[1] == w:
            return jnp.asarray(arr)
        out = np.zeros((B, w), arr.dtype)
        out[:, : arr.shape[1]] = arr
        return jnp.asarray(out)

    mag = np.float32(np.log(0.97 / 0.03))
    res["bob_program"] = bench(
        prog_b.bob, bob.stream.arena, header_b, pad(test_bits, prog_b.k_pb),
        pad(short_vals, prog_b.s_max), syn, hashes, jnp.float32(mag),
        reps=reps, name="bob(frame+pin+dec+hash)")
    res["pa"] = bench(prog_a.pa, payload, alice._pa_key(0, 0), reps=reps,
                      name="pa(toeplitz fft)")
    fk = prog_a.pa(payload, alice._pa_key(0, 0))
    res["pack"] = bench(prog_a.pack, fk, reps=reps, name="pack(final keys)")

    # Retry-small (the per-retry-round device cost).
    hat, rx_orig, rx_pin, pinmask, stats = prog_b.bob(
        bob.stream.arena, header_b, pad(test_bits, prog_b.k_pb),
        pad(short_vals, prog_b.s_max), syn, hashes, jnp.float32(mag))
    R = 8 if B >= 8 else B
    rows = jnp.arange(R, dtype=jnp.int32)
    valid = jnp.ones(R, jnp.uint8)
    positions = jnp.asarray(
        alice._retry_positions(0, 0, P, prog_a.retry_bits))
    rbits = prog_a.retry_gather(payload, positions)
    res["retry_small"] = bench(
        prog_b.retry_small, bob.stream.arena, header_b, rx_orig, rx_pin,
        pinmask, hat, stats, rows, valid, positions, rbits, syn, hashes,
        jnp.float32(mag), reps=reps, name="retry_small(8 rows)")

    # Decomposed pieces: decode-only and verify-hash-only at window shape.
    from qtpu.ldpc.decode import channel_llr
    step = alice.ladder.steps[r]
    from qtpu.ldpc.decode import make_batch_decoder
    dec = make_batch_decoder(step.code, cfg.max_iters, cfg.alg)
    llr = channel_llr(jnp.asarray(
        rng.integers(0, 2, (B, step.code.n)).astype(np.uint8)), 0.03)
    syn_full = jnp.asarray(rng.integers(0, 2, (B, step.code.m)).astype(np.uint8))
    res["decode_only"] = bench(dec, llr, syn_full, reps=reps,
                               name="decode_only(full n)")

    @jax.jit
    def vhash(t, x):
        xi = x.astype(jnp.int32)
        cols = [jnp.sum(jax.lax.dynamic_slice_in_dim(t, j, P, 1)
                        .astype(jnp.int32) * xi, axis=1)
                for j in range(cfg.verify_hash_bits)]
        return (jnp.stack(cols, axis=1) & 1).astype(jnp.uint8)

    t = jnp.asarray(rng.integers(0, 2, (B, P + 63)).astype(np.uint8))
    x = jnp.asarray(rng.integers(0, 2, (B, P)).astype(np.uint8))
    res["verify_hash"] = bench(vhash, t, x, reps=reps,
                               name="verify_hash(64 dots)")

    # Threefry seed-row generation at the PA seed shape.
    from qtpu import prng as qprng

    @jax.jit
    def seeds(key_data):
        key = jax.random.wrap_key_data(key_data)
        L = P + prog_a.l_max - 1
        W = -(-L // 32)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(B, dtype=jnp.uint32))
        words = jax.vmap(lambda k: jax.random.bits(k, (W,), jnp.uint32))(keys)
        sh = jnp.arange(32, dtype=jnp.uint32)
        return ((words[:, :, None] >> sh) & 1).astype(jnp.uint8)

    res["pa_seed_gen"] = bench(seeds, alice._pa_key(0, 0), reps=reps,
                               name="pa_seed_gen(threefry)")

    print(json.dumps({k: round(v, 2) for k, v in res.items()}))


if __name__ == "__main__":
    main()
