"""On-card smoke test: the QKD chain end to end on one GPU, at production size.

    python chip_smoke.py               # one GPU, every phase below
    python chip_smoke.py --four-cards  # Bob sharded over four GPUs vs one
    python chip_smoke.py --rehearse    # every phase at a tiny size, any device
    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        python chip_smoke.py --rehearse --four-cards   # on 4 CPU devices

Phases (one process, which owns the card):

1. device    — JAX's default device must be a GPU (no CPU fallback); prints
               the card, its power limit, the JAX version and XLA flags.
2. decoder   — the XLA layered min-sum decoder on the production rung QBER
               3% selects and on the lowest-rate rung (n=65536, B=128,
               mixed QBER), and flooding min-sum at BASELINE config 2
               (regular (3,6), n=4096, B=1024): decoded bits, iteration
               counts and the converged flag against qtpu.ldpc.golden.
3. pa        — Toeplitz PA at the production rung's shape (L=2^17): the f32
               integer margin, the in-program hash against a float64 FFT and
               the GF(2) golden, and the int8 verify hash against NumPy.
4. sift      — the batched coincidence matcher on 8 x 2^19-event frames
               against sift.coincidence_match_reference.
5. session   — the two-party EC session at production config (both parties
               in this process, device BSC stream at QBER 3%): identical
               keys, equal ledgers, FER, iterations, ms/window, peak memory.
6. chain     — events to key (AliceChain/BobChain) at 10^7 pairs/s, n=65536,
               B=32: pfind acquires the offset, keys identical.

``--four-cards`` runs only the sharded session and its one-card reference.
Any failed phase fails the run; the last stdout line is then not printed.
The last line of a passing run on a GPU is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM HBM bandwidth (NVIDIA data sheet) — the yardstick the decoder's
# bytes per layered sweep are read against.  A reckoning, not a claim.
H100_HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of one run; FULL is the production deployment."""
    pipeline: dict            # production_config overrides
    golden_blocks: int        # blocks per decoder shape checked on the host
    config2: tuple            # (n, B) of BASELINE config 2
    sift: tuple               # (frames, events per frame)
    session: tuple            # (warm-up windows, timed windows)
    chain: tuple              # (sift windows, pairs/s, n, blocks per window)
    pa_rows: int


FULL = Sizes(pipeline={}, golden_blocks=32, config2=(4096, 1024),
             sift=(8, 1 << 19), session=(8, 8), chain=(24, 1e7, 65536, 32),
             pa_rows=128)
REHEARSE = Sizes(pipeline=dict(n=1024, family="mixed", blocks_per_window=8,
                               qber_test_bits=512, drain_windows=2,
                               stream_capacity_bits=1 << 24),
                 golden_blocks=4, config2=(1024, 16), sift=(2, 1 << 12),
                 session=(2, 2), chain=(3, 150_000.0, 512, 2), pa_rows=4)


def require_gpu(devices) -> None:
    """Refuse any backend but a GPU: a smoke result from the CPU says
    nothing about the card."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's default device is {platform!r}, "
                         "not a GPU (use --rehearse for a CPU rehearsal)")


def nvidia_smi() -> str:
    """Card name and power limit, read by a child process that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _check(ok, message: str) -> None:
    """A phase's pass condition (not ``assert``: ``python -O`` drops those)."""
    if not ok:
        raise RuntimeError(message)


def _parties_agree(run) -> bool:
    return (np.array_equal(run.alice.final_key_bits(),
                           run.bob.final_key_bits())
            and run.alice.ledger.as_dict() == run.bob.ledger.as_dict())


class CompileMeter:
    """Counts XLA compilations and their seconds (tracing, lowering and
    backend compile) through jax.monitoring."""

    def __init__(self):
        import jax
        self.count = 0
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_) -> None:
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration
            if event.endswith("backend_compile_duration"):
                self.count += 1

    def snapshot(self) -> tuple[int, float]:
        return self.count, self.seconds


def _pipeline_config(sz: Sizes):
    from qtpu.pipeline import production_config
    return production_config(**sz.pipeline)


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


# ---------------------------------------------------------------------------
# Phase 2: decoder against the golden model
# ---------------------------------------------------------------------------

def _decoder_batch(step, qbers: np.ndarray, rng):
    """(x, llr, syndrome): random codewords' channel LLRs at per-block QBER
    (punctured columns at LLR 0), syndromes from the golden encoder."""
    from qtpu.ldpc import golden
    code = step.code
    B, n, z = qbers.size, code.n, code.z
    x = rng.integers(0, 2, (B, n)).astype(np.uint8)
    noise = (rng.random((B, n)) < qbers[:, None]).astype(np.uint8)
    mag = np.log((1.0 - qbers) / qbers).astype(np.float32)
    llr = np.where((x ^ noise).astype(bool), -mag[:, None],
                   mag[:, None]).astype(np.float32)
    for c in step.punct_cols:
        llr[:, c * z:(c + 1) * z] = 0.0
    syn = np.stack([golden.encode_syndrome(code, xb).reshape(-1) for xb in x])
    return x, llr, syn


def _check_decoder_shape(label, step, qber_set, B, alg, golden_blocks, rng,
                         max_iters: int = 60) -> dict:
    import jax
    import jax.numpy as jnp
    from qtpu.ldpc import golden
    from qtpu.ldpc.decode import make_batch_decoder
    from qtpu.ldpc.encode import make_batch_encoder

    code = step.code
    qbers = np.asarray([qber_set[i % len(qber_set)] for i in range(B)],
                       np.float64)
    x, llr, syn = _decoder_batch(step, qbers, rng)
    enc = np.asarray(make_batch_encoder(code)(jnp.asarray(x)))
    _check(np.array_equal(enc, syn), f"{label}: batch encoder != golden")

    dec = make_batch_decoder(code, max_iters, alg)
    llr_d, syn_d = jnp.asarray(llr), jnp.asarray(syn)
    t0 = time.perf_counter()
    res = jax.block_until_ready(dec(llr_d, syn_d))
    first_s = time.perf_counter() - t0
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        res = dec(llr_d, syn_d)
    jax.block_until_ready(res)
    decode_s = (time.perf_counter() - t0) / reps
    bits = np.asarray(res.bits)
    iters = np.asarray(res.iterations)
    conv = np.asarray(res.converged)

    idx = np.linspace(0, B - 1, min(golden_blocks, B)).astype(int)
    mismatches = []
    for b in idx:
        g = golden.decode(code, llr[b].reshape(code.nb, code.z),
                          syn[b].reshape(code.mb, code.z), max_iters=max_iters,
                          alg=alg)
        gbits = g.bits.reshape(-1)
        if (not np.array_equal(bits[b], gbits) or iters[b] != g.iterations
                or bool(conv[b]) != g.converged):
            mismatches.append(dict(
                block=int(b), qber=float(qbers[b]),
                iters=int(iters[b]), golden_iters=int(g.iterations),
                converged=bool(conv[b]), golden_converged=bool(g.converged),
                bits_differing=int(np.sum(bits[b] != gbits))))
    for m in mismatches:
        print(f"  MISMATCH {label}: {json.dumps(m)}", flush=True)

    sweeps = int(iters.max())
    # Layered sweep: check messages read+written, posterior totals read
    # (rolled per edge) and read+written (update) — about 4 x E*z*B*4 bytes.
    sweep_bytes = 4 * code.num_edges * code.z * B * 4
    fer = {f"{q:g}": round(float(1.0 - conv[qbers == q].mean()), 4)
           for q in qber_set}
    out = dict(
        shape=label, alg=alg, n=code.n, z=code.z, mb=code.mb,
        edges=code.num_edges, B=B, compared_with_golden=int(idx.size),
        mismatches=len(mismatches), first_call_s=round(first_s, 3),
        decode_ms=round(decode_s * 1e3, 3),
        decoded_gbit_s=round(B * code.n / decode_s / 1e9, 4),
        sweeps_run=sweeps, iters_mean=round(float(iters.mean()), 2),
        fer_by_qber=fer)
    if alg == "layered":
        out.update(
            bytes_per_sweep=sweep_bytes,
            ms_per_sweep=round(decode_s * 1e3 / max(1, sweeps), 4),
            yardstick_ms_per_sweep_at_3_35_tb_s=round(
                sweep_bytes / H100_HBM_BYTES_PER_S * 1e3, 4))
    _check(not mismatches,
           f"{label}: {len(mismatches)} blocks differ from the golden model")
    return out


def phase_decoder(sz: Sizes) -> dict:
    from qtpu.ldpc.codes import RateStep, make_rate_ladder, make_regular_code
    cfg = _pipeline_config(sz)
    ladder = make_rate_ladder(cfg.n, cfg.dv, cfg.target_rates,
                              seed=cfg.code_seed, alg=cfg.alg,
                              family=cfg.family)
    rng = np.random.default_rng(2)
    rung3 = ladder.select(0.03)
    shapes = []
    for rung in (rung3, 0):
        step = ladder.steps[rung]
        ceiling = ladder.max_qber[rung] if ladder.max_qber else 0.05
        shapes.append(_check_decoder_shape(
            f"rung{rung}:{step.name}", step, (0.01, 0.03, ceiling),
            cfg.blocks_per_window, cfg.alg, sz.golden_blocks, rng,
            cfg.max_iters))
    n2, B2 = sz.config2
    reg = RateStep(name="regular36", code=make_regular_code(n2),
                   punct_cols=(), short_cols=())
    shapes.append(_check_decoder_shape(
        f"config2:n{n2}", reg, (0.01, 0.03, 0.05), B2, "minsum",
        sz.golden_blocks, rng, cfg.max_iters))
    return {"shapes": shapes}


# ---------------------------------------------------------------------------
# Phase 3: privacy amplification and the verify hash
# ---------------------------------------------------------------------------

def phase_pa(sz: Sizes) -> dict:
    import jax
    import jax.numpy as jnp
    from qtpu import pa
    from qtpu.pipeline import AliceSession
    from qtpu.window_programs import (_toeplitz_hash, _verify_hash,
                                      toeplitz_margin)

    cfg = _pipeline_config(sz)
    party = AliceSession(cfg, 0x5E55, None)
    rung = party.ladder.select(0.03)
    P = party.payload_per_block(rung)
    m = party.programs(rung).l_max
    L = 1 << (m + P - 2).bit_length()
    rng = np.random.default_rng(3)
    R = sz.pa_rows
    t = rng.integers(0, 2, (R, m + P - 1)).astype(np.uint8)
    x = rng.integers(0, 2, (R, P)).astype(np.uint8)

    margin = toeplitz_margin(t, x, m)
    got = np.asarray(jax.jit(_toeplitz_hash, static_argnums=2)(
        jnp.asarray(t), jnp.asarray(x), m))
    conv64 = np.fft.irfft(np.fft.rfft(t.astype(np.float64), L)
                          * np.fft.rfft(x.astype(np.float64), L), L)
    exact = (np.round(conv64[:, P - 1:P - 1 + m]).astype(np.int64)
             & 1).astype(np.uint8)
    fft_rows_differing = int(np.sum(np.any(got != exact, axis=1)))
    golden_rows = min(4, R)
    golden_rows_differing = sum(
        int(not np.array_equal(got[i], pa.toeplitz_hash_golden(t[i], x[i], m)))
        for i in range(golden_rows))

    Vh = cfg.verify_hash_bits
    tm = rng.integers(0, 2, (P, Vh)).astype(np.int8)
    vh = np.asarray(jax.jit(_verify_hash)(jnp.asarray(tm), jnp.asarray(x)))
    vh_ref = ((x.astype(np.int64) @ tm.astype(np.int64)) & 1).astype(np.uint8)
    vh_rows_differing = int(np.sum(np.any(vh != vh_ref, axis=1)))

    out = dict(rung=rung, P=P, l_max=m, fft_len=L, rows=R,
               integer_margin=round(margin, 6),
               fft_rows_differing=fft_rows_differing,
               golden_rows=golden_rows,
               golden_rows_differing=golden_rows_differing,
               verify_hash_rows_differing=vh_rows_differing)
    _check(margin < 0.25, f"f32 FFT integer margin {margin} >= 0.25")
    _check(fft_rows_differing == 0, "PA hash != float64 FFT reference")
    _check(golden_rows_differing == 0, "PA hash != GF(2) golden")
    _check(vh_rows_differing == 0, "int8 verify hash != NumPy product")
    return out


# ---------------------------------------------------------------------------
# Phase 4: coincidence sifting
# ---------------------------------------------------------------------------

def phase_sift(sz: Sizes) -> dict:
    import jax
    import jax.numpy as jnp
    from qtpu import sift
    from sift_bench import synth_frames

    F, n_ev = sz.sift
    window, gain = 40, 0.5
    ta, da, tb, db = synth_frames(np.random.default_rng(4), F, n_ev,
                                  sift.MAX_SPAN - 1, window=window)
    ba, bb, xb = (da >> 1) & 1, (db >> 1) & 1, db & 1
    matcher = sift.make_frame_matcher(F, window=window, servo_gain=gain)
    args = tuple(jnp.asarray(v) for v in (ta, ba, tb, bb, xb))
    r = jax.block_until_ready(matcher(*args, jnp.int32(0)))
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        r2 = matcher(*args, jnp.int32(0))
    jax.block_until_ready(r2)
    dt = (time.perf_counter() - t0) / reps

    mask = np.asarray(r.sift_mask)
    bits = np.asarray(r.bob_bits)
    res = np.asarray(r.residuals)
    offset = np.int32(0)
    frames_differing = 0
    max_res_err = 0.0
    for f in range(F):
        matched, best = sift.coincidence_match_reference(ta[f], tb[f],
                                                         int(offset), window)
        sm = matched & (ba[f] == bb[f][best])
        ok = (np.array_equal(mask[f], sm)
              and np.array_equal(bits[f][sm], xb[f][best][sm])
              and int(np.asarray(r.matched_counts)[f]) == int(matched.sum())
              and int(np.asarray(r.sifted_counts)[f]) == int(sm.sum()))
        d = (tb[f][best].astype(np.int64) - (ta[f].astype(np.int64) + offset))
        ref_res = float(np.sum(d[matched])) / max(1, int(matched.sum()))
        max_res_err = max(max_res_err, abs(float(res[f]) - ref_res))
        frames_differing += int(not ok)
        # The servo step exactly as the device takes it (f32, truncation).
        offset = np.int32(offset + np.int32(np.float32(gain) * res[f]))
    out = dict(frames=F, events_per_frame=n_ev,
               frames_differing=frames_differing,
               final_offset=int(np.asarray(r.final_offset)),
               reference_final_offset=int(offset),
               max_residual_abs_err=round(max_res_err, 8),
               dispatch_ms=round(dt * 1e3, 3),
               matcher_events_per_s=round(2 * F * n_ev / dt, 1))
    _check(frames_differing == 0, "frame matcher != NumPy reference")
    _check(out["final_offset"] == out["reference_final_offset"],
           "servo offset != reference")
    # f32 sums of ~10^5 residuals of |d| <= window in another order:
    # 1e-3 units is far above their rounding and far below one time unit.
    _check(max_res_err < 1e-3, f"servo residual off by {max_res_err}")
    return out


# ---------------------------------------------------------------------------
# Phases 5-7: sessions
# ---------------------------------------------------------------------------

def _session_readings(run, warmup: int) -> dict:
    mets = run.bob.metrics[warmup:]
    blocks = sum(m.blocks for m in mets)
    # Over the whole drained session: windows in flight at the edges of the
    # timed region finalize inside it, which skews a timed-region ratio.
    consumed = run.alice.ledger.sifted_bits - run.alice.stream.remaining
    return dict(
        windows=run.windows,
        window_ms=round(1e3 * run.elapsed_s / max(1, run.windows), 3),
        sifted_bits_per_s=round(run.consumed_bits / run.elapsed_s, 1),
        secret_fraction=round(run.bob.ledger.final_bits / max(1, consumed),
                              4),
        fer=round(1.0 - sum(m.blocks_ok for m in mets) / max(1, blocks), 5),
        iters_mean=round(float(np.mean([m.iters_mean for m in mets])), 2),
        rungs_used=sorted({m.rate_index for m in run.bob.metrics}),
        warmup_s=round(run.warmup_s, 3))


def phase_session(sz: Sizes, meter: CompileMeter) -> dict:
    from config4_full_chain import run_two_party
    warm, timed = sz.session
    c0, s0 = meter.snapshot()
    run = run_two_party(windows=timed, qber=0.03, warmup_windows=warm,
                        config=_pipeline_config(sz))
    c1, s1 = meter.snapshot()
    out = _session_readings(run, warm)
    out.update(compiles=c1 - c0, compile_s=round(s1 - s0, 3),
               final_key_bits=int(run.bob.ledger.final_bits))
    _check(_parties_agree(run), "session: keys or ledgers differ")
    _check(run.final_bits > 0, "no final key in the timed windows")
    return out


def phase_chain(sz: Sizes) -> dict:
    from config4_sifted_chain import measure_sifted_chain
    windows, rate, n, B = sz.chain
    r = measure_sifted_chain(sim_windows=windows, pair_rate=rate,
                             blocks_per_window=B, n=n)
    err = abs(r["acquired_offset_units"] - r["true_offset_units"])
    r["offset_error_units"] = err
    # Within a couple of timing-jitter sigmas of truth (as tests/test_chain).
    _check(err < 60, f"pfind offset off by {err} units")
    _check(r["keys_identical"], "events to key: final keys differ")
    _check(r["final_key_bits"] > 0, "no final key from events")
    return r


def phase_four_cards(sz: Sizes) -> dict:
    import jax
    from config4_full_chain import run_two_party
    from qtpu.accounting import LEDGER_FIELDS
    from qtpu.parallel import make_mesh

    _check(len(jax.devices()) >= 4, f"need 4 devices, have {jax.devices()}")
    warm, timed = sz.session
    cfg = _pipeline_config(sz)
    mesh = make_mesh("blocks", 4)
    four = run_two_party(windows=timed, qber=0.03, warmup_windows=warm,
                         config=cfg, mesh=mesh)
    one = run_two_party(windows=timed, qber=0.03, warmup_windows=warm,
                        config=cfg)
    _check(_parties_agree(four) and _parties_agree(one),
           "keys or ledgers differ between the parties")
    keys_equal = bool(np.array_equal(four.bob.final_key_bits(),
                                     one.bob.final_key_bits()))
    ledgers_equal = four.bob.ledger.as_dict() == one.bob.ledger.as_dict()
    idx = {f: i for i, f in enumerate(LEDGER_FIELDS)}
    psum_windows_differing = 0
    for met in four.bob.metrics:
        g = four.bob.gled_by_window[met.window_id]
        psum_windows_differing += int(
            int(g[idx["syndrome_bits"]]) != met.leaked_syndrome
            or int(g[idx["verify_hash_bits"]]) != met.leaked_hash
            or int(g[idx["blocks_ok"]]) + int(g[idx["blocks_failed"]])
            != met.blocks)
    out = dict(blocks_per_card=cfg.blocks_per_window // 4,
               four_cards=_session_readings(four, warm),
               one_card=_session_readings(one, warm),
               keys_equal=keys_equal, ledgers_equal=ledgers_equal,
               psum_windows_checked=len(four.bob.metrics),
               psum_windows_differing=psum_windows_differing)
    _check(keys_equal, "four-card keys != one-card keys")
    _check(ledgers_equal, "four-card ledger != one-card ledger")
    _check(psum_windows_differing == 0, "psum ledger != host metrics")
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rehearse", action="store_true",
                   help="every phase at a tiny size on whatever device JAX "
                        "has; never reports ok")
    p.add_argument("--four-cards", action="store_true",
                   help="only the four-GPU sharded session and its "
                        "one-GPU reference")
    args = p.parse_args(argv)

    import jax
    devices = jax.devices()
    if not args.rehearse:
        require_gpu(devices)
    sys.path.insert(0, os.path.join(HERE, "benchmarks"))
    sys.path.insert(0, HERE)
    from qtpu.compile_cache import enable_compile_cache

    dev = devices[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)} jax={jax.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    card = None
    if not args.rehearse:
        card = nvidia_smi()
    sz = REHEARSE if args.rehearse else FULL
    meter = CompileMeter()

    if args.four_cards:
        phases = [("four_cards", lambda: phase_four_cards(sz))]
    else:
        # The session runs first, so the process's peak device memory
        # after it is the session's own.
        phases = [("session", lambda: phase_session(sz, meter)),
                  ("decoder", lambda: phase_decoder(sz)),
                  ("pa", lambda: phase_pa(sz)),
                  ("sift", lambda: phase_sift(sz)),
                  ("chain", lambda: phase_chain(sz))]
    failed = []
    for name, fn in phases:
        c0, s0 = meter.snapshot()
        t0 = time.perf_counter()
        try:
            readings = fn()
        except Exception:     # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            print(f"phase {name}: FAILED after "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            continue
        c1, s1 = meter.snapshot()
        readings.update(phase_s=round(time.perf_counter() - t0, 3),
                        phase_compiles=c1 - c0,
                        phase_compile_s=round(s1 - s0, 3),
                        process_peak_bytes_in_use=_peak_bytes())
        print(f"phase {name}: ok {json.dumps(readings)}", flush=True)

    print(f"nvidia-smi: {card if card is not None else 'not read (rehearsal)'}",
          flush=True)
    if failed:
        print(f"FAILED phases: {', '.join(failed)}", flush=True)
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(devices)}
    if args.rehearse:
        print(json.dumps({"rehearsal_passed": True, "device": device}))
    else:
        print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
