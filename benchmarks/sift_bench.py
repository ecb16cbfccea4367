"""Sift-stage throughput: raw detector events per second through the
batched coincidence matcher (BASELINE config 4 "sifting"; SURVEY.md §4.1
calls costream the only O(raw-event-rate) hot loop).

Synthesizes realistic correlated event streams (pair events + loss + jitter
+ accidentals) at 10^6-10^8 events/s-equivalent frame occupancies, then
times `sift.make_frame_matcher` — F frames per dispatch, drift servo on
device — amortized over many dispatches.  Prints one JSON line with
events/s and sifted-bits/s.

Usage: python benchmarks/sift_bench.py [EVENTS_PER_FRAME_LOG2] [FRAMES]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def synth_frames(rng, F, n_events, span, pair_frac=0.5, window=40):
    """Correlated (alice, bob) event frames: `pair_frac` of Bob's events are
    true pairs of Alice's (jittered within the coincidence window), the rest
    independent accidentals; both streams time-sorted."""
    ta = np.sort(rng.integers(0, span, (F, n_events)), axis=1).astype(np.int32)
    npair = int(n_events * pair_frac)
    pick = np.sort(rng.permutation(n_events)[:npair])
    tb_pair = ta[:, pick] + rng.integers(-window // 2, window // 2,
                                         (F, npair)).astype(np.int32)
    tb_acc = rng.integers(0, span, (F, n_events - npair)).astype(np.int32)
    tb = np.sort(np.concatenate([tb_pair, tb_acc], axis=1), axis=1)
    da = rng.integers(0, 4, (F, n_events)).astype(np.uint8)
    db = rng.integers(0, 4, (F, n_events)).astype(np.uint8)
    return ta, da, tb, db


def main() -> None:
    log2_ev = int(sys.argv[1]) if len(sys.argv) > 1 else 19
    F = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    import jax.numpy as jnp
    from qtpu import sift
    from qtpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    n_events = 1 << log2_ev
    span = sift.MAX_SPAN - 1      # one full 67 ms frame
    rng = np.random.default_rng(0)
    ta, da, tb, db = synth_frames(rng, F, n_events, span)
    basis_a, bits_a = (da >> 1) & 1, da & 1
    basis_b, bits_b = (db >> 1) & 1, db & 1

    matcher = sift.make_frame_matcher(F, window=40, servo_gain=0.5)
    args = tuple(jnp.asarray(x) for x in
                 (ta, basis_a, tb, basis_b, bits_b))
    r = matcher(*args, jnp.int32(0))
    total0 = int(np.asarray(r.sifted_counts).sum())   # warm + real barrier

    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        r = matcher(*args, jnp.int32(0))
    _ = int(np.asarray(r.final_offset))               # true completion barrier
    dt = (time.perf_counter() - t0) / reps

    events = 2 * F * n_events                          # both parties' streams
    out = {
        "events_per_frame": n_events,
        "frames_per_dispatch": F,
        "dispatch_ms": round(dt * 1e3, 3),
        "sift_events_per_s": round(events / dt, 0),
        "sifted_bits_per_dispatch": total0,
        "sifted_bits_per_s": round(total0 / dt, 0),
        "frame_realtime_rate_events_per_s": round(
            2 * n_events / (span * 125e-12), 0),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
