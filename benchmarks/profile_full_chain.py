"""Wall-clock breakdown of the full-chain window cycle.

Two modes:

* default (pipelined): wraps the session hot-path methods with host timers.
  Because device dispatch is async, device time is attributed to whichever
  call blocks (the stats fetch, key drains) — use this for the REAL wall
  clock and the host-side Python costs.
* ``--serial``: additionally wraps every per-rung device program with a
  ``block_until_ready`` barrier, so each phase's number is its true
  device+dispatch cost.  Total window time is pessimistic (overlap is
  destroyed) but the per-phase attribution is exact.

Usage:

    python benchmarks/profile_full_chain.py [WINDOWS] [--serial]
"""

import collections
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

TIMES = collections.defaultdict(float)
COUNTS = collections.defaultdict(int)


def timed(name):
    def deco(fn):
        @functools.wraps(fn)
        def wrap(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            TIMES[name] += time.perf_counter() - t0
            COUNTS[name] += 1
            return out
        return wrap
    return deco


def timed_blocking(name):
    """Device-program wrapper: dispatch + block_until_ready (serial mode)."""
    import jax

    def deco(fn):
        @functools.wraps(fn)
        def wrap(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            jax.block_until_ready(out)
            TIMES[name] += time.perf_counter() - t0
            COUNTS[name] += 1
            return out
        return wrap
    return deco


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    serial = "--serial" in sys.argv
    windows = int(args[0]) if args else 6
    import jax
    from qtpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    from qtpu import pipeline as pl
    from qtpu import prng

    # Host-side phase timers (async dispatch: attribution is who-blocks).
    pl.AliceSession.start_window = timed("alice.start_window")(pl.AliceSession.start_window)
    pl.AliceSession._on_rate_select = timed("alice.on_rate_select")(pl.AliceSession._on_rate_select)
    pl.AliceSession._on_verify_ack = timed("alice.on_verify_ack")(pl.AliceSession._on_verify_ack)
    pl.BobSession._service_opens = timed("bob.service_opens")(pl.BobSession._service_opens)
    pl.BobSession._on_syndromes = timed("bob.on_syndromes")(pl.BobSession._on_syndromes)
    pl.BobSession._resolve_decode = timed("bob.resolve_decode")(pl.BobSession._resolve_decode)
    pl._Party._privacy_amplify = timed("pa.host_total")(pl._Party._privacy_amplify)
    pl._Party._drain_chunks = timed("drain_final_keys")(pl._Party._drain_chunks)
    pl._Party._affine_for = timed("host.affine_for")(pl._Party._affine_for)
    prng.derive = timed("host.prng_derive")(prng.derive)

    if serial:
        # Wrap every per-rung device program with a blocking timer.
        orig_programs = pl._Party.programs

        def programs(self, rate_index):
            fresh = rate_index not in self._programs
            prog = orig_programs(self, rate_index)
            if fresh:
                who = type(self).__name__[:1].lower()
                self._programs[rate_index] = prog._replace(
                    alice=timed_blocking(f"dev.alice_program[{who}]")(prog.alice),
                    bob=timed_blocking(f"dev.bob_program[{who}]")(prog.bob),
                    pa=timed_blocking(f"dev.pa[{who}]")(prog.pa),
                    pack=timed_blocking(f"dev.pack[{who}]")(prog.pack),
                    retry_small=timed_blocking(f"dev.retry_small[{who}]")(prog.retry_small),
                    retry=timed_blocking(f"dev.retry[{who}]")(prog.retry),
                )
                return self._programs[rate_index]
            return prog

        pl._Party.programs = programs

    from qtpu.link import make_direct_pair
    cfg = pl.production_config()
    qber = 0.03
    warmup = 6
    per_window = cfg.n * cfg.blocks_per_window
    total_bits = (windows + warmup + 2) * per_window
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from config4_full_chain import device_bsc_stream
    a_chunks, b_chunks = device_bsc_stream(total_bits, qber, 7)
    la, lb = make_direct_pair()
    alice = pl.AliceSession(cfg, 0x5E55, la)
    bob = pl.BobSession(cfg, 0x5E55, lb)

    # Feed fixed-shape chunks (the sift stage's behavior): keeps every
    # push at ONE static chunk shape so no novel-shape compile can stall
    # the run.
    feed_state = {"i": 0}

    def feed():
        i = feed_state["i"]
        lim = alice.max_need * (cfg.max_inflight_windows + 2)
        while i < len(a_chunks) and alice.stream.remaining < lim:
            alice.push_sifted(a_chunks[i])
            bob.push_sifted(b_chunks[i])
            i += 1
        feed_state["i"] = i

    feed()

    def pump_until(n_windows):
        while bob.window_id < n_windows:
            feed()
            progressed = False
            if alice.can_start_window():
                alice.start_window()
                progressed = True
            m = lb.recv()
            if m is not None:
                bob.on_message(m); progressed = True
            m = la.recv()
            if m is not None:
                alice.on_message(m); progressed = True
            if not progressed and not bob.flush():
                return

    pump_until(warmup)
    TIMES.clear(); COUNTS.clear()
    t0 = time.perf_counter()
    pump_until(warmup + windows)
    total = time.perf_counter() - t0
    measured = bob.window_id - warmup
    sifted = measured * cfg.n * cfg.blocks_per_window
    out = {"mode": "serial" if serial else "pipelined",
           "windows": measured,
           "window_ms": round(1e3 * total / max(1, measured), 1),
           "sifted_bits_per_s": round(sifted / total, 1)}
    print(json.dumps(out, indent=2))
    print(f"\nsteady-state wall: {total:.2f}s")
    rows = sorted(TIMES.items(), key=lambda kv: -kv[1])
    for name, t in rows:
        print(f"  {name:26s} {t*1e3:9.1f} ms total  {COUNTS[name]:4d} calls  "
              f"{t*1e3/max(1,COUNTS[name]):8.1f} ms/call")


if __name__ == "__main__":
    main()
