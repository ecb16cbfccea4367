"""Fine (bisection) calibration of a ladder: ceilings + short curves at
0.05% QBER resolution — the coarse 0.25% grid of calibrate_ladder quantizes
away sub-grid gains (especially at n=65536) and then forces a whole-grid-step
selection guard.

Usage: python benchmarks/calibrate_fine.py [N] [FAMILY] [BLOCKS]
Writes benchmarks/out/cal_fine_{family}_{n}.json in FINE_CALIBRATION format.
Run it on the GPU, one process per card.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    from qtpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    from qtpu.ldpc.calibrate import SHORT_FRACS, ceiling_bisect
    from qtpu.ldpc.codes import make_rate_ladder

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    family = sys.argv[2] if len(sys.argv) > 2 else "native3"
    blocks = int(sys.argv[3]) if len(sys.argv) > 3 else 192
    # Optional rung subset (comma list, arg 4): calibrate only these rungs
    # live and BORROW the rest from a smaller-n fine table (arg 5, default
    # 65536) — ceilings improve with block length for these ensembles, so
    # borrowed smaller-n values are conservative.  This is what makes an
    # n=131072 campaign affordable: only the rungs the target QBER actually
    # selects need fresh device time.
    rungs = ([int(x) for x in sys.argv[4].split(",")]
             if len(sys.argv) > 4 else None)
    borrow_n = int(sys.argv[5]) if len(sys.argv) > 5 else 65536
    lad = make_rate_ladder(n, family=family, alg="layered")
    borrow = None
    if rungs is not None:
        bpath = os.path.join(os.path.dirname(__file__), "out",
                             f"cal_fine_{family}_{borrow_n}.json")
        with open(bpath) as f:
            borrow = json.load(f)
    # Bracket each rung's bisection around its coarse ceiling; a block length
    # without its own table borrows the n=16384 table (finite-length shifts
    # are well under the ±(0.4%, 0.6%) bracket margins).
    coarse = lad.max_qber
    if coarse is None:
        from qtpu.ldpc.calibrate import DEFAULT_CALIBRATION
        coarse = DEFAULT_CALIBRATION.get((n, 3, "layered", family))
    if coarse is None and borrow is not None:
        coarse = borrow["max_qber"]
    if coarse is None:
        from qtpu.ldpc.calibrate import DEFAULT_CALIBRATION
        coarse = DEFAULT_CALIBRATION[(16384, 3, "layered", family)]
    out_ceil = []
    out_curves = []
    t00 = time.time()
    for ri, step in enumerate(lad.steps):
        if rungs is not None and ri not in rungs:
            out_ceil.append(borrow["max_qber"][ri])
            out_curves.append(list(borrow["short_ceilings"][ri]))
            print(f"{step.name}: borrowed from n={borrow_n}", flush=True)
            continue
        lo = max(0.0025, coarse[ri] - 0.004)
        hi = min(0.135, coarse[ri] + 0.006)
        curve = []
        for frac in SHORT_FRACS:
            s = int(frac * n)
            c = ceiling_bisect(step, lo, hi, blocks=blocks,
                               extra_short_bits=s, seed_base=ri * 1000)
            curve.append(c)
            # Shortening only strengthens: walk the bracket upward.
            lo, hi = max(lo, c - 0.001), min(0.135, c + 0.02)
            print(f"{step.name} short={frac:.2f}: ceiling {c:.4f} "
                  f"({time.time()-t00:.0f}s)", flush=True)
        # Monotone non-decreasing (clamp noise the safe way).
        for k in range(1, len(curve)):
            curve[k] = max(curve[k], curve[k - 1])
        out_ceil.append(curve[0])
        out_curves.append(curve)
    rec = {
        "max_qber": out_ceil,
        "short_grid": list(SHORT_FRACS),
        "short_ceilings": out_curves,
        "calib_step": 0.0005,
        "blocks": blocks,
    }
    path = os.path.join(os.path.dirname(__file__), "out",
                        f"cal_fine_{family}_{n}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"  ({n}, 3, 'layered', {family!r}): {rec}", flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
