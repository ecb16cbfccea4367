"""DE-optimize base-column degree profiles for the 7 production rungs.

Hill-climbs qtpu.ldpc.design.optimize_profile at nb=32 for each production
mb (16, 13, 11, 9, 7, 5, 4), starting from BOTH existing profiles, and
prints the best profile + DE threshold per rung.  Offline (pure NumPy) —
empirical FER validation on the GPU is a separate step (profile_sweep_prod.py).

Usage: python benchmarks/design_opt.py [mb ...]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qtpu.ldpc.design import de_threshold, optimize_profile
from qtpu.ldpc.codes import irregular_profile, irregular_profile_v2

NB = 32
PROD_MBS = (16, 13, 11, 9, 7, 5, 4)


def main() -> None:
    mbs = [int(x) for x in sys.argv[1:]] or list(PROD_MBS)
    results = {}
    for mb in mbs:
        t0 = time.time()
        cands = []
        for name, init in (("v1", irregular_profile(NB, mb)),
                           ("v2", irregular_profile_v2(NB, mb))):
            cap = min(mb, 12)
            init = [min(d, cap) for d in init]
            prof, th = optimize_profile(NB, mb, init=init, rounds=150,
                                        bins=512, max_iters=100,
                                        seed=mb * 100 + (name == "v2"),
                                        verbose=False)
            # Confirm at full resolution.
            th_hi = de_threshold(prof, mb, bins=1024, max_iters=150)
            cands.append((th_hi, prof, name))
            print(f"mb={mb} from {name}: search_th={th:.4f} "
                  f"confirm_th={th_hi:.4f} profile={prof}", flush=True)
        th_hi, prof, name = max(cands)
        base1 = de_threshold(irregular_profile(NB, mb), mb, bins=1024,
                             max_iters=150)
        results[mb] = (prof, th_hi)
        print(f"BEST mb={mb}: th={th_hi:.4f} (v1 baseline {base1:.4f}) "
              f"profile={prof}  [{time.time() - t0:.0f}s]", flush=True)
    print("\nresults = {")
    for mb, (prof, th) in results.items():
        print(f"    {mb}: ({prof}, {th:.4f}),")
    print("}")


if __name__ == "__main__":
    main()
