"""BASELINE config 5: time-windowed stream over >=2 processes with a global
leaked-bit psum ledger (jax.distributed on localhost).

Both processes run on the CPU: a JAX process reserves most of a card's
memory when it starts, so two processes cannot share one card."""
import json, os, subprocess, sys
here = os.path.dirname(os.path.abspath(__file__))
worker = os.path.join(os.path.dirname(here), "tests", "multihost_worker.py")
env = dict(os.environ, JAX_PLATFORMS="cpu")
procs = [subprocess.Popen([sys.executable, worker, str(i), "19911"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, env=env) for i in range(2)]
outs = [p.communicate(timeout=600)[0] for p in procs]
ok = all(p.returncode == 0 and "MULTIHOST_OK" in o for p, o in zip(procs, outs))
ledgers = [ln.split("ledger=")[1] for o in outs for ln in o.splitlines()
           if "MULTIHOST_OK" in ln]
print(json.dumps({"config": 5, "ok": ok,
                  "ledgers_agree": len(set(ledgers)) == 1,
                  "global_ledger": ledgers[0] if ledgers else None}))
