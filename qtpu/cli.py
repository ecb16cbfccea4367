"""Command-line interface and orchestration.

Reference capability: per-daemon CLI binaries wired by shell scripts + the
crgui control GUI (SURVEY.md §3 #18, §2 API/CLI layer).  One entry point:

    python -m qtpu.cli demo       # full chain, both parties in-process
    python -m qtpu.cli alice ...  # source-side party over TCP
    python -m qtpu.cli bob ...    # receiver-side party over TCP
    python -m qtpu.cli bench      # judge-metric benchmark (one JSON line)
    python -m qtpu.cli calibrate  # re-measure rate-ladder QBER ceilings
    python -m qtpu.cli fer        # FER sweep for one ladder rung

Two-process mode (`alice`/`bob`) carries the full protocol over a real TCP
socket (the transferd role).  Without quantum hardware both processes
simulate the same entangled source from a shared source seed, each keeping
its own party's detector events — the classical channel then behaves exactly
as deployed.

JAX_PLATFORMS selects the device as usual: ``JAX_PLATFORMS=cpu`` runs on
the CPU, and without it JAX takes the GPU.  A JAX process reserves most of a
card's memory when it starts, so two parties on ONE machine with one card
cannot both use it; run one of them (or both) with ``JAX_PLATFORMS=cpu``:

    JAX_PLATFORMS=cpu python -m qtpu.cli ... alice :9000 &
    JAX_PLATFORMS=cpu python -m qtpu.cli ... bob   :9000

In a deployment each party owns its own card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from qtpu.config import RunConfig, apply_overrides, load_config, to_dict


def _build_chain_parts(cfg: RunConfig):
    from qtpu.channel import EntangledPairSource

    s = cfg.source
    src = EntangledPairSource(
        pair_rate_hz=s.pair_rate_hz, window_s=s.window_s,
        offset_ns=s.offset_ns, jitter_ns=s.jitter_ns,
        eta_alice=s.eta_alice, eta_bob=s.eta_bob,
        dark_rate_hz=s.dark_rate_hz, error_rate=s.error_rate)
    return src


def cmd_demo(cfg: RunConfig, args) -> int:
    from qtpu.chain import run_chain_loopback
    from qtpu.metrics import MetricsLogger, RateMeter

    log = MetricsLogger(path=cfg.metrics_path or None)
    meter = RateMeter()
    src = _build_chain_parts(cfg)
    import time as _time
    t0 = _time.time()
    alice, bob = run_chain_loopback(cfg.chain, num_windows=cfg.num_windows,
                                    source=src, seed=cfg.source.seed,
                                    session_seed=cfg.session_seed)
    for s in bob.sift_stats:
        log.log("sift", **s)
    for m in bob.ec.metrics:
        log.window(m)
        meter.add(m.final_bits)
    ka, kb = alice.ec.final_key_bits(), bob.ec.final_key_bits()
    ok = np.array_equal(ka, kb)
    st = bob.sift_stats
    summary = {
        "windows": bob.ec.window_id,
        "final_key_bits": int(len(ka)),
        "keys_identical": bool(ok),
        "acquired_offset_units": bob.offset,
        "final_bits_per_s_wallclock": round(meter.total_bits
                                            / max(1e-9, _time.time() - t0), 1),
        "sift": {
            "frames": len(st),
            "coincidences": sum(s["coincidences"] for s in st),
            "accidentals_est": round(sum(s["accidentals_est"] for s in st), 1),
            "sifted_bits": sum(s["sifted_bits"] for s in st),
            "servo_residual_last": st[-1]["servo_residual_units"] if st else None,
        },
        "ledger": bob.ec.ledger.as_dict(),
    }
    print(json.dumps(summary, indent=2))
    if cfg.checkpoint_path:
        with open(cfg.checkpoint_path, "w") as f:
            json.dump(bob.ec.checkpoint_state(), f)
    if cfg.keystore_path:
        from qtpu import keystore
        keystore.write_keys(cfg.keystore_path,
                            keystore.records_from_session(bob.ec))
    return 0 if ok and len(ka) > 0 else 1


def _run_party(cfg: RunConfig, args, party: str) -> int:
    """One party of a two-process TCP run (simulation-correlated source)."""
    from qtpu import sift
    from qtpu.chain import AliceChain, BobChain
    from qtpu.link import TcpLink
    from qtpu.metrics import MetricsLogger

    host, _, port = args.address.rpartition(":")
    host = host or "127.0.0.1"
    if getattr(args, "link", "python") == "native":
        from qtpu.runtime import NativeTcpLink as LinkCls
    else:
        LinkCls = TcpLink
    if party == "alice":
        link = LinkCls.listen(host, int(port))
    else:
        link = LinkCls.connect(host, int(port))
    if getattr(args, "auth_seed", None) is not None:
        from qtpu.auth import AuthedLink
        link = AuthedLink(link, int(args.auth_seed, 0), party == "alice")
        link.close = link._inner.close  # passthrough
    if party == "alice":
        chain = AliceChain(cfg.chain, cfg.session_seed, link)
    else:
        chain = BobChain(cfg.chain, cfg.session_seed, link)

    src = _build_chain_parts(cfg)
    rng = np.random.default_rng(cfg.source.seed)
    log = MetricsLogger(path=cfg.metrics_path or None)

    import os
    dbg = (lambda *a: print(f"[{party}]", *a, file=sys.stderr, flush=True)) \
        if os.environ.get("QTPU_DEBUG") else (lambda *a: None)

    for w in range(cfg.num_windows):
        ev = src.generate(rng, start_epoch=w)
        mine = ev.alice if party == "alice" else ev.bob
        chain.push_events(sift.rebase_times(mine.times, 0), mine.detectors)
        # Drain link traffic; block briefly for the peer.
        while True:
            msg = link.recv(timeout=0.05)
            if msg is None:
                # Resolve deferred decodes before going back to acquisition
                # (their acks unblock the peer's next windows).
                if getattr(chain.ec, "flush", lambda: False)():
                    continue
                break
            dbg("window-loop got", type(msg).__name__, msg.window_id)
            chain._dispatch(msg)

    # Shutdown handshake — Alice-initiated (she drives the EC protocol, so
    # only she knows when no further windows can start): when idle AND quiet
    # she sends 'bye'; Bob replies 'bye' and both close.  Long silences are
    # normal (the peer may be compiling a decoder for minutes), so only
    # idleness — not time — triggers the offer, and a generous hard limit
    # guards against a dead peer.
    from qtpu.messages import Abort
    BYE = 0xFFFFFFFF
    done = False
    hard_limit = 900
    waited = 0
    sent_bye = False
    while not done and waited < hard_limit:
        try:
            msg = link.recv(timeout=1.0)
        except (ConnectionError, OSError):
            break  # peer closed after its bye — session over
        if msg is None:
            if getattr(chain.ec, "flush", lambda: False)():
                continue
            waited += 1
            # Stalled in-flight windows (lost message / wedged peer): Alice
            # aborts them after a long quiet spell so the stream cursor can
            # resync instead of hanging until the hard limit (SURVEY §6.3).
            if waited == 300 and party == "alice":
                for w in list(getattr(chain.ec, "_inflight", {})):
                    dbg("stall -> aborting window", w)
                    chain.ec.abort_window(w, reason="stall-timeout")
            if party == "alice" and chain.idle() and not sent_bye:
                dbg("idle -> sending bye")
                link.send(Abort(window_id=BYE, reason="bye"))
                sent_bye = True
            continue
        waited = 0
        if isinstance(msg, Abort) and msg.reason == "bye":
            dbg("got bye")
            if party == "bob":
                link.send(Abort(window_id=BYE, reason="bye"))
            done = True
            continue
        dbg("shutdown-loop got", type(msg).__name__, msg.window_id)
        chain._dispatch(msg)
    link.close()

    ec = chain.ec
    for m in ec.metrics:
        log.window(m)
    if cfg.keystore_path:
        from qtpu import keystore
        keystore.write_keys(cfg.keystore_path,
                            keystore.records_from_session(ec))
    out = {
        "party": party,
        "windows": ec.window_id,
        "final_key_bits": int(len(ec.final_key_bits())),
        "ledger": ec.ledger.as_dict(),
        "key_digest": _digest(ec.final_key_bits()),
    }
    print(json.dumps(out, indent=2))
    return 0


def _digest(bits: np.ndarray) -> str:
    import hashlib

    from qtpu.framing import pack_bits
    if len(bits) == 0:
        return "empty"
    return hashlib.sha256(pack_bits(bits).tobytes()).hexdigest()[:16]


def cmd_bench(cfg: RunConfig, args) -> int:
    import bench
    bench.main()
    return 0


def cmd_calibrate(cfg: RunConfig, args) -> int:
    from qtpu.ldpc.calibrate import calibrate_ladder
    from qtpu.ldpc.codes import make_rate_ladder
    n = cfg.chain.pipeline.n
    ladder = make_rate_ladder(n, cfg.chain.pipeline.dv,
                              cfg.chain.pipeline.target_rates)
    ceilings = calibrate_ladder(ladder, verbose=True, blocks=args.blocks)
    print(json.dumps({"n": n, "max_qber": list(ceilings)}))
    return 0


def cmd_cascade(cfg: RunConfig, args) -> int:
    """Cross-check: run the Cascade golden model and contrast its leakage and
    interactivity with the LDPC ladder at the same QBER."""
    from qtpu.ldpc.cascade import ParityOracle, cascade_reconcile
    from qtpu.ldpc.codes import make_rate_ladder
    rng = np.random.default_rng(args.seed)
    n, q = args.n, args.qber
    alice = rng.integers(0, 2, n).astype(np.uint8)
    bob = alice ^ (rng.random(n) < q).astype(np.uint8)
    res = cascade_reconcile(ParityOracle(alice), bob, q, session_seed=args.seed)
    ok = bool(np.array_equal(res.bits, alice))
    ladder = make_rate_ladder(cfg.chain.pipeline.n, cfg.chain.pipeline.dv,
                              cfg.chain.pipeline.target_rates)
    step = ladder.steps[ladder.select(q)]
    print(json.dumps({
        "n": n, "qber": q, "corrected": ok,
        "cascade": {"leaked_bits": res.leaked_bits,
                    "round_trips": res.round_trips,
                    "errors_fixed": res.corrected_errors},
        "ldpc": {"rung": step.name,
                 "leaked_bits_per_block": step.leaked_bits(),
                 "payload_bits_per_block": step.payload_bits(),
                 "round_trips": 1},
    }))
    return 0 if ok else 1


def cmd_fer(cfg: RunConfig, args) -> int:
    from qtpu.ldpc.calibrate import measure_fer
    from qtpu.ldpc.codes import make_rate_ladder
    ladder = make_rate_ladder(cfg.chain.pipeline.n, cfg.chain.pipeline.dv,
                              cfg.chain.pipeline.target_rates)
    step = ladder.steps[args.rung]
    fer, iters = measure_fer(step, args.qber, blocks=args.blocks)
    print(json.dumps({"rung": step.name, "qber": args.qber, "fer": fer,
                      "mean_iters": iters}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qtpu", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", help="JSON config file")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="override a config leaf, e.g. --set source.error_rate=0.03")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("demo")
    for party in ("alice", "bob"):
        sp = sub.add_parser(party)
        sp.add_argument("address", help="host:port (alice listens, bob connects)")
        sp.add_argument("--link", choices=("python", "native"), default="python",
                        help="classical-channel transport: pure-Python TcpLink "
                             "or the C++ transferd library (qtpu.runtime)")
        sp.add_argument("--auth-seed", default=None,
                        help="pre-shared authentication seed (hex/int): wraps "
                             "the link in a Wegman-Carter MAC; consumption is "
                             "charged to the ledger as auth_bits")
    sub.add_parser("bench")
    spc = sub.add_parser("calibrate")
    spc.add_argument("--blocks", type=int, default=256)
    spf = sub.add_parser("fer")
    spf.add_argument("--rung", type=int, required=True)
    spf.add_argument("--qber", type=float, required=True)
    spf.add_argument("--blocks", type=int, default=256)
    spk = sub.add_parser("cascade")
    spk.add_argument("--n", type=int, default=4096)
    spk.add_argument("--qber", type=float, default=0.03)
    spk.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)
    import os
    if os.environ.get("QTPU_DEBUG"):
        import faulthandler
        faulthandler.dump_traceback_later(int(os.environ.get("QTPU_DEBUG_HANG_S", "120")),
                                          exit=True)
    cfg = apply_overrides(load_config(args.config), args.set)

    if args.cmd == "demo":
        return cmd_demo(cfg, args)
    if args.cmd in ("alice", "bob"):
        return _run_party(cfg, args, args.cmd)
    if args.cmd == "bench":
        return cmd_bench(cfg, args)
    if args.cmd == "calibrate":
        return cmd_calibrate(cfg, args)
    if args.cmd == "fer":
        return cmd_fer(cfg, args)
    if args.cmd == "cascade":
        return cmd_cascade(cfg, args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
