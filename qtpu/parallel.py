"""Multi-chip / multi-host scaling: meshes, collectives, streaming halos.

Reference analog: the reference stack is serial single-core C; its only
"distribution" is the Unix pipeline (SURVEY.md §3 parallelism table).  All
parallelism here is this framework's own design, anchored in BASELINE.json:

- **DP over key blocks** ("blocks" mesh axis): each device decodes its shard
  of the batch; no communication inside the decode (SURVEY.md §4.4 — this is
  why LDPC batches and Cascade doesn't).
- **SP over the key stream** ("stream" axis): time-windows shard across
  chips/hosts; the streaming Toeplitz hash spans shard boundaries.  DESIGN
  DECISION (round 4): of the two candidate realizations of BASELINE.json:5's
  "overlap boundaries exchanged via collective permutes" — (a) a `ppermute`
  halo exchange re-homing boundary-crossing PA units, vs (b) a distributed
  global hash whose per-shard partial convolutions combine with an integer
  `psum` across devices — the build ships (b) (`sharded_stream_toeplitz` /
  `make_stream_pa`).  The psum form needs no halo bookkeeping, keeps every
  shard's FFT independent, moves exactly m output counts per shard (vs a
  seed-length halo), and is bit-exact against the golden Toeplitz; a halo
  prototype was carried through round 3 and deleted in round 4 because no
  product path ever needed it.
- **Global accounting**: the leakage ledger aggregates with `psum`
  (BASELINE config 5: "global leaked-bit psum accounting").

Multi-host entry: `init_distributed()` wraps jax.distributed.initialize; all
code below only sees the global mesh, so a multi-card host, several hosts
and the 8-device forced-CPU test mesh run identical programs (SURVEY.md
§5.4).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qtpu.accounting import LEDGER_FIELDS

__all__ = [
    "init_distributed", "make_mesh", "psum_ledger",
    "make_sharded_decoder",
    "sharded_stream_toeplitz", "make_stream_pa",
]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (jax.distributed); no-op for single-process runs."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def make_mesh(axis: str = "blocks", num: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D device mesh over all (or the first `num`) global devices."""
    devs = list(devices if devices is not None else jax.devices())
    if num is not None:
        devs = devs[:num]
    return Mesh(np.array(devs), (axis,))


def psum_ledger(local_vec: jax.Array, axis: str) -> jax.Array:
    """Global leakage ledger = psum of per-shard ledger vectors (int32)."""
    return jax.lax.psum(local_vec, axis)


def make_sharded_decoder(code, mesh: Mesh, max_iters: int = 50,
                         alg: str = "minsum"):
    """DP decode: shard the block batch over the mesh's first axis.

    Returns a jitted fn (llr (B, n), syndrome (B, m)) -> BatchDecodeResult
    with B sharded; every device runs the same single-device decoder on its
    shard (no collectives in the hot loop, by design).
    """
    from qtpu.ldpc.decode import make_batch_decoder
    axis = mesh.axis_names[0]
    local = make_batch_decoder(code, max_iters, alg)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=(P(axis, None), P(axis), P(axis)),
    )
    def decode(llr, syn):
        r = local(llr, syn)
        return r.bits, r.converged, r.iterations

    from qtpu.ldpc.decode import BatchDecodeResult

    def wrapped(llr, syn):
        bits, conv, iters = decode(llr, syn)
        return BatchDecodeResult(bits=bits, converged=conv, iterations=iters)

    return wrapped


def sharded_stream_toeplitz(t_bits: jax.Array, x_local: jax.Array, m: int,
                            axis: str) -> jax.Array:
    """Global Toeplitz hash of a sharded key stream (call under shard_map).

    The stream x (length N = D*L) is sharded as x_local (L,) per device;
    t_bits is the full (m + N - 1,) Toeplitz seed (replicated).  Each shard
    convolves its window with the relevant slice of t, then the m-bit output
    combines across shards with an XOR-psum over the mesh:

        (T x)_i = XOR_s  conv(t_slice_s, x_s)[i]        i in [0, m)

    Counts stay integers; mod-2 happens after the psum so the reduction is a
    plain integer psum (collective-friendly).
    """
    L = x_local.shape[0]
    s = jax.lax.axis_index(axis)
    # Needed t indices for shard s: (N - 1 + i) - j for j in [sL, sL+L),
    # i in [0, m) → a contiguous slice of length m + L - 1 starting at
    # N - 1 - sL - (L - 1).
    n_total = L * jax.lax.axis_size(axis)
    start = n_total - (s + 1) * L
    t_slice = jax.lax.dynamic_slice_in_dim(t_bits, start, m + L - 1)
    # Full linear convolution via rFFT (counts ≤ L, exact in f32).
    conv_len = 1
    need = (m + L - 1) + L - 1
    while conv_len < need:
        conv_len *= 2
    tf = jnp.fft.rfft(t_slice.astype(jnp.float32), conv_len)
    xf = jnp.fft.rfft(x_local.astype(jnp.float32), conv_len)
    conv = jnp.fft.irfft(tf * xf, conv_len)
    # Output alignment: conv index (L - 1 + i) holds (T x)_i's contribution.
    contrib = jax.lax.dynamic_slice_in_dim(conv, L - 1, m)
    counts = jnp.round(contrib).astype(jnp.int32)
    total = jax.lax.psum(counts, axis)
    return (total & 1).astype(jnp.uint8)


def make_stream_pa(mesh: Mesh, n_stream: int, m: int):
    """Jitted multi-device streaming privacy amplification (PRODUCT path —
    the session's stream-PA mode calls this when given a mesh).

    One Toeplitz seed spans the whole key stream; the stream shards over the
    mesh's first axis, each device convolves its window with its slice of the
    seed, and the m-bit output combines with an integer psum over the mesh
    (BASELINE.json:5 "streaming across block boundaries via collective
    permute/psum").  Bit-exact vs qtpu.pa.toeplitz_hash_golden.

    Returns ``pa(t_bits (m + n_stream - 1,), stream (n_stream,)) -> (m,)``.
    """
    axis = mesh.axis_names[0]
    assert n_stream % mesh.size == 0, "stream must shard evenly (pad zeros)"

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P(), P(axis)), out_specs=P())
    def pa(t_bits, stream):
        return sharded_stream_toeplitz(t_bits, stream, m, axis)

    return pa
