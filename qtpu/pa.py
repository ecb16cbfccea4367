"""Privacy amplification: Toeplitz hashing as FFT convolution.

Reference capability: ``errorcorrection/algorithms/priv_amp.c`` (SURVEY.md §3
#14) — compress the reconciled key by the leaked+ε bits via multiplication
with a random binary Toeplitz(-equivalent) matrix whose seed is exchanged
in-protocol.

Accelerator-first design (BASELINE north-star: "Toeplitz hash as an FFT-based
multiply"):

A Toeplitz matrix T ∈ GF(2)^{m×n} built from bits t_0..t_{m+n-2}
(T[i,j] = t[i - j + n - 1]) acting on key x is a linear convolution:

    (T x)_i = Σ_j t[i - j + n - 1] · x_j = (t * x)[i + n - 1]   (mod 2)

so the whole hash is one length-(m+2n-2) real FFT multiply, batched over
blocks.  Exactness over GF(2): convolution counts are integers ≤ n; computed
in float32 rFFT the roundoff is ~‖t‖₂‖x‖₂·ε·log N ≪ 0.5 for n ≤ 2^20, and we
round to the nearest integer before reducing mod 2.  Tests verify bit-exact
agreement with the direct GF(2) mat-vec golden model for every size we use;
a float64 path is available as a guard for very long streams.

Streaming (BASELINE config 4/5): a long key stream hashed with one Toeplitz
seed is processed in overlapping segments (overlap-save); across shards the
halo is exchanged with `jax.lax.ppermute` (see qtpu.parallel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qtpu import prng

__all__ = [
    "toeplitz_hash_golden",
    "make_toeplitz_hasher",
    "toeplitz_hash_fft",
    "stream_toeplitz",
    "final_key_length",
]


def toeplitz_hash_golden(t_bits: np.ndarray, x_bits: np.ndarray, m: int) -> np.ndarray:
    """Direct GF(2) Toeplitz mat-vec (numpy golden model).

    t_bits: (m + n - 1,) 0/1 — first column then first row of T.
    x_bits: (n,) 0/1.  Returns (m,) 0/1.
    """
    t_bits = np.asarray(t_bits, np.uint8)
    x = np.asarray(x_bits, np.int64)
    n = x.shape[0]
    assert t_bits.shape[0] == m + n - 1
    out = np.zeros(m, np.int64)
    # T[i, j] = t[i - j + n - 1]
    for i in range(m):
        out[i] = int(np.dot(t_bits[i + n - 1 - np.arange(n)].astype(np.int64), x)) & 1
    return out.astype(np.uint8)


def _conv_len(n: int, m: int) -> int:
    need = (m + n - 1) + n - 1  # full linear conv length of t (m+n-1) with x (n)
    return 1 << (need - 1).bit_length()


def toeplitz_hash_fft(t_bits: jax.Array, x_bits: jax.Array, m: int,
                      precision: jnp.dtype = jnp.float32) -> jax.Array:
    """Batched FFT Toeplitz hash.

    t_bits: (B, m + n - 1) or (m + n - 1,) 0/1 — per-block Toeplitz seeds.
    x_bits: (B, n) 0/1.
    Returns (B, m) uint8.
    """
    x_bits = jnp.atleast_2d(x_bits)
    if t_bits.ndim == 1:
        t_bits = jnp.broadcast_to(t_bits[None], (x_bits.shape[0], t_bits.shape[0]))
    n = x_bits.shape[-1]
    L = _conv_len(n, m)
    t = t_bits.astype(precision)
    x = x_bits.astype(precision)
    tf = jnp.fft.rfft(t, L, axis=-1)
    xf = jnp.fft.rfft(x, L, axis=-1)
    conv = jnp.fft.irfft(tf * xf, L, axis=-1)
    # (T x)_i = conv[i + n - 1]; counts are ints ≤ n — round then mod 2.
    seg = jax.lax.dynamic_slice_in_dim(conv, n - 1, m, axis=-1)
    return (jnp.round(seg).astype(jnp.int32) & 1).astype(jnp.uint8)


def make_toeplitz_hasher(n: int, m: int, precision: jnp.dtype = jnp.float32):
    """Jitted batched hasher for fixed (n → m) compression."""

    @jax.jit
    def hasher(t_bits: jax.Array, x_bits: jax.Array) -> jax.Array:
        return toeplitz_hash_fft(t_bits, x_bits, m, precision)

    return hasher


def stream_toeplitz(t_bits: jax.Array, stream: jax.Array, m: int,
                    segment: int = 1 << 20) -> jax.Array:
    """Streaming Toeplitz hash of one LONG key stream (overlap-save).

    The session's per-block PA batches small FFTs; when one Toeplitz seed
    must span a whole key stream (BASELINE config 4/5 "streaming across
    block boundaries"), a single FFT of the full length would not fit —
    instead the stream is processed in fixed ``segment``-bit windows under
    ``lax.scan``, each contributing its partial linear convolution to the
    m-bit output:

        (T x)_i = Σ_s  conv(t[slice_s], x_s)[i]      (mod 2 after the sum)

    Counts accumulate in int32 (exact); mod-2 at the end.  Bit-exact vs
    ``toeplitz_hash_golden`` (tested at segment-boundary-crossing offsets).
    The multi-device variant with the identical math per shard plus an
    XOR-psum lives in qtpu.parallel.sharded_stream_toeplitz / make_stream_pa.

    t_bits: (m + N - 1,) seed; stream: (N,) 0/1 with N a multiple of
    ``segment`` (pad with zeros — zero bits add nothing).
    """
    N = stream.shape[0]
    segment = min(segment, N)
    assert N % segment == 0, "pad the stream to a segment multiple"
    num = N // segment
    L = segment
    conv_len = 1 << ((m + 2 * L - 2) - 1).bit_length()
    xs = stream.reshape(num, L)
    # Segment s (bits [sL, sL+L)) needs t indices (N - 1 + i) - j for
    # j in [sL, sL+L), i in [0, m): slice of length m + L - 1 starting at
    # N - 1 - sL - (L - 1).
    starts = N - L - jnp.arange(num) * L

    def step(acc, inp):
        x_s, start = inp
        t_slice = jax.lax.dynamic_slice_in_dim(t_bits, start, m + L - 1)
        tf = jnp.fft.rfft(t_slice.astype(jnp.float32), conv_len)
        xf = jnp.fft.rfft(x_s.astype(jnp.float32), conv_len)
        conv = jnp.fft.irfft(tf * xf, conv_len)
        contrib = jax.lax.dynamic_slice_in_dim(conv, L - 1, m)
        return acc + jnp.round(contrib).astype(jnp.int32), None

    acc, _ = jax.lax.scan(step, jnp.zeros(m, jnp.int32), (xs, starts))
    return (acc & 1).astype(jnp.uint8)


def final_key_length(n_reconciled: int, leaked_syndrome: int, leaked_qber: int,
                     verify_hash_bits: int, security_bits: int = 64) -> int:
    """Final-key length after subtracting every disclosed bit plus the
    ε-security margin (SURVEY.md Appendix B; reference priv_amp accounting)."""
    return max(0, n_reconciled - leaked_syndrome - leaked_qber
               - verify_hash_bits - security_bits)
