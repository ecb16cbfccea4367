"""Batched LDPC syndrome encoding on device.

Reference capability: Alice's ``syndrome = H · key`` sparse GF(2) mat-vec in
the ``-ldpc`` fork's encode path (SURVEY.md §4.4 "encode hot loop").

Accelerator-first design: with a quasi-cyclic code, the sparse mat-vec is a
static sequence of circulant rolls + XORs — no gathers, no sparse formats.
Batch is the trailing axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qtpu.ldpc.codes import QCCode

__all__ = ["make_batch_encoder", "encode_syndrome_batch"]


def _to_internal(bits: jax.Array, nb: int, z: int) -> jax.Array:
    """(B, n) → (nb, z, B) with batch on the lane axis."""
    b = bits.shape[0]
    return jnp.transpose(bits.reshape(b, nb, z), (1, 2, 0))


def _from_internal(x: jax.Array) -> jax.Array:
    """(nb, z, B) → (B, n)."""
    nb, z, b = x.shape
    return jnp.transpose(x, (2, 0, 1)).reshape(b, nb * z)


def make_batch_encoder(code: QCCode):
    """Build a jitted ``(B, n) uint8 -> (B, m) uint8`` syndrome encoder."""
    edge_row = [int(x) for x in code.edge_row]
    edge_col = [int(x) for x in code.edge_col]
    edge_shift = [int(x) for x in code.edge_shift]
    mb, nb, z = code.mb, code.nb, code.z

    @jax.jit
    def encode(bits: jax.Array) -> jax.Array:
        x = _to_internal(bits.astype(jnp.uint8), nb, z)  # (nb, z, B)
        syn = [None] * mb
        for e in range(len(edge_row)):
            i, j, s = edge_row[e], edge_col[e], edge_shift[e]
            # Check (i, zc) touches variable (j, (zc + s) % z).
            contrib = jnp.roll(x[j], -s, axis=0)
            syn[i] = contrib if syn[i] is None else syn[i] ^ contrib
        return _from_internal(jnp.stack(syn))  # (B, m)

    return encode


def encode_syndrome_batch(code: QCCode, bits: np.ndarray) -> np.ndarray:
    """Convenience eager wrapper (tests)."""
    return np.asarray(make_batch_encoder(code)(jnp.asarray(bits)))
