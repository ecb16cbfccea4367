"""Protocol-deterministic randomness.

Reference capability: ``errorcorrection/rnd.c`` (SURVEY.md §3 #16) — a
deterministic PRNG both parties run from exchanged seeds so permutations,
test-bit choices and privacy-amplification matrices agree bit-exactly.

Design (round-2 rework): the host-side protocol PRNG is PURE NUMPY —
a SHA-256 key-derivation tree plus Philox counter-based bit generation.
Every protocol use-site derives its key as

    derive(root, "purpose", block_id, ...)

so Alice and Bob obtain identical randomness from the exchanged 64-bit
session seed with zero coordination, and the derivation is
order-independent (no hidden global stream position, unlike the
reference's LFSR).

Why not jax.random on the host: protocol PRNG calls are tiny and
latency-bound, and each eager jax dispatch is a device round trip.
SHA-256 + Philox is ~microseconds on the host, has a
stable cross-version specification (a cryptographic hash and a published
counter cipher), and is arguably the more defensible choice for a QKD
protocol than an ML library's stream layout.

Keys are ``np.ndarray`` of 2 uint32 (64 bits of derived key material).
DEVICE programs receive this raw data via :func:`key_data` and wrap it
with ``jax.random.wrap_key_data`` (threefry) for on-device per-block seed
expansion — see qtpu.window_programs._seed_rows; that half of the tree
runs as part of the fused jitted programs, not eagerly.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Union

import numpy as np

__all__ = ["root_key", "derive", "random_bits", "subset_indices",
           "toeplitz_seed_bits", "key_data", "key_to_numpy_seed"]

PathElem = Union[str, int]


def _tag_bytes(p: PathElem) -> bytes:
    """Unambiguous byte encoding of a path element (type- and
    length-prefixed so e.g. "ab"/1 can't collide with "a"/"b1")."""
    if isinstance(p, str):
        b = p.encode("utf-8")
        return b"s" + struct.pack("<I", len(b)) + b
    if isinstance(p, (int, np.integer)):
        return b"i" + struct.pack("<q", int(p))
    raise TypeError(f"path elements must be str/int, got {type(p)!r}")


def _mix(data: bytes) -> np.ndarray:
    """64-bit key material from arbitrary bytes (first 8 bytes of SHA-256),
    as the uint32[2] layout device threefry keys use."""
    h = hashlib.sha256(data).digest()[:8]
    return np.frombuffer(h, dtype=np.uint32).copy()


def root_key(seed: int) -> np.ndarray:
    """Session root key from the exchanged seed."""
    return _mix(b"qtpu-root" + struct.pack("<Q", seed & 0xFFFFFFFFFFFFFFFF))


def derive(key: np.ndarray, *path: PathElem) -> np.ndarray:
    """Derive a sub-key along a labeled path; distinct paths give
    independent keys (SHA-256 chaining, 64-bit truncation)."""
    data = np.asarray(key, np.uint32).tobytes()
    for p in path:
        data = hashlib.sha256(data + _tag_bytes(p)).digest()[:8]
    return np.frombuffer(data, dtype=np.uint32).copy()


def key_data(key: np.ndarray) -> np.ndarray:
    """Raw key data (uint32[2] numpy) — the form device programs take keys
    in (re-wrapped inside jit with jax.random.wrap_key_data), so the host
    protocol PRNG never dispatches eager accelerator ops."""
    return np.asarray(key, np.uint32)


def _generator(key: np.ndarray) -> np.random.Generator:
    """Philox generator keyed by the full SHA-256 of the derived key (the
    64-bit tree key is stretched to Philox's 256-bit key space)."""
    digest = hashlib.sha256(b"qtpu-philox"
                            + np.asarray(key, np.uint32).tobytes()).digest()
    return np.random.Generator(
        np.random.Philox(key=int.from_bytes(digest[:16], "little")))


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """Uniform {0,1} uint8 bits of the given shape."""
    return _generator(key).integers(0, 2, size=shape, dtype=np.uint8)


def subset_indices(key: np.ndarray, n: int, k: int) -> np.ndarray:
    """Choose k of n positions without replacement (QBER test bits).

    Deterministic given the key; both parties compute the same subset.
    """
    return _generator(key).choice(n, size=k, replace=False).astype(np.int64)


def toeplitz_seed_bits(key: np.ndarray, n_in: int, n_out: int) -> np.ndarray:
    """The n_in + n_out - 1 random bits defining a Toeplitz matrix row/col."""
    return random_bits(key, (n_in + n_out - 1,))


def key_to_numpy_seed(key: np.ndarray) -> int:
    """Collapse a key to a 64-bit integer for host-side numpy RNGs
    (non-protocol uses only — simulators, tests)."""
    data = np.asarray(key, np.uint32).astype(np.uint64)
    return int((data[0] << np.uint64(32) | data[1]) & np.uint64(0xFFFFFFFFFFFFFFFF))
