"""Sifting chain tests: pfind offset acquisition, coincidence matching,
splicing — against the event simulator's ground truth (SURVEY.md §4.1-4.2)."""

import numpy as np
import pytest
import jax.numpy as jnp

from qtpu.channel import EntangledPairSource
from qtpu.framing import TIME_UNITS_PER_NS, pack_bits, unpack_bits
from qtpu import sift


@pytest.fixture(scope="module")
def events():
    src = EntangledPairSource(pair_rate_hz=40_000, window_s=0.05,
                              offset_ns=9_876.25, dark_rate_hz=1_000)
    return src.generate(np.random.default_rng(123))


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    for n in (1, 31, 32, 33, 4096, 1000):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        np.testing.assert_array_equal(unpack_bits(pack_bits(bits), n), bits)
    batch = rng.integers(0, 2, (4, 130)).astype(np.uint8)
    np.testing.assert_array_equal(unpack_bits(pack_bits(batch), 130), batch)


def test_pfind_recovers_offset(events):
    span = int(0.05 * 1e9 * TIME_UNITS_PER_NS)
    est = int(sift.pfind(jnp.asarray(sift.rebase_times(events.alice.times, 0)),
                         jnp.asarray(sift.rebase_times(events.bob.times, 0)),
                         span, num_bins=1 << 18))
    true = events.true_offset_units
    # Within a couple of timing-jitter sigmas of truth.
    assert abs(est - true) < 50, f"pfind {est} vs true {true}"


def test_coincidence_match_finds_pairs(events):
    wa, wb = events.alice, events.bob
    det_a = wa.detectors.astype(np.int32)
    det_b = wb.detectors.astype(np.int32)
    r = sift.coincidence_match(
        jnp.asarray(sift.rebase_times(wa.times, 0)), jnp.asarray(det_a >> 1),
        jnp.asarray(sift.rebase_times(wb.times, 0)), jnp.asarray(det_b >> 1),
        jnp.asarray(det_b & 1),
        jnp.int32(events.true_offset_units), window=40)
    matched = np.asarray(r.matched)
    bob_idx = np.asarray(r.bob_index)
    # Every ground-truth pair must be found with the right partner.
    found = matched[events.pair_alice_idx]
    assert found.mean() > 0.99
    correct = bob_idx[events.pair_alice_idx[found]] == events.pair_bob_idx[found]
    assert correct.mean() > 0.99
    # Accidental rate must be small: matches outside ground-truth pairs.
    n_acc = matched.sum() - found.sum()
    assert n_acc < 0.05 * matched.sum()


def test_sifted_qber_near_channel_error(events):
    """End-to-end sift: matched + basis-agree events give Bob a sifted key
    whose error rate vs Alice's bits is ≈ the source's intrinsic error rate."""
    wa, wb = events.alice, events.bob
    det_a = wa.detectors.astype(np.int32)
    det_b = wb.detectors.astype(np.int32)
    r = sift.coincidence_match(
        jnp.asarray(sift.rebase_times(wa.times, 0)), jnp.asarray(det_a >> 1),
        jnp.asarray(sift.rebase_times(wb.times, 0)), jnp.asarray(det_b >> 1),
        jnp.asarray(det_b & 1),
        jnp.int32(events.true_offset_units), window=40)
    sifted = np.asarray(r.matched) & np.asarray(r.basis_ok)
    sifted[wa.count:] = False
    alice_bits = (det_a & 1).astype(np.uint8)
    bob_bits = np.asarray(r.bob_bits)
    qber = (alice_bits[sifted] ^ bob_bits[sifted]).mean()
    assert 0.005 < qber < 0.06, f"sifted QBER {qber}"
    assert sifted.sum() > 500


def test_splice_gather():
    bits = jnp.asarray(np.arange(10) % 2, dtype=jnp.uint8)
    idx = jnp.asarray([0, 3, 5, 9])
    np.testing.assert_array_equal(np.asarray(sift.splice(bits, idx)), [0, 1, 1, 1])


def test_compact_by_mask():
    vals = jnp.asarray([10, 11, 12, 13, 14])
    mask = jnp.asarray([True, False, True, False, True])
    out, count = sift.compact_by_mask(vals, mask)
    assert int(count) == 3
    np.testing.assert_array_equal(np.asarray(out)[:3], [10, 12, 14])


def test_servo_tracks_offset(events):
    """Start the servo 200 units off; chunked scan must pull the residual in."""
    wa, wb = events.alice, events.bob
    det_a = wa.detectors.astype(np.int32)
    det_b = wb.detectors.astype(np.int32)
    final_offset, results = sift.coincidence_scan(
        jnp.asarray(sift.rebase_times(wa.times, 0)), jnp.asarray(det_a >> 1),
        jnp.asarray(sift.rebase_times(wb.times, 0)), jnp.asarray(det_b >> 1),
        jnp.asarray(det_b & 1),
        jnp.int32(events.true_offset_units - 200), window=400, num_chunks=8)
    assert abs(int(final_offset) - events.true_offset_units) < 50


def test_one_to_one_exact_at_wide_window_large_frame():
    """Lexicographic (dist, index) tie-break must pick the true closest
    Alice event per Bob event even when window * Na >= 2^31 — the regime
    where the old composite dist*Na+i int32 key wrapped negative and chose
    wrong winners (round-4 advisor finding: the iterative pfind refine's
    ~4096-unit window over 2^19-event frames)."""
    rng = np.random.default_rng(7)
    na = 1 << 19
    window = 8192            # window * na = 2^32 > int32 range
    span = sift.MAX_SPAN - 1
    ta = np.sort(rng.integers(0, span, na)).astype(np.int32)
    tb = np.sort(rng.integers(0, span, na)).astype(np.int32)
    dummy = np.zeros(na, np.uint8)
    r = sift.coincidence_match(jnp.asarray(ta), jnp.asarray(dummy),
                               jnp.asarray(tb), jnp.asarray(dummy),
                               jnp.asarray(dummy), jnp.int32(0),
                               window=window)
    matched = np.asarray(r.matched)
    best = np.asarray(r.bob_index)
    # Reference winners: for each Bob event, the (dist, index)-lex smallest
    # Alice claimant (candidate = each Alice event's nearest Bob event).
    ref_matched, ref_best = sift.coincidence_match_reference(ta, tb, 0,
                                                             window)
    np.testing.assert_array_equal(matched, ref_matched)
    np.testing.assert_array_equal(best[matched], ref_best[matched])
    # Sanity: the wide window makes heavy multi-claim contention.
    assert matched.sum() > 0.5 * na
