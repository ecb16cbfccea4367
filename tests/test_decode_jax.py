"""JAX batched decoder vs golden model: bit-exactness (SURVEY.md §5.1).

BASELINE north-star: "Reconciled keys must bit-exactly match the reference
decoder's output at matched QBER" — the golden model is the reference here.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from qtpu.ldpc.codes import make_regular_code
from qtpu.ldpc import golden
from qtpu.ldpc.encode import make_batch_encoder
from qtpu.ldpc.decode import make_batch_decoder, channel_llr, BIG_LLR


@pytest.fixture(scope="module")
def code():
    return make_regular_code(2048)  # smaller n keeps CPU test time low


@pytest.fixture(scope="module")
def batch(code):
    rng = np.random.default_rng(11)
    B = 8
    keys = rng.integers(0, 2, (B, code.n)).astype(np.uint8)
    qber = 0.03
    noise = (rng.random((B, code.n)) < qber).astype(np.uint8)
    bob = keys ^ noise
    syn = np.stack([golden.encode_syndrome(code, k).reshape(-1) for k in keys])
    llr = np.asarray(channel_llr(jnp.asarray(bob), qber))
    return keys, bob, llr, syn, qber


def test_batch_encode_matches_golden(code, batch):
    keys, *_ = batch
    enc = make_batch_encoder(code)
    syn = np.asarray(enc(jnp.asarray(keys)))
    for b in range(keys.shape[0]):
        np.testing.assert_array_equal(
            syn[b], golden.encode_syndrome(code, keys[b]).reshape(-1))


def test_minsum_bit_exact_vs_golden(code, batch):
    keys, _, llr, syn, _ = batch
    dec = make_batch_decoder(code, max_iters=60, alg="minsum")
    res = dec(jnp.asarray(llr), jnp.asarray(syn))
    bits = np.asarray(res.bits)
    iters = np.asarray(res.iterations)
    assert np.asarray(res.converged).all()
    for b in range(keys.shape[0]):
        g = golden.decode(code, llr[b].reshape(code.nb, code.z),
                          syn[b].reshape(code.mb, code.z), max_iters=60)
        np.testing.assert_array_equal(bits[b], g.bits.reshape(-1))
        assert iters[b] == g.iterations
        np.testing.assert_array_equal(bits[b], keys[b])


def test_sumprod_recovers_keys(code, batch):
    keys, _, llr, syn, _ = batch
    dec = make_batch_decoder(code, max_iters=60, alg="sumprod")
    res = dec(jnp.asarray(llr), jnp.asarray(syn))
    assert np.asarray(res.converged).all()
    np.testing.assert_array_equal(np.asarray(res.bits), keys)


def test_mixed_convergence_iteration_counts(code):
    """Blocks at different QBERs converge at different iterations; counts and
    outputs must be per-block exact despite batching (convergence freezing)."""
    rng = np.random.default_rng(21)
    qbers = [0.005, 0.02, 0.045, 0.06]
    keys, llrs, syns = [], [], []
    for q in qbers:
        k = rng.integers(0, 2, code.n).astype(np.uint8)
        noise = (rng.random(code.n) < q).astype(np.uint8)
        bob = k ^ noise
        keys.append(k)
        llrs.append(np.asarray(channel_llr(jnp.asarray(bob[None]), q))[0])
        syns.append(golden.encode_syndrome(code, k).reshape(-1))
    llr = np.stack(llrs); syn = np.stack(syns)
    dec = make_batch_decoder(code, max_iters=80)
    res = dec(jnp.asarray(llr), jnp.asarray(syn))
    iters = np.asarray(res.iterations)
    bits = np.asarray(res.bits)
    for b in range(len(qbers)):
        g = golden.decode(code, llr[b].reshape(code.nb, code.z),
                          syn[b].reshape(code.mb, code.z), max_iters=80)
        assert iters[b] == g.iterations, f"block {b}"
        np.testing.assert_array_equal(bits[b], g.bits.reshape(-1))
    assert iters[0] < iters[2], "harder channel takes more iterations"


def test_shortened_priors_pin_bits(code):
    """±BIG_LLR priors (shortening) must pin bits regardless of syndrome."""
    rng = np.random.default_rng(31)
    key = rng.integers(0, 2, code.n).astype(np.uint8)
    syn = golden.encode_syndrome(code, key).reshape(-1)
    noise = (rng.random(code.n) < 0.03).astype(np.uint8)
    bob = key ^ noise
    llr = np.asarray(channel_llr(jnp.asarray(bob[None]), 0.03))[0].copy()
    # Shorten first z variables: Bob knows them exactly.
    z = code.z
    llr[:z] = np.where(key[:z] == 1, -BIG_LLR, BIG_LLR)
    dec = make_batch_decoder(code, max_iters=60)
    res = dec(jnp.asarray(llr[None]), jnp.asarray(syn[None]))
    assert np.asarray(res.converged)[0]
    np.testing.assert_array_equal(np.asarray(res.bits)[0], key)


def test_layered_bit_exact_vs_golden(code, batch):
    """Row-layered schedule: bits and sweep counts must match the golden
    layered model exactly."""
    keys, _, llr, syn, _ = batch
    dec = make_batch_decoder(code, max_iters=60, alg="layered")
    res = dec(jnp.asarray(llr), jnp.asarray(syn))
    bits = np.asarray(res.bits)
    iters = np.asarray(res.iterations)
    assert np.asarray(res.converged).all()
    for b in range(keys.shape[0]):
        g = golden.decode(code, llr[b].reshape(code.nb, code.z),
                          syn[b].reshape(code.mb, code.z), max_iters=60,
                          alg="layered")
        np.testing.assert_array_equal(bits[b], g.bits.reshape(-1))
        assert iters[b] == g.iterations
        np.testing.assert_array_equal(bits[b], keys[b])


def test_layered_converges_faster_than_flooding(code, batch):
    keys, _, llr, syn, _ = batch
    fl = make_batch_decoder(code, max_iters=60, alg="minsum")(
        jnp.asarray(llr), jnp.asarray(syn))
    la = make_batch_decoder(code, max_iters=60, alg="layered")(
        jnp.asarray(llr), jnp.asarray(syn))
    assert np.asarray(la.iterations).mean() < np.asarray(fl.iterations).mean()


def _mixed_scenario(n, B, qbers, seed):
    code = make_regular_code(n)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2, (B, code.n)).astype(np.uint8)
    noise = (rng.random((B, code.n))
             < np.repeat(qbers, B // len(qbers))[:, None]).astype(np.uint8)
    syn = np.stack([golden.encode_syndrome(code, k).reshape(-1) for k in keys])
    llr = np.asarray(channel_llr(jnp.asarray(keys ^ noise), 0.03))
    return code, llr, syn


def _assert_matches_golden(code, llr, syn, alg, max_iters):
    res = make_batch_decoder(code, max_iters=max_iters, alg=alg)(
        jnp.asarray(llr), jnp.asarray(syn))
    bits = np.asarray(res.bits)
    iters = np.asarray(res.iterations)
    conv = np.asarray(res.converged)
    for b in range(llr.shape[0]):
        g = golden.decode(code, llr[b].reshape(code.nb, code.z),
                          syn[b].reshape(code.mb, code.z),
                          max_iters=max_iters, alg=alg)
        np.testing.assert_array_equal(bits[b], g.bits.reshape(-1))
        assert iters[b] == g.iterations, f"block {b}"
        assert bool(conv[b]) == g.converged, f"block {b}"


@pytest.mark.parametrize("alg", ["minsum", "layered"])
@pytest.mark.parametrize("scenario", [
    # n=1024, 8 blocks of mixed difficulty: iteration counts differ inside
    # the batch, and the 6% blocks exhaust max_iters unconverged.
    (1024, 8, (0.005, 0.02, 0.04, 0.06), 0, 40),
    # z=128 (n=2048), 16 blocks of mixed difficulty.
    (2048, 16, (0.005, 0.02, 0.04, 0.06), 7, 30),
], ids=["n1024", "z128"])
def test_mixed_difficulty_bit_exact_vs_golden(scenario, alg):
    n, B, qbers, seed, max_iters = scenario
    code, llr, syn = _mixed_scenario(n, B, qbers, seed)
    _assert_matches_golden(code, llr, syn, alg, max_iters)


@pytest.mark.parametrize("batch", [1, 5, 12])
def test_decoder_serves_any_batch(batch):
    """One XLA decoder serves every batch size the window programs use —
    the full window, a mesh shard, the compact retry — including sizes that
    are not a multiple of 8."""
    code, llr, syn = _mixed_scenario(1024, 12, (0.01, 0.03, 0.05), 3)
    _assert_matches_golden(code, llr[:batch], syn[:batch], "layered", 30)
