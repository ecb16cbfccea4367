"""qtpu — accelerator-native QKD post-processing framework.

A brand-new JAX/XLA implementation of the full quantum-key-distribution
post-processing signal chain covered by the reference stack
``JarryChou/qcrypto-ldpc`` (see SURVEY.md for the structural analysis and its
provenance caveats):

- event-stream simulation + epoch framing   (reference: remotecrypto/chopper*.c)
- FFT time-offset acquisition               (reference: remotecrypto/pfind.c)
- coincidence sifting + splicing            (reference: remotecrypto/costream.c,
                                             remotecrypto/splicer.c)
- QBER estimation                           (reference: errorcorrection/algorithms/qber_estim.c)
- rate-adaptive LDPC syndrome reconciliation(reference: the -ldpc fork's
                                             replacement for algorithms/cascade_biconf.c)
- Toeplitz-hash privacy amplification       (reference: errorcorrection/algorithms/priv_amp.c)
- leakage accounting + final-key framing    (reference: ecd2.c processblock manager)
- two-party classical channel               (reference: remotecrypto/transferd.c)

Design is accelerator-first: quasi-cyclic LDPC codes so belief-propagation
message permutations become circulant rolls (no gathers), batched decodes
over a ``blocks`` mesh axis via shard_map, Toeplitz hashing as a batched
rFFT and the verify hash as an int8 matmul, and psum collectives for
cross-shard accounting and the streaming hash.
"""

__version__ = "0.1.0"

# Public API surface (heavy modules import lazily where possible; these are
# the names a reference user reaches for — see ARCHITECTURE.md for the
# component map).
from qtpu.pipeline import PipelineConfig, AliceSession, BobSession, run_loopback  # noqa: E402,F401
from qtpu.chain import ChainConfig, AliceChain, BobChain, run_chain_loopback  # noqa: E402,F401
from qtpu.ldpc import QCCode, make_regular_code, make_rate_ladder  # noqa: E402,F401
