"""LDPC reconciliation core: code construction, syndrome encode, BP decode.

Reference capability: the ``-ldpc`` fork's one-way syndrome reconciliation
replacing Cascade/BICONF inside ``errorcorrection/`` (SURVEY.md §3 #13, §4.4).
Everything here is a fresh accelerator-first design: quasi-cyclic codes so that the
check-side <-> variable-side message permutation is a circulant roll.
"""

from qtpu.ldpc.codes import QCCode, make_regular_code, RateLadder, make_rate_ladder
from qtpu.ldpc import golden as golden
