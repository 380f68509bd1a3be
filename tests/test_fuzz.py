"""Cross-engine fuzz: random tables AND random scoring parameters.

The parametrized engine tests pin a handful of realistic parameter
settings; this sweep drives the case algebra through adversarial
regimes too (positive shift rewards, zero gap costs, asymmetric
magnitudes), asserting the lone-pair XLA scan and the bucketed corpus path stay
bit-exact with the numpy oracle on score, trace, and the
traceback-completeness flag.
"""

import numpy as np
import pytest

from bialign_tpu.ops import reference_dp, xla_dp
from bialign_tpu.ops import traceback as host_tb
from bialign_tpu.ops import device_traceback as dtb
from bialign_tpu.parallel import batch as pbatch


def _case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 14))
    m = int(rng.integers(1, 14))
    S = int(rng.integers(0, 3))
    beta, gamma, delta = (int(v) for v in rng.integers(-500, 201, 3))
    if beta == 0:
        beta = -1  # beta != 0 keeps the affine engine selected
    mu1 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu2 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu1[1:, 1:] = rng.integers(-500, 900, (n, m))
    mu2[1:, 1:] = rng.integers(-500, 900, (n, m))
    return n, m, S, beta, gamma, delta, mu1, mu2


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_affine_engines_bit_exact(seed):
    n, m, S, beta, gamma, delta, mu1, mu2 = _case(seed)
    H = reference_dp.fill_affine(mu1, mu2, S, beta, gamma, delta)
    want_score = reference_dp.affine_score_from_band(H, n, m, S)
    want_tr, want_c = host_tb.affine_traceback(H, mu1, mu2, S, beta,
                                               gamma, delta)

    xband = xla_dp.fill_affine_device(mu1, mu2, S, beta, gamma, delta)
    assert xband.final_score() == want_score, (seed, S, beta, gamma, delta)
    xtr, xc = dtb.affine_traceback(xband, beta, gamma, delta, mu1, mu2)
    assert (xtr, xc) == (want_tr, want_c), seed

    scores, traces, comps = pbatch.align_batch(
        [(mu1, mu2)], S, (beta, gamma, delta), affine=True,
        bucket_quantum=16)
    assert scores[0] == want_score, seed
    assert (traces[0], comps[0]) == (want_tr, want_c), seed


@pytest.mark.parametrize("seed", range(12, 20))
def test_fuzz_nonaffine_engines_bit_exact(seed):
    n, m, S, _b, gamma, delta, mu1, mu2 = _case(seed)
    H = reference_dp.fill_nonaffine(mu1, mu2, S, gamma, delta)
    want_score = reference_dp.nonaffine_score_from_band(H, n, m, S)
    want_tr = host_tb.nonaffine_traceback(H, mu1, mu2, S, gamma, delta)

    xband = xla_dp.fill_nonaffine_device(mu1, mu2, S, gamma, delta)
    assert xband.final_score() == want_score, (seed, S, gamma, delta)
    assert dtb.nonaffine_traceback(xband, gamma, delta, mu1, mu2) \
        == want_tr, seed

    scores, traces, _ = pbatch.align_batch(
        [(mu1, mu2)], S, (gamma, delta), affine=False, bucket_quantum=16)
    assert scores[0] == want_score, seed
    assert traces[0] == want_tr, seed
