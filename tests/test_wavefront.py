"""Batched wavefront paths: bit-exact vs the numpy oracle.

The corpus paths fill a whole bucket at its padded shape with per-pair
true lengths as data (parallel/batch.py); these tests pin the emitted
bands, scores and device walks against the oracle across band widths,
degenerate lengths and both recurrences, on the XLA engine the CPU runs.
The CUDA kernel fills the same bands on the GPU (tests/test_cuda.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bialign_tpu.ops import reference_dp
from bialign_tpu.ops import traceback as host_tb
from bialign_tpu.ops.band import DeviceBand
from bialign_tpu.parallel import batch as pbatch


def _rand_pair(rng, n, m, scale=100):
    mu1 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu2 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu1[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * scale
    mu2[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * scale
    return mu1, mu2


CASES = [
    (5, 7, 1, -150, -50, -150),
    (8, 8, 2, -100, -200, -250),
    (12, 3, 1, -150, -50, -210),
    (1, 1, 1, -150, -50, -150),
    (6, 6, 2, -50, -100, -100),
    (7, 9, 0, -150, -50, -150),   # max_shift 0 (reference bialign.ipynb)
]


def _genuine_mask(n, m, S):
    """Mask of band cells whose (k, l) lie inside [0,n]x[0,m]."""
    i = np.arange(n + 1)[:, None, None, None]
    j = np.arange(m + 1)[None, :, None, None]
    k = i + np.arange(2 * S + 1)[None, None, :, None] - S
    l = j + np.arange(2 * S + 1)[None, None, None, :] - S
    return (k >= 0) & (k <= n) & (l >= 0) & (l <= m)


def _bucket_band(mu1, mu2, S, params, affine, pad=(3, 2)):
    """One pair's band from the bucket path, at a bucket shape larger
    than the pair (true lengths as data)."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    N, M = n + pad[0], m + pad[1]
    m1 = jnp.asarray(pbatch.stack_padded([mu1], N, M))
    m2 = jnp.asarray(pbatch.stack_padded([mu2], N, M))
    ns = jnp.asarray([n], jnp.int32)
    ms = jnp.asarray([m], jnp.int32)
    ys = pbatch._band_planes(m1, m2, ns, ms, S, params, affine, "xla")
    return DeviceBand(ys=ys[0], n=n, m=m, max_shift=S, affine=affine)


@pytest.mark.parametrize("n,m,S,beta,gamma,delta", CASES)
def test_bucket_band_matches_oracle(n, m, S, beta, gamma, delta):
    rng = np.random.default_rng(n * 37 + m * 5 + S)
    mu1, mu2 = _rand_pair(rng, n, m)
    H = reference_dp.fill_affine(mu1, mu2, S, beta, gamma, delta)
    band = _bucket_band(mu1, mu2, S, (beta, gamma, delta), True)
    got = band.to_numpy()
    assert got.shape == H.shape
    ok = _genuine_mask(n, m, S)[None]
    assert np.where(ok, got == H, True).all(), (
        f"mismatch at {np.argwhere(ok & (got != H))[:5]}"
    )
    assert band.final_score() == reference_dp.affine_score_from_band(
        H, n, m, S
    )


@pytest.mark.parametrize("n,m,S,beta,gamma,delta", CASES[:3])
def test_align_batch_affine_traceback(n, m, S, beta, gamma, delta):
    rng = np.random.default_rng(n + m + S)
    mu1, mu2 = _rand_pair(rng, n, m)
    H = reference_dp.fill_affine(mu1, mu2, S, beta, gamma, delta)
    want, want_complete = host_tb.affine_traceback(
        H, mu1, mu2, S, beta, gamma, delta
    )
    _, traces, comps = pbatch.align_batch(
        [(mu1, mu2)], S, (beta, gamma, delta), affine=True,
        bucket_quantum=16,
    )
    assert [tuple(c) for c in traces[0]] == [tuple(c) for c in want]
    assert comps[0] == want_complete


def test_score_batch_single_pair():
    rng = np.random.default_rng(0)
    mu1, mu2 = _rand_pair(rng, 9, 11)
    H = reference_dp.fill_affine(mu1, mu2, 1, -150, -50, -150)
    want = reference_dp.affine_score_from_band(H, 9, 11, 1)
    got = pbatch.score_batch([(mu1, mu2)], 1, (-150, -50, -150),
                             affine=True, bucket_quantum=8)
    assert got[0] == want


NA_CASES = [
    (5, 7, 1, -200, -250),
    (8, 8, 2, -200, -250),
    (12, 3, 1, -100, -150),
    (1, 1, 1, -200, -250),
    (6, 6, 2, -50, -100),
    (7, 9, 0, -200, -250),        # max_shift 0
]


@pytest.mark.parametrize("n,m,S,gamma,delta", NA_CASES)
def test_bucket_band_nonaffine_matches_oracle(n, m, S, gamma, delta):
    rng = np.random.default_rng(n * 31 + m * 7 + S)
    mu1, mu2 = _rand_pair(rng, n, m)
    H = reference_dp.fill_nonaffine(mu1, mu2, S, gamma, delta)
    band = _bucket_band(mu1, mu2, S, (gamma, delta), False)
    got = band.to_numpy()
    assert got.shape == H.shape
    ok = _genuine_mask(n, m, S)
    assert np.where(ok, got == H, True).all(), (
        f"mismatch at {np.argwhere(ok & (got != H))[:5]}"
    )
    want = reference_dp.nonaffine_score_from_band(H, n, m, S)
    assert band.final_score() == want
    got_s = pbatch.score_batch([(mu1, mu2)], S, (gamma, delta),
                               affine=False, bucket_quantum=8)
    assert got_s[0] == want


@pytest.mark.parametrize("n,m,S,gamma,delta", NA_CASES[:3])
def test_align_batch_nonaffine_traceback(n, m, S, gamma, delta):
    rng = np.random.default_rng(n + m + S + 1)
    mu1, mu2 = _rand_pair(rng, n, m)
    H = reference_dp.fill_nonaffine(mu1, mu2, S, gamma, delta)
    want = host_tb.nonaffine_traceback(H, mu1, mu2, S, gamma, delta)
    _, traces, _ = pbatch.align_batch([(mu1, mu2)], S, (gamma, delta),
                                      affine=False, bucket_quantum=16)
    assert [tuple(c) for c in traces[0]] == [tuple(c) for c in want]


def test_align_batch_nonaffine_golden_rna():
    """README toy RNA, non-affine CLI defaults → SCORE 6300 (BASELINE.md),
    through the corpus alignment path."""
    from bialign_tpu import BiAligner

    ba = BiAligner(
        "GCGGGGGAUAUCCCCAUCG", "GGGGAUAUCCCCAUCG",
        "...(((.....))).....", ".(((.....)))....."[:16],
        engine="numpy", type="RNA", structure_weight=400,
        gap_opening_cost=0, gap_cost=-200, shift_cost=-250, max_shift=2,
    )
    scores, traces, _ = pbatch.align_batch(
        [(ba.mu1, ba.mu2)], 2, (-200, -250), affine=False)
    assert scores[0] == 6300 == ba.optimize()
    lines = list(ba.decode_trace(traces[0]))
    assert lines[0].split()[-1] == "GCGGGGGAUAUCCCCAUCG"
    assert lines[1].split()[-1] == "--GGGGAUAUCCCC-AUCG"


def test_bucketed_compile_key_shared_across_lengths():
    """Pairs of different lengths in one bucket produce identically
    shaped device inputs (one compile per bucket) and still score
    bit-exactly vs the oracle."""
    rng = np.random.default_rng(7)
    pairs, shapes = [], []
    for (n, m) in [(9, 8), (11, 10), (12, 9)]:   # all bucket to (16, 16)
        mu1 = rng.integers(-300, 400, (n + 1, m + 1)).astype(np.int32)
        mu2 = rng.integers(0, 500, (n + 1, m + 1)).astype(np.int32)
        pairs.append((mu1, mu2))
        (b,) = pbatch.make_buckets([(mu1, mu2)], 16).values()
        shapes.append(tuple(a.shape for a in pbatch._pack(b, 0, 1, None)))
    assert len(set(shapes)) == 1, shapes
    got = pbatch.score_batch(pairs, 1, (-150, -50, -120), affine=True,
                             bucket_quantum=16)
    for (mu1, mu2), g in zip(pairs, got):
        n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
        H = reference_dp.fill_affine(mu1, mu2, 1, -150, -50, -120)
        assert g == reference_dp.affine_score_from_band(H, n, m, 1)


def test_auto_chunk_bounds_band_memory():
    """Alignment chunks keep one chunk's bands under the budget (XLA band
    layout [B, N+M+1, Q, N+1, W, W] int32), at least one pair each."""
    for (N, M, S, affine) in [(512, 512, 1, True), (128, 128, 2, False),
                              (4096, 4096, 2, True)]:
        B = pbatch._auto_chunk(N, M, S, affine, budget=1 << 30)
        per = (N + M + 1) * (9 if affine else 1) * (N + 1) \
            * (2 * S + 1) ** 2 * 4
        assert B >= 1
        assert B == 1 or B * per <= 1 << 30


@pytest.mark.parametrize("S", [3, 4])
def test_wide_shift_band_parity(S):
    """max_shift beyond the CLI default (the reference accepts any
    value): score and device traceback vs the oracle."""
    rng = np.random.default_rng(40 + S)
    mu1, mu2 = _rand_pair(rng, 8, 10)
    H = reference_dp.fill_affine(mu1, mu2, S, -150, -50, -150)
    want = reference_dp.affine_score_from_band(H, 8, 10, S)
    scores, traces, _ = pbatch.align_batch(
        [(mu1, mu2)], S, (-150, -50, -150), affine=True, bucket_quantum=8)
    assert scores[0] == want
    wtr, _ = host_tb.affine_traceback(H, mu1, mu2, S, -150, -50, -150)
    assert [tuple(c) for c in traces[0]] == [tuple(c) for c in wtr]


@pytest.mark.parametrize("n,m", [(7, 9), (1, 1), (0, 3), (5, 0), (20, 13)])
def test_ms0_batched_score(n, m):
    """max_shift 0 through the batched scorer == oracle, incl.
    degenerate lengths."""
    rng = np.random.default_rng(n * 13 + m)
    mu1, mu2 = _rand_pair(rng, n, m)
    for beta, gamma, delta in [(-150, -50, -150), (-200, -50, -210)]:
        H = reference_dp.fill_affine(mu1, mu2, 0, beta, gamma, delta)
        want = reference_dp.affine_score_from_band(H, n, m, 0)
        got = pbatch.score_batch([(mu1, mu2)], 0, (beta, gamma, delta),
                                 affine=True, bucket_quantum=8)
        assert got[0] == want, (n, m, beta, gamma, delta)
