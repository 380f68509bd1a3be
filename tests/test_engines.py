"""Cross-engine equivalence: every accelerated engine must reproduce the
numpy oracle band cell-for-cell (SURVEY.md §4 test strategy item (c))."""

import numpy as np
import pytest

from bialign_tpu.ops import reference_dp, xla_dp


def _rand_tables(rng, n, m, lo=-500, hi=900):
    mu1 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu2 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu1[1:, 1:] = rng.integers(lo, hi, size=(n, m))
    mu2[1:, 1:] = rng.integers(lo, hi, size=(n, m))
    return mu1, mu2


CASES = [
    # (n, m, S, beta, gamma, delta)
    (4, 4, 1, -150, -50, -150),
    (5, 3, 1, -200, -50, -150),
    (3, 5, 2, -150, -50, -210),
    (6, 6, 2, -100, -200, -250),
    (1, 1, 1, -150, -50, -150),
    (0, 3, 1, -150, -50, -150),
    (3, 0, 1, -150, -50, -150),
    (0, 0, 1, -150, -50, -150),
    (7, 5, 3, -150, -50, -150),
]


@pytest.mark.parametrize("n,m,S,beta,gamma,delta", CASES)
def test_affine_band_equivalence(n, m, S, beta, gamma, delta):
    rng = np.random.default_rng(n * 1000 + m * 17 + S)
    mu1, mu2 = _rand_tables(rng, n, m)
    H_ref = reference_dp.fill_affine(mu1, mu2, S, beta, gamma, delta)
    H_xla = xla_dp.fill_affine(mu1, mu2, S, beta, gamma, delta)

    # compare genuine band cells only (k,l within [0,n]x[0,m] and band)
    for i in range(n + 1):
        for j in range(m + 1):
            for sk in range(2 * S + 1):
                k = i + sk - S
                if not (0 <= k <= n):
                    continue
                for sl in range(2 * S + 1):
                    l = j + sl - S
                    if not (0 <= l <= m):
                        continue
                    ref = H_ref[:, i, j, sk, sl]
                    got = H_xla[:, i, j, sk, sl]
                    assert (ref == got).all(), (
                        f"mismatch at ({i},{j},{k},{l}): {ref} vs {got}"
                    )


@pytest.mark.parametrize("n,m,S,beta,gamma,delta", CASES)
def test_nonaffine_band_equivalence(n, m, S, beta, gamma, delta):
    rng = np.random.default_rng(n * 999 + m * 31 + S)
    mu1, mu2 = _rand_tables(rng, n, m)
    H_ref = reference_dp.fill_nonaffine(mu1, mu2, S, gamma, delta)
    H_xla = xla_dp.fill_nonaffine(mu1, mu2, S, gamma, delta)

    for i in range(n + 1):
        for j in range(m + 1):
            for sk in range(2 * S + 1):
                k = i + sk - S
                if not (0 <= k <= n):
                    continue
                for sl in range(2 * S + 1):
                    l = j + sl - S
                    if not (0 <= l <= m):
                        continue
                    assert (
                        H_ref[i, j, sk, sl] == H_xla[i, j, sk, sl]
                    ), f"mismatch at ({i},{j},{k},{l})"


def test_score_only_matches_band():
    rng = np.random.default_rng(7)
    mu1, mu2 = _rand_tables(rng, 9, 8)
    S, beta, gamma, delta = 1, -150, -50, -150
    H = reference_dp.fill_affine(mu1, mu2, S, beta, gamma, delta)
    want = reference_dp.affine_score_from_band(H, 9, 8, S)
    got = xla_dp.fill_affine(mu1, mu2, S, beta, gamma, delta,
                             score_only=True)
    assert got == want

    Hn = reference_dp.fill_nonaffine(mu1, mu2, S, gamma, delta)
    wantn = reference_dp.nonaffine_score_from_band(Hn, 9, 8, S)
    gotn = xla_dp.fill_nonaffine(mu1, mu2, S, gamma, delta, score_only=True)
    assert gotn == wantn


def test_int32_overflow_uses_int64_engine():
    """Inputs beyond the certified int32 range must warn and run the
    vectorized int64 XLA scan (not the host oracle), bit-matching the
    oracle's score and decoded alignment (VERDICT r2 item 9)."""
    import pytest

    from bialign_tpu import BiAligner

    seqA, seqB = "ACDEFGHIKL", "ACDEFGAIKL"
    strA, strB = "HHHHHEEEEE", "HHHHEEEEEC"
    params = dict(
        type="Protein", structure_weight=500_000_000,  # path sums > 2^31
        simmatrix="BLOSUM62", gap_opening_cost=-150, gap_cost=-50,
        shift_cost=-150, max_shift=1,
    )
    ba = BiAligner(seqA, seqB, strA, strB, engine="xla", **params)
    with pytest.warns(RuntimeWarning, match="int64 XLA engine"):
        score = ba.optimize()
    assert score > np.iinfo(np.int32).max  # int32 would have overflowed

    oracle = BiAligner(seqA, seqB, strA, strB, engine="numpy", **params)
    assert score == oracle.optimize()
    assert list(ba.decode_trace()) == list(oracle.decode_trace())


def test_a_const_separable_factorization():
    """The group-A constant table factors into per-pair terms for any
    params (the method itself raises on any violation)."""
    from bialign_tpu.ops.cases import AffineTables, STATES

    for (b, g, d) in [(-150, -50, -150), (-200, -50, -210), (-7, -13, -29),
                      (100, 50, 75), (0, -200, -250)]:
        tabs = AffineTables(b, g, d)
        base, cseq, cstr, sidx, qseq, qstr = tabs.a_const_separable()
        A = tabs.a_const
        for q in range(9):
            for s in range(9):
                assert (base[q] + cseq[qseq[q]][qseq[s]]
                        + cstr[qstr[q]][qstr[s]]) == int(A[q, s])


def test_max_shift_zero_end_to_end():
    """max_shift 0 (the reference's fastest bialign.ipynb config) through
    the full path on every engine: fill + traceback + decode agree."""
    from bialign_tpu import BiAligner

    outs = []
    for engine in ("numpy", "xla", "auto"):
        ba = BiAligner(
            "GCGGGGGAUAUCCCCAUCG", "GGGGAUAUCCCCAUCG",
            "...(((.....))).....", ".(((.....)))....",
            engine=engine, type="RNA", structure_weight=400,
            gap_opening_cost=-200, gap_cost=-50, shift_cost=-150,
            max_shift=0,
        )
        outs.append((ba.optimize(), list(ba.decode_trace())))
    assert outs[0] == outs[1] == outs[2]
    score, lines = outs[0]
    # shift rows must be all dots at max_shift 0
    assert set(lines[-1].split()[-1]) == {"."}
    assert set(lines[-2].split()[-1]) == {"."}
