"""Triplet bi-alignment: one copy of A vs two copies of B.

A working re-design of the reference's legacy ``BiAlignerTriplet``
(bialign_triplet.py:12-153 — un-importable dead code there: SyntaxError at
line 28 and references to removed attributes; the recursion it *intended*
is preserved in its ``recursionCases``).  The DP is 3-dimensional:
``M[i, j, k]`` with ``i`` over A, ``j``/``k`` over two copies of B (the
sequence-alignment copy and the structure-alignment copy), banded by
``|k - j| <= max_shift``.

Seven cases per cell (reference order, bialign_triplet.py:28-35), with the
flat (non-affine) gap model of the main aligner:

    (1,1,1)  mu1(i,j) + mu2(i,k)          synchronous match
    (1,0,0)  2*gamma                       A advances alone
    (0,1,1)  2*gamma                       both Bs advance
    (1,1,0)  mu1(i,j) + gamma + Delta      seq-match, str-gap (shift)
    (1,0,1)  mu2(i,k) + gamma + Delta      str-match, seq-gap (shift)
    (0,1,0)  gamma + Delta
    (0,0,1)  gamma + Delta

Engines: a numpy oracle (correctness anchor) and an XLA anti-diagonal
wavefront over ``d = i + j`` — the same mapping as the 4D engine, with
the band offset ``sk = k - j + S`` on a small axis.
"""

from __future__ import annotations

import numpy as np

from ..ops.cases import NEG_INF

# case columns (di, dj, dk) in reference enumeration order
TRIPLET_COLS = (
    (1, 1, 1),
    (1, 0, 0),
    (0, 1, 1),
    (1, 1, 0),
    (1, 0, 1),
    (0, 1, 0),
    (0, 0, 1),
)


def _case_consts(gamma: int, delta: int):
    """(const, mu1_coef, mu2_coef) per case."""
    return [
        (0, 1, 1),
        (2 * gamma, 0, 0),
        (2 * gamma, 0, 0),
        (gamma + delta, 1, 0),
        (gamma + delta, 0, 1),
        (gamma + delta, 0, 0),
        (gamma + delta, 0, 0),
    ]


def fill_oracle(mu1, mu2, max_shift, gamma, delta):
    """Cell-by-cell fill; returns M[i, j, k] (full (m+1)^2 plane, cells
    outside the band stay 0 and are never read)."""
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    S = max_shift
    consts = _case_consts(gamma, delta)

    M = np.zeros((n + 1, m + 1, m + 1), dtype=np.int64)
    for i in range(n + 1):
        for j in range(m + 1):
            for k in range(max(0, j - S), min(m + 1, j + S + 1)):
                if (i, j, k) == (0, 0, 0):
                    continue
                best = None
                for ci, (di, dj, dk) in enumerate(TRIPLET_COLS):
                    pi, pj, pk = i - di, j - dj, k - dk
                    if pi < 0 or pj < 0 or pk < 0:
                        continue
                    if abs(pk - pj) > S:
                        continue
                    cst, m1, m2 = consts[ci]
                    val = (
                        M[pi, pj, pk] + cst
                        + m1 * int(mu1[i, j]) + m2 * int(mu2[i, k])
                    )
                    if best is None or val > best:
                        best = val
                M[i, j, k] = best if best is not None else NEG_INF
    return M


def fill_xla(mu1, mu2, max_shift, gamma, delta):
    """XLA wavefront fill over anti-diagonals d = i + j.

    Per diagonal the slab is V[P, W] with P = n+1 lattice rows and
    W = 2S+1 band offsets sk = k - j + S.  Cases advancing (i or j)
    read the two previous diagonals; the k-only case (0,0,1) moves
    *within* the diagonal toward larger sk, resolved by a short unrolled
    sweep (dependencies strictly increase sk).  Returns M in the oracle
    layout (host numpy).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ..utils.jaxconfig import ensure_compile_cache

    ensure_compile_cache()

    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    S = max_shift
    W = 2 * S + 1
    P = n + 1
    D = n + m + 1
    INVALID = np.int32(-(1 << 30) - (1 << 29))
    consts = _case_consts(gamma, delta)

    # diagonal tables: MU1D[d, i] = mu1[i, d-i]; MU2D[d, i, sk] =
    # mu2[i, (d-i)+sk-S]
    d_ = np.arange(D)[:, None]
    i_ = np.arange(P)[None, :]
    j_ = d_ - i_
    ok = (j_ >= 0) & (j_ <= m)
    MU1D = np.where(ok, mu1[np.minimum(i_, n), np.clip(j_, 0, m)], 0)
    k_ = j_[:, :, None] + np.arange(W)[None, None, :] - S
    ok2 = (k_ >= 0) & (k_ <= m) & ok[:, :, None]
    MU2D = np.where(
        ok2, mu2[np.minimum(i_, n)[:, :, None], np.clip(k_, 0, m)], 0
    )

    i_ar = jnp.arange(P, dtype=jnp.int32)[:, None]
    sk_ar = jnp.arange(W, dtype=jnp.int32)[None, :]

    def shift(arr, di, dsk):
        pad = [(max(di, 0), max(-di, 0)), (max(dsk, 0), max(-dsk, 0))]
        padded = jnp.pad(arr, pad, constant_values=INVALID)
        return padded[
            max(-di, 0): max(-di, 0) + P,
            max(-dsk, 0): max(-dsk, 0) + W,
        ]

    def step(carry, xs):
        vm1, vm2 = carry
        d, mu1_row, mu2_blk = xs
        j_a = d - i_ar
        k_a = j_a + sk_ar - S

        best = jnp.full((P, W), INVALID, jnp.int32)
        # external cases (advance i or j): predecessor diagonal d - di - dj
        for ci, (di, dj, dk) in enumerate(TRIPLET_COLS):
            if (di, dj, dk) == (0, 0, 1):
                continue  # internal case, swept below
            cst, m1, m2 = consts[ci]
            pred = vm1 if di + dj == 1 else vm2
            # sk' = (k-dk) - (j-dj) + S = sk + dj - dk, so the slab
            # shifts by dk - dj along the band axis
            shifted = shift(pred, di, dk - dj)
            g = (
                (i_ar >= di) & (j_a >= dj) & (k_a >= dk)
                & (sk_ar - dk + dj >= 0) & (sk_ar - dk + dj < W)
            )
            contrib = (
                shifted + cst
                + m1 * mu1_row[:, None] + m2 * mu2_blk
            )
            best = jnp.maximum(best, jnp.where(g, contrib, INVALID))

        val = jnp.where(best == INVALID, NEG_INF, best)
        is_d0 = d == 0
        origin = (i_ar == 0) & (sk_ar == S)
        val = jnp.where(is_d0 & origin, 0, val)
        protect = is_d0 & origin

        # internal case (0,0,1): k advances within the diagonal
        # (sk' = sk - 1); dependencies strictly increase sk
        cst, _m1, _m2 = consts[TRIPLET_COLS.index((0, 0, 1))]
        for t in range(1, W):
            commit = (sk_ar == t) & ~protect
            shifted = shift(val, 0, 1)
            g = (k_a >= 1) & (sk_ar >= 1)
            contrib = jnp.where(g, shifted + cst, INVALID)
            b2 = jnp.maximum(best, contrib)
            v2 = jnp.where(b2 == INVALID, NEG_INF, b2)
            best = jnp.where(commit, b2, best)
            val = jnp.where(commit, v2, val)

        return (val, vm1), val

    fn = jax.jit(
        lambda m1d, m2d: lax.scan(
            step,
            (jnp.full((P, W), INVALID, jnp.int32),) * 2,
            (jnp.arange(D, dtype=jnp.int32), m1d, m2d),
        )[1]
    )
    ys = np.asarray(fn(
        jnp.asarray(MU1D, dtype=jnp.int32),
        jnp.asarray(MU2D, dtype=jnp.int32),
    ))

    M = np.zeros((n + 1, m + 1, m + 1), dtype=np.int64)
    for i in range(n + 1):
        for j in range(m + 1):
            for sk in range(W):
                k = j + sk - S
                if 0 <= k <= m:
                    M[i, j, k] = ys[i + j, i, sk]
    return M


class BiAlignerTriplet:
    """Working triplet aligner with the reference's intended surface:
    ``optimize()``, ``traceback()``, ``decode_trace(show_structures=)``,
    ``eval_trace()`` (bialign_triplet.py:44-124)."""

    def __init__(self, seqA, seqB, strA, strB, *, engine: str = "numpy",
                 **params):
        from ..aligner import PARAM_DEFAULTS
        from .molecule import preprocess_molecule
        from ..scoring.tables import build_score_tables

        self._params = dict(PARAM_DEFAULTS)
        self._params.update(params)
        self._engine = engine
        is_rna = self._params["type"] == "RNA"
        self.molA = preprocess_molecule(seqA, strA, is_rna=is_rna)
        self.molB = preprocess_molecule(seqB, strB, is_rna=is_rna)
        self.mu1, self.mu2 = build_score_tables(
            self.molA, self.molB, self._params, is_rna=is_rna
        )
        self.gamma = int(self._params["gap_cost"])
        self.delta = int(self._params["shift_cost"])
        self.max_shift = int(self._params["max_shift"])
        self.M = None

    def optimize(self):
        fill = fill_oracle if self._engine == "numpy" else fill_xla
        self.M = fill(
            self.mu1, self.mu2, self.max_shift, self.gamma, self.delta
        )
        n = self.molA["len"]
        m = self.molB["len"]
        return int(self.M[n, m, m])

    def traceback(self):
        """First-match depth-first walk (bialign_triplet.py:62-77),
        iterative."""
        if self.M is None:
            self.optimize()
        S = self.max_shift
        consts = _case_consts(self.gamma, self.delta)
        i, j, k = self.molA["len"], self.molB["len"], self.molB["len"]
        trace = []
        while True:
            advanced = False
            for ci, (di, dj, dk) in enumerate(TRIPLET_COLS):
                pi, pj, pk = i - di, j - dj, k - dk
                if pi < 0 or pj < 0 or pk < 0 or abs(pk - pj) > S:
                    continue
                cst, m1, m2 = consts[ci]
                val = (
                    int(self.M[pi, pj, pk]) + cst
                    + m1 * int(self.mu1[i, j]) + m2 * int(self.mu2[i, k])
                )
                if val == int(self.M[i, j, k]):
                    trace.append((di, dj, dk))
                    i, j, k = pi, pj, pk
                    advanced = True
                    break
            if not advanced:
                break
        return list(reversed(trace))

    def decode_trace(self, trace=None, show_structures=False):
        """Three gapped rows (A, B-seq-copy, B-str-copy); with
        ``show_structures`` each row is preceded by its gapped structure
        (bialign_triplet.py:81-105)."""
        from ..render.decode import transfer_gaps

        if trace is None:
            trace = self.traceback()
        mols = (self.molA, self.molB, self.molB)
        pos = [0] * 3
        alignment = [""] * 3
        for y in trace:
            for s in range(3):
                if y[s] == 0:
                    alignment[s] += "-"
                else:
                    alignment[s] += mols[s]["seq"][pos[s]]
                    pos[s] += 1
        if not show_structures:
            return alignment
        anno = []
        for alistr, mol in zip(alignment, mols):
            anno.append(transfer_gaps(alistr, mol["structure"]))
            anno.append(alistr)
        return anno

    def eval_trace(self, trace=None):
        if trace is None:
            trace = self.traceback()
        consts = _case_consts(self.gamma, self.delta)
        pos = [0] * 3
        for y in trace:
            for s in range(3):
                pos[s] += y[s]
            ci = TRIPLET_COLS.index(tuple(y))
            cst, m1, m2 = consts[ci]
            case_score = (
                cst + m1 * int(self.mu1[pos[0], pos[1]])
                + m2 * int(self.mu2[pos[0], pos[2]])
            )
            total = int(self.M[tuple(pos)])
            yield " ".join(
                str(x) for x in [pos, tuple(y), case_score, "-->", total]
            )
