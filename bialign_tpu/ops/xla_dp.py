"""XLA anti-diagonal wavefront engine for the banded 4D bi-alignment DP.

A re-design of the reference fill loops (bialignment.pyx:443-509) as
array code for an accelerator: instead of per-cell Python generators, the recurrence runs as a
``lax.scan`` over anti-diagonals ``d = i + j``.  Per diagonal the engine
holds a slab ``V[(Q,) P, W, W]`` (P = n+1 lattice rows indexed by i,
W = 2*max_shift+1 shift offsets, Q = 9 affine states), computes every
case of every cell of the diagonal as masked vector arithmetic, and
resolves the within-diagonal shift-only cases with a short unrolled
sweep over shift anti-diagonals ``t = sk + sl`` (dependencies strictly
decrease t, so 4*max_shift masked steps finalize the slab).

Bit-exactness contract (validated cell-for-cell against the numpy oracle
in tests/test_engines.py):

* integer arithmetic only — int32 on device after a host-side range check
  (:func:`bialign_tpu.ops.cases.check_int32_safe`);
* a case's contribution is EXACTLY the oracle's ``pred + const + mu``
  when the reference guard holds, and the sentinel ``INVALID`` otherwise;
  cells where every case is guarded out become exactly ``NEG_INF``
  (the reference's empty-max, pyx:299-303);
* garbage lattice positions (k > n, j > m, ...) are computed but provably
  never read by any genuine cell, the final score, or the traceback.

The full band is returned in the oracle's layout ``H[(Q,) i, j, sk, sl]``
so the host traceback (:mod:`bialign_tpu.ops.traceback`) is engine-
agnostic.  ``score_only=True`` skips band materialisation (bench path).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.jaxconfig import ensure_compile_cache

ensure_compile_cache()

from .device_tables import diag_tables
from .cases import (
    NEG_INF,
    N_STATES,
    STATES,
    STATE_BOTH_MATCH,
    AffineTables,
    NonAffineTables,
    NONAFFINE_COLS,
)

# Masked-case sentinel: strictly below any reachable contribution
# (values stay above NEG_INF - path_drift >= -1.2e9, see check_int32_safe),
# and never produced by arithmetic — only by explicit `where`.
INVALID = np.int32(-(1 << 30) - (1 << 29))
# int64-engine sentinel (overflow-unsafe inputs): far below NEG_INF minus
# any realistic path drift, far above int64 overflow under +const+mu.
INVALID64 = np.int64(-(1 << 62))


def _sentinel(dtype):
    return INVALID64 if np.dtype(dtype) == np.int64 else INVALID


def _diag_mu_tables(mu1: np.ndarray, mu2: np.ndarray, max_shift: int,
                    dtype=np.int32):
    """Precompute diagonal-layout score tables.

    MU1D[d, i]        = mu1[i, d-i]                      (0 out of range)
    MU2D[d, i, sk, sl] = mu2[i+sk-S, (d-i)+sl-S]          (0 out of range)

    Out-of-range entries are only ever read by masked-out cases, so their
    value is irrelevant; 0 keeps arithmetic overflow-free.
    """
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    S = max_shift
    W = 2 * S + 1
    D = n + m + 1
    P = n + 1

    d_ = np.arange(D)[:, None]
    i_ = np.arange(P)[None, :]
    j_ = d_ - i_
    jok = (j_ >= 0) & (j_ <= m)
    MU1D = np.where(jok, mu1[np.minimum(i_, n), np.clip(j_, 0, m)], 0).astype(
        dtype
    )

    k_ = (i_[..., None, None] + np.arange(W)[None, None, :, None] - S)
    l_ = (j_[..., None, None] + np.arange(W)[None, None, None, :] - S)
    ok = (k_ >= 0) & (k_ <= n) & (l_ >= 0) & (l_ <= m)
    MU2D = np.where(
        ok, mu2[np.clip(k_, 0, n), np.clip(l_, 0, m)], 0
    ).astype(dtype)
    return jnp.asarray(MU1D), jnp.asarray(MU2D)


def _shift3(arr, di: int, dk: int, dl: int, fill=INVALID):
    """result[..., i, sk, sl] = arr[..., i-di, sk-dk, sl-dl], ``fill`` fill.

    Static shifts via pad+slice (XLA fuses these); the fill value is never
    selected because every use site also guards the shifted range.
    """
    P, W = arr.shape[-3], arr.shape[-1]
    pad = [(0, 0)] * (arr.ndim - 3) + [
        (max(di, 0), max(-di, 0)),
        (max(dk, 0), max(-dk, 0)),
        (max(dl, 0), max(-dl, 0)),
    ]
    padded = jnp.pad(arr, pad, constant_values=fill)
    sl = tuple(
        [slice(None)] * (arr.ndim - 3)
        + [
            slice(max(-di, 0), max(-di, 0) + P),
            slice(max(-dk, 0), max(-dk, 0) + W),
            slice(max(-dl, 0), max(-dl, 0) + W),
        ]
    )
    return padded[sl]


def _range_guard(idx, lo: int, hi_excl: int):
    return (idx >= lo) & (idx < hi_excl)


def _build_affine_step(P, max_shift, params, score_only, i_base=0,
                       dtype=np.int32):
    """Build the per-diagonal step function (shared by the single-pair scan
    and the batched traced-length score scan).

    params = (beta, gamma, delta); all shape arguments static so the case
    constants fold into the compiled program.  ``i_base`` offsets the
    lattice-row indices (may be a traced scalar) — the sequence-split
    multi-chip path gives each shard its global row range this way.
    ``dtype=np.int64`` builds the overflow-safe variant (requires x64
    enabled at trace time; see :func:`fill_affine`).
    """
    beta, gamma, delta = params
    S = max_shift
    W = 2 * S + 1
    Q = N_STATES
    inval = _sentinel(dtype)

    tabs = AffineTables(beta, gamma, delta, dtype=dtype)
    a_const = jnp.asarray(tabs.a_const)        # [Q, Q]
    b_const = jnp.asarray(tabs.b_const)        # [Q, 3]
    c_const = jnp.asarray(tabs.c_const)        # [Q, 3]

    i_ar = (jnp.asarray(i_base, jnp.int32)
            + jnp.arange(P, dtype=jnp.int32))[:, None, None]      # [P,1,1]
    sk_ar = jnp.arange(W, dtype=jnp.int32)[None, :, None]         # [1,W,1]
    sl_ar = jnp.arange(W, dtype=jnp.int32)[None, None, :]         # [1,1,W]

    init_col = jnp.full((Q, 1, 1, 1), NEG_INF, dtype).at[
        STATE_BOTH_MATCH
    ].set(0)
    origin_pos = (i_ar == 0) & (sk_ar == S) & (sl_ar == S)        # [P,W,W]

    invalid_slab = jnp.full((Q, P, W, W), inval, dtype)

    def step(carry, xs):
        vm1, vm2 = carry
        d, mu1_row, mu2_blk = xs                 # [P], [P,W,W]
        j_ar = d - i_ar                          # [P,1,1]
        k_ar = i_ar + sk_ar - S                  # k index
        l_ar = j_ar + sl_ar - S

        best = jnp.full((Q, P, W, W), inval, dtype)

        for q in range(Q):
            a, b, c, dd = STATES[q]
            pred = vm1 if a + b == 1 else vm2

            # -- group A: full column == state q, all 9 sources (pyx:275-279)
            shifted = _shift3(pred, a, c - a, dd - b, inval)      # [Q,P,W,W]
            contrib = shifted + a_const[q][:, None, None, None]
            agg = jnp.max(contrib, axis=0)
            mu_term = (
                tabs.mu1_coef[q] * mu1_row[:, None, None]
                + tabs.mu2_coef[q] * mu2_blk
            )
            gA = (
                (i_ar >= a) & (j_ar >= b) & (k_ar >= c) & (l_ar >= dd)
                & _range_guard(sk_ar - c + a, 0, W)
                & _range_guard(sl_ar - dd + b, 0, W)
            )
            cA = jnp.where(gA, agg + mu_term, inval)

            # -- group C: seq-only half column (a,b,0,0) (pyx:291-296);
            # predecessor shift indices grow: sk' = sk + a, sl' = sl + b
            srcs = jnp.stack(
                [_shift3(pred[int(s)], a, -a, -b, inval)
                 for s in tabs.c_src[q]]
            )
            aggC = jnp.max(
                srcs + c_const[q][:, None, None, None], axis=0
            )
            muC = tabs.c_mu1_coef[q] * mu1_row[:, None, None]
            gC = (
                (i_ar >= a) & (j_ar >= b)
                & _range_guard(sk_ar + a, 0, W)
                & _range_guard(sl_ar + b, 0, W)
            )
            cC = jnp.where(gC, aggC + muC, inval)

            best = best.at[q].set(jnp.maximum(cA, cC))

        val = jnp.where(best == inval, NEG_INF, best)

        # origin initialization (pyx:483-485), diag 0 only
        is_d0 = d == 0
        val = jnp.where(is_d0 & origin_pos, init_col, val)
        protect = is_d0 & origin_pos                              # [P,W,W]

        # -- group B sweep: str-only half columns advance only (k,l), i.e.
        # within this diagonal; dependencies strictly decrease t = sk+sl.
        for t in range(1, 4 * S + 1):
            newb = best
            newv = val
            commit_base = (sk_ar + sl_ar == t) & ~protect
            for q in range(Q):
                _a, _b, c, dd = STATES[q]
                srcs = jnp.stack(
                    [_shift3(val[int(s)], 0, c, dd, inval)
                     for s in tabs.b_src[q]]
                )
                aggB = jnp.max(
                    srcs + b_const[q][:, None, None, None], axis=0
                )
                muB = tabs.b_mu2_coef[q] * mu2_blk
                gB = (
                    (k_ar >= c) & (l_ar >= dd)
                    & (sk_ar >= c) & (sl_ar >= dd)
                )
                cB = jnp.where(gB, aggB + muB, inval)
                bq = jnp.maximum(best[q], cB)
                vq = jnp.where(bq == inval, NEG_INF, bq)
                newb = newb.at[q].set(
                    jnp.where(commit_base, bq, best[q])
                )
                newv = newv.at[q].set(
                    jnp.where(commit_base, vq, val[q])
                )
            best, val = newb, newv

        ys = None if score_only else val
        return (val, vm1), ys

    return step, invalid_slab


def affine_scan(mu1d, mu2d, n, m, max_shift, params, score_only=False,
                dtype=np.int32):
    """Scan over all diagonals; returns (final_slab, ys or None)."""
    step, invalid_slab = _build_affine_step(n + 1, max_shift, params,
                                            score_only, dtype=dtype)
    D = n + m + 1
    xs = (jnp.arange(D, dtype=jnp.int32), mu1d, mu2d)
    (last, _), ys = lax.scan(step, (invalid_slab, invalid_slab), xs)
    return last, ys


def affine_score_traced(mu1d, mu2d, n, m, max_shift, params):
    """Optimal affine score with ``n``/``m`` as *traced* scalars.

    Shapes are fixed by the padded diagonal tables (one compilation serves a
    whole padded length bucket); the true final cell (n, m, n, m) is captured
    on the fly when the scan passes diagonal n+m.  vmap over the leading
    axis of all four arguments gives the batched scorer.
    """
    D, P = mu1d.shape
    S = max_shift
    step, invalid_slab = _build_affine_step(P, S, params, True)
    i_row = jnp.arange(P, dtype=jnp.int32)

    def wrapped(carry, xs):
        vm1, vm2, score = carry
        d = xs[0]
        (val, nvm2), _ = step((vm1, vm2), xs)
        mid = val[:, :, S, S]                                     # [Q, P]
        cand = jnp.max(jnp.where(i_row[None, :] == n, mid, INVALID))
        score = jnp.where(d == n + m, cand, score)
        return (val, nvm2, score), None

    xs = (jnp.arange(D, dtype=jnp.int32), mu1d, mu2d)
    (_, _, score), _ = lax.scan(
        wrapped, (invalid_slab, invalid_slab, jnp.int32(INVALID)), xs
    )
    return score


_affine_scan = jax.jit(affine_scan, static_argnums=(2, 3, 4, 5, 6, 7))


def fill_affine(mu1, mu2, max_shift, beta, gamma, delta, *,
                score_only=False, int64=False):
    """Affine band fill; returns H[q,i,j,sk,sl] (int64 numpy, oracle layout)
    or, with score_only, the optimal score.

    ``int64=True`` runs the overflow-safe variant of the scan (for inputs
    failing :func:`bialign_tpu.ops.cases.check_int32_safe`): same
    recurrence and sentinels semantics at int64 width, traced under JAX
    x64 so nothing downcasts.
    """
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    S = max_shift
    dtype = np.int64 if int64 else np.int32
    with jax.enable_x64(int64):
        mu1d, mu2d = _diag_mu_tables(
            np.asarray(mu1), np.asarray(mu2), S, dtype=dtype
        )
        last, ys = _affine_scan(
            mu1d, mu2d, n, m, S, (beta, gamma, delta), score_only, dtype,
        )
        if score_only:
            return int(np.max(np.asarray(last[:, n, S, S])))
        return _diag_to_band(np.asarray(ys), n, m, S, affine=True)


def _build_nonaffine_step(P, max_shift, params, score_only, i_base=0,
                          dtype=np.int32):
    """Per-diagonal step for the 13-case non-affine recurrence.

    ``i_base`` offsets the lattice-row indices (may be traced), see
    :func:`_build_affine_step`.
    """
    gamma, delta = params
    S = max_shift
    W = 2 * S + 1
    inval = _sentinel(dtype)

    tab = NonAffineTables(gamma, delta, dtype=dtype)
    external = [
        (col, int(tab.const[ci]), int(tab.mu1_coef[ci]), int(tab.mu2_coef[ci]))
        for ci, col in enumerate(NONAFFINE_COLS)
        if col[0] or col[1]
    ]
    internal = [
        (col, int(tab.const[ci]), int(tab.mu2_coef[ci]))
        for ci, col in enumerate(NONAFFINE_COLS)
        if not (col[0] or col[1])
    ]

    i_ar = (jnp.asarray(i_base, jnp.int32)
            + jnp.arange(P, dtype=jnp.int32))[:, None, None]
    sk_ar = jnp.arange(W, dtype=jnp.int32)[None, :, None]
    sl_ar = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    origin_pos = (i_ar == 0) & (sk_ar == S) & (sl_ar == S)

    invalid_slab = jnp.full((P, W, W), inval, dtype)

    def step(carry, xs):
        vm1, vm2 = carry
        d, mu1_row, mu2_blk = xs
        j_ar = d - i_ar
        k_ar = i_ar + sk_ar - S
        l_ar = j_ar + sl_ar - S

        best = jnp.full((P, W, W), inval, dtype)
        for (x0, x1, x2, x3), const, m1c, m2c in external:
            pred = vm1 if x0 + x1 == 1 else vm2
            shifted = _shift3(pred, x0, x2 - x0, x3 - x1, inval)
            g = (
                (i_ar >= x0) & (j_ar >= x1) & (k_ar >= x2) & (l_ar >= x3)
                & _range_guard(sk_ar - x2 + x0, 0, W)
                & _range_guard(sl_ar - x3 + x1, 0, W)
            )
            contrib = (
                shifted + const
                + m1c * mu1_row[:, None, None] + m2c * mu2_blk
            )
            best = jnp.maximum(best, jnp.where(g, contrib, inval))

        val = jnp.where(best == inval, NEG_INF, best)
        is_d0 = d == 0
        val = jnp.where(is_d0 & origin_pos, 0, val)
        protect = is_d0 & origin_pos

        for t in range(1, 4 * S + 1):
            commit = (sk_ar + sl_ar == t) & ~protect
            b2 = best
            for (x0, x1, x2, x3), const, m2c in internal:
                shifted = _shift3(val, 0, x2, x3, inval)
                g = (
                    (k_ar >= x2) & (l_ar >= x3)
                    & (sk_ar >= x2) & (sl_ar >= x3)
                )
                contrib = shifted + const + m2c * mu2_blk
                b2 = jnp.maximum(b2, jnp.where(g, contrib, inval))
            v2 = jnp.where(b2 == inval, NEG_INF, b2)
            best = jnp.where(commit, b2, best)
            val = jnp.where(commit, v2, val)

        ys = None if score_only else val
        return (val, vm1), ys

    return step, invalid_slab


def nonaffine_scan(mu1d, mu2d, n, m, max_shift, params, score_only=False,
                   dtype=np.int32):
    """Non-affine scan over all diagonals (unjitted core)."""
    step, invalid_slab = _build_nonaffine_step(n + 1, max_shift, params,
                                               score_only, dtype=dtype)
    D = n + m + 1
    xs = (jnp.arange(D, dtype=jnp.int32), mu1d, mu2d)
    (last, _), ys = lax.scan(step, (invalid_slab, invalid_slab), xs)
    return last, ys


def nonaffine_score_traced(mu1d, mu2d, n, m, max_shift, params):
    """Non-affine score with traced n/m (batched bucket path)."""
    D, P = mu1d.shape
    S = max_shift
    step, invalid_slab = _build_nonaffine_step(P, S, params, True)
    i_row = jnp.arange(P, dtype=jnp.int32)

    def wrapped(carry, xs):
        vm1, vm2, score = carry
        d = xs[0]
        (val, nvm2), _ = step((vm1, vm2), xs)
        mid = val[:, S, S]                                        # [P]
        cand = jnp.max(jnp.where(i_row == n, mid, INVALID))
        score = jnp.where(d == n + m, cand, score)
        return (val, nvm2, score), None

    xs = (jnp.arange(D, dtype=jnp.int32), mu1d, mu2d)
    (_, _, score), _ = lax.scan(
        wrapped, (invalid_slab, invalid_slab, jnp.int32(INVALID)), xs
    )
    return score


_nonaffine_scan = jax.jit(nonaffine_scan, static_argnums=(2, 3, 4, 5, 6, 7))


def fill_nonaffine(mu1, mu2, max_shift, gamma, delta, *,
                   score_only=False, int64=False):
    """Non-affine band fill; H[i,j,sk,sl] int64 numpy, or the score.

    ``int64=True``: overflow-safe variant, see :func:`fill_affine`.
    """
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    S = max_shift
    dtype = np.int64 if int64 else np.int32
    with jax.enable_x64(int64):
        mu1d, mu2d = _diag_mu_tables(
            np.asarray(mu1), np.asarray(mu2), S, dtype=dtype
        )
        last, ys = _nonaffine_scan(
            mu1d, mu2d, n, m, S, (gamma, delta), score_only, dtype
        )
        if score_only:
            return int(np.asarray(last[n, S, S]))
        return _diag_to_band(np.asarray(ys), n, m, S, affine=False)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _band_device(mu1, mu2, max_shift, params, affine):
    """Diagonal tables built on the device, then the band-emitting scan;
    ys[D, (Q,) P, W, W] for the dense (n+1, m+1) tables."""
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    mu1d, mu2d = diag_tables(mu1, mu2, max_shift, n + m + 1)
    scan = affine_scan if affine else nonaffine_scan
    return scan(mu1d, mu2d, n, m, max_shift, params)[1]


def fill_affine_device(mu1, mu2, max_shift, beta, gamma, delta):
    """Affine band fill kept on device; returns a DeviceBand.

    The band stays in device memory for the on-device traceback
    (:mod:`bialign_tpu.ops.device_traceback`); nothing large is ever
    transferred to the host.
    """
    return _fill_device(mu1, mu2, max_shift, (beta, gamma, delta), True)


def fill_nonaffine_device(mu1, mu2, max_shift, gamma, delta):
    """Non-affine band fill kept on device; returns a DeviceBand."""
    return _fill_device(mu1, mu2, max_shift, (gamma, delta), False)


def _fill_device(mu1, mu2, max_shift, params, affine):
    from .band import DeviceBand

    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    ys = _band_device(
        jnp.asarray(mu1, dtype=jnp.int32), jnp.asarray(mu2, dtype=jnp.int32),
        int(max_shift), tuple(int(p) for p in params), affine,
    )
    return DeviceBand(ys=ys, n=n, m=m, max_shift=max_shift, affine=affine)


def _diag_to_band(ys: np.ndarray, n: int, m: int, max_shift: int, *,
                  affine: bool) -> np.ndarray:
    """Remap diagonal-major output [D, (Q,) P, W, W] to the oracle layout
    H[(Q,) i, j, sk, sl] (int64, matching reference SparseMatrix4D backing)."""
    W = 2 * max_shift + 1
    if affine:
        H = np.empty((N_STATES, n + 1, m + 1, W, W), dtype=np.int64)
        for i in range(n + 1):
            # ys[i+j, :, i] for j = 0..m  ->  [m+1, Q, W, W]
            H[:, i] = ys[i:i + m + 1, :, i].swapaxes(0, 1)
    else:
        H = np.empty((n + 1, m + 1, W, W), dtype=np.int64)
        for i in range(n + 1):
            H[i] = ys[i:i + m + 1, i]
    return H
