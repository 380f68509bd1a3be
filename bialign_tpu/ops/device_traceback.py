"""On-device traceback over a diagonal-major DP band.

Semantics-identical to the host walk (:mod:`bialign_tpu.ops.traceback`,
itself bit-exact vs reference bialignment.pyx:513-586), but runs as a
``lax.while_loop`` on the device holding the band, so the only host
transfer is the trace itself (O(n+m) int8 values).  Parity-critical
details preserved:

* affine start state = best-scoring state, ties by minimal intrinsic
  shift, then state enumeration order (pyx:573-582) — ``argmin`` on a
  masked key vector (first minimum wins, like the reference's argmin);
* per cell, ALL co-optimal cases are scored and the one minimizing
  ``[total |shift|, |net B shift|]`` wins, case enumeration order breaking
  residual ties (pyx:554-569) — encoded as one integer key per case,
  ``argmin`` first-wins;
* the reference's initial-call quirk (the ``state == [1,1,1,1]``
  termination test can never fire before the first traced column,
  pyx:551) via the ``first`` flag;
* non-affine: first case whose re-evaluated score equals the cell value
  (pyx:513-531), ``argmax`` over the candidate mask.

Case enumeration tables come from :mod:`bialign_tpu.ops.cases`; the
parameter-dependent constants are bound on host and shipped as tiny int32
arrays, so one compilation serves all parameter settings of a geometry.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .band import DeviceBand
from .cases import (
    N_STATES,
    STATES,
    STATE_BOTH_MATCH,
    NonAffineTables,
    NONAFFINE_COLS,
    iter_affine_cases,
)

_BIG_KEY = jnp.int32(1 << 20)
_KEY_SCALE = 256  # > any |net B shift| during a walk (bounded by S+1)

N_AFFINE_CASES = 15


@functools.lru_cache(maxsize=None)
def _affine_static_tables():
    """(src[9,15], col[9,15,4], mults[9,15,5]) in reference case order."""
    src = np.zeros((N_STATES, N_AFFINE_CASES), dtype=np.int32)
    col = np.zeros((N_STATES, N_AFFINE_CASES, 4), dtype=np.int32)
    mults = np.zeros((N_STATES, N_AFFINE_CASES, 5), dtype=np.int32)
    for q in range(N_STATES):
        for ci, (s, c, mu1c, mu2c, ng, nb, nd, _g) in enumerate(
            iter_affine_cases(q)
        ):
            src[q, ci] = s
            col[q, ci] = c
            mults[q, ci] = (mu1c, mu2c, ng, nb, nd)
    return src, col, mults


def _affine_const(beta: int, gamma: int, delta: int) -> np.ndarray:
    _src, _col, mults = _affine_static_tables()
    return (
        mults[..., 2] * gamma + mults[..., 3] * beta + mults[..., 4] * delta
    ).astype(np.int32)


def _encode_col(col):
    return col[..., 0] * 8 + col[..., 1] * 4 + col[..., 2] * 2 + col[..., 3]


@functools.partial(jax.jit, static_argnums=(4,))
def _affine_walk(ys, mu1, mu2, case_const, max_shift, n, m):
    """Device walk; returns (trace_codes[Lmax], n_steps, done_code, score).

    The start state (best final score, ties by minimal intrinsic shift,
    then enumeration order — pyx:573-582) is selected on device so the
    whole traceback is ONE dispatch and one small transfer.

    ``n``/``m`` are runtime scalars; the trace capacity comes from the
    (bucket-padded) mu table shapes, so one compilation serves every
    pair geometry in a bucket (the mu tables are padded by the wrapper).

    done_code: 1 = complete (reached origin in both-match state),
    2 = stuck (the reference's incomplete-traceback warning case).
    """
    S = max_shift
    Lmax = 2 * (mu1.shape[0] - 1 + mu1.shape[1] - 1) + 1

    src_t, col_t, mults_t = _affine_static_tables()
    SRC = jnp.asarray(src_t)                     # [9,15]
    COL = jnp.asarray(col_t)                     # [9,15,4]
    MU1C = jnp.asarray(mults_t[..., 0])
    MU2C = jnp.asarray(mults_t[..., 1])
    STATES_A = jnp.asarray(
        [s[0] - s[2] for s in STATES], dtype=jnp.int32
    )
    STATES_B = jnp.asarray(
        [s[1] - s[3] for s in STATES], dtype=jnp.int32
    )
    CODES = jnp.asarray(_encode_col(col_t))      # [9,15]

    def cell(q, i, j, k, l):
        return ys[i + j, q, i, k - i + S, l - j + S]

    def cond(st):
        return (st["done"] == 0) & (st["step"] < Lmax)

    def body(st):
        i, j, k, l = st["i"], st["j"], st["k"], st["l"]
        q = st["q"]
        at_origin = (
            (i == 0) & (j == 0) & (k == 0) & (l == 0)
            & (q == STATE_BOTH_MATCH) & (~st["first"])
        )

        here = cell(q, i, j, k, l)

        col = COL[q]                              # [15,4]
        pi = i - col[:, 0]
        pj = j - col[:, 1]
        pk = k - col[:, 2]
        pl = l - col[:, 3]
        guard = (
            (pi >= 0) & (pj >= 0) & (pk >= 0) & (pl >= 0)
            & (jnp.abs(pk - pi) <= S) & (jnp.abs(pl - pj) <= S)
        )
        ci_ = jnp.clip(pi, 0, n)
        cd_ = jnp.clip(pi + pj, 0, n + m)
        csk = jnp.clip(pk - pi + S, 0, 2 * S)
        csl = jnp.clip(pl - pj + S, 0, 2 * S)
        pred_cells = ys[cd_, SRC[q], ci_, csk, csl]
        vals = (
            pred_cells
            + case_const[q]
            + MU1C[q] * mu1[i, j]
            + MU2C[q] * mu2[k, l]
        )
        is_cand = guard & (vals == here)

        tA = st["netA"] + (col[:, 0] - col[:, 2]) + STATES_A[SRC[q]]
        tB = st["netB"] + (col[:, 1] - col[:, 3]) + STATES_B[SRC[q]]
        key = (jnp.abs(tA) + jnp.abs(tB)) * _KEY_SCALE + jnp.abs(tB)
        key = jnp.where(is_cand, key, _BIG_KEY)
        sel = jnp.argmin(key)                     # first minimum wins
        stuck = ~is_cand.any()

        c = col[sel]
        nxt = dict(
            i=i - c[0], j=j - c[1], k=k - c[2], l=l - c[3],
            q=SRC[q, sel],
            netA=st["netA"] + c[0] - c[2],
            netB=st["netB"] + c[1] - c[3],
            first=jnp.bool_(False),
            step=st["step"] + 1,
            trace=st["trace"].at[st["step"]].set(CODES[q, sel]),
            done=jnp.int32(0),
        )
        halt = dict(st)
        halt["done"] = jnp.where(at_origin, 1, 2).astype(jnp.int32)

        take_halt = at_origin | stuck
        return {
            key_: jnp.where(take_halt, halt[key_], nxt[key_])
            for key_ in nxt
        }

    # start-state selection (pyx:573-582), on device
    final = ys[n + m, :, n, S, S]
    score = jnp.max(final)
    intrinsic = jnp.asarray(
        [abs(s[0] - s[2]) + abs(s[1] - s[3]) for s in STATES],
        dtype=jnp.int32,
    )
    start_q = jnp.argmin(jnp.where(final == score, intrinsic, _BIG_KEY))

    init = dict(
        i=jnp.int32(n), j=jnp.int32(m), k=jnp.int32(n), l=jnp.int32(m),
        q=start_q.astype(jnp.int32),
        netA=jnp.int32(0), netB=jnp.int32(0),
        first=jnp.bool_(True),
        step=jnp.int32(0),
        trace=jnp.zeros(Lmax, dtype=jnp.int32),
        done=jnp.int32(0),
    )
    out = lax.while_loop(cond, body, init)
    return out["trace"], out["step"], out["done"], score


_MU_QUANTUM = 64


def _pad_mu(mu) -> np.ndarray:
    """Zero-pad a dense (n+1, m+1) table to 64-quantized bounds so the
    walk's compile key is per length bucket, not per exact pair."""
    mu = np.asarray(mu)
    P = -(-mu.shape[0] // _MU_QUANTUM) * _MU_QUANTUM
    M = -(-mu.shape[1] // _MU_QUANTUM) * _MU_QUANTUM
    out = np.zeros((P, M), dtype=mu.dtype)
    out[: mu.shape[0], : mu.shape[1]] = mu
    return out


def affine_traceback(band: DeviceBand, beta: int, gamma: int, delta: int,
                     mu1, mu2):
    """Device-side affine traceback; returns (trace, complete) like the
    host walk (:func:`bialign_tpu.ops.traceback.affine_traceback`)."""
    const = jnp.asarray(_affine_const(beta, gamma, delta))
    codes, steps, done, _score = jax.device_get(_affine_walk(
        band.ys, jnp.asarray(_pad_mu(mu1)), jnp.asarray(_pad_mu(mu2)),
        const, band.max_shift, jnp.int32(band.n), jnp.int32(band.m),
    ))
    codes = codes[:int(steps)]
    trace = [
        ((c >> 3) & 1, (c >> 2) & 1, (c >> 1) & 1, c & 1)
        for c in reversed(codes.tolist())
    ]
    return trace, int(done) == 1


@functools.partial(jax.jit, static_argnums=(4,))
def _affine_walk_batch(ys, mu1, mu2, case_const, max_shift, ns, ms):
    """vmap of :func:`_affine_walk` over a same-bucket batch.

    ys: [B, D, Q, P, W, W]; mu1/mu2:
    [B, Np, Mp] dense int32; ns/ms: [B].  The batched while_loop runs
    until every pair's walk halts (inactive pairs idle, trace capacity
    is the bucket's Lmax).  Returns (codes [B, Lmax], steps [B],
    done [B], scores [B]).
    """

    def one(y, m1, m2, n, m):
        return _affine_walk(y, m1, m2, case_const, max_shift, n, m)

    return jax.vmap(one)(ys, mu1, mu2, ns, ms)


def decode_walk_codes(codes_row, steps: int):
    """Reversed-walk int codes -> forward trace list of (a,b,c,d)."""
    return [
        ((c >> 3) & 1, (c >> 2) & 1, (c >> 1) & 1, c & 1)
        for c in reversed(codes_row[:steps].tolist())
    ]


@functools.partial(jax.jit, static_argnums=(4,))
def _nonaffine_walk_batch(ys, mu1, mu2, case_const, max_shift, ns, ms):
    """Non-affine twin of :func:`_affine_walk_batch`; returns
    (codes [B, Lmax], steps [B])."""

    def one(y, m1, m2, n, m):
        return _nonaffine_walk(y, m1, m2, case_const, max_shift, n, m)

    return jax.vmap(one)(ys, mu1, mu2, ns, ms)


@functools.partial(jax.jit, static_argnums=(4,))
def _nonaffine_walk(ys, mu1, mu2, case_const, max_shift, n, m):
    S = max_shift
    # n/m are runtime scalars; trace capacity from the padded mu shapes
    Lmax = 2 * (mu1.shape[0] - 1 + mu1.shape[1] - 1) + 1

    COL = jnp.asarray(np.asarray(NONAFFINE_COLS, dtype=np.int32))  # [13,4]
    tabs = NonAffineTables(0, 0)  # multiplicities only; consts passed in
    MU1C = jnp.asarray(tabs.mu1_coef)
    MU2C = jnp.asarray(tabs.mu2_coef)
    CODES = jnp.asarray(_encode_col(np.asarray(NONAFFINE_COLS)))

    def cond(st):
        return (st["done"] == 0) & (st["step"] < Lmax)

    def cell(i_, j_, sk_, sl_):
        return ys[i_ + j_, i_, sk_, sl_]

    def body(st):
        i, j, k, l = st["i"], st["j"], st["k"], st["l"]
        here = cell(i, j, k - i + S, l - j + S)

        pi = i - COL[:, 0]
        pj = j - COL[:, 1]
        pk = k - COL[:, 2]
        pl = l - COL[:, 3]
        guard = (
            (pi >= 0) & (pj >= 0) & (pk >= 0) & (pl >= 0)
            & (jnp.abs(pk - pi) <= S) & (jnp.abs(pl - pj) <= S)
        )
        vals = (
            cell(jnp.clip(pi, 0, n), jnp.clip(pj, 0, m),
                 jnp.clip(pk - pi + S, 0, 2 * S),
                 jnp.clip(pl - pj + S, 0, 2 * S))
            + case_const
            + MU1C * mu1[i, j]
            + MU2C * mu2[k, l]
        )
        is_cand = guard & (vals == here)
        sel = jnp.argmax(is_cand)                 # first match wins
        stuck = ~is_cand.any()

        c = COL[sel]
        nxt = dict(
            i=i - c[0], j=j - c[1], k=k - c[2], l=l - c[3],
            step=st["step"] + 1,
            trace=st["trace"].at[st["step"]].set(CODES[sel]),
            done=jnp.int32(0),
        )
        halt = dict(st)
        halt["done"] = jnp.int32(1)
        return {
            key_: jnp.where(stuck, halt[key_], nxt[key_]) for key_ in nxt
        }

    init = dict(
        i=jnp.int32(n), j=jnp.int32(m), k=jnp.int32(n), l=jnp.int32(m),
        step=jnp.int32(0),
        trace=jnp.zeros(Lmax, dtype=jnp.int32),
        done=jnp.int32(0),
    )
    out = lax.while_loop(cond, body, init)
    return out["trace"], out["step"]


def nonaffine_traceback(band: DeviceBand, gamma: int, delta: int, mu1, mu2):
    """Device-side non-affine traceback (forward trace list)."""
    tabs = NonAffineTables(gamma, delta)
    codes, steps = jax.device_get(_nonaffine_walk(
        band.ys, jnp.asarray(_pad_mu(mu1)), jnp.asarray(_pad_mu(mu2)),
        jnp.asarray(tabs.const), band.max_shift,
        jnp.int32(band.n), jnp.int32(band.m),
    ))
    codes = codes[:int(steps)]
    return [
        ((c >> 3) & 1, (c >> 2) & 1, (c >> 1) & 1, c & 1)
        for c in reversed(codes.tolist())
    ]
