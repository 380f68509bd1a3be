"""Checkpointed (linear-memory) band fill + rematerializing traceback.

The normal device path materializes the whole band ``ys[D, (Q,) P, W, W]``
in HBM so the traceback can walk it (:mod:`bialign_tpu.ops.band`).  For the
DNA-Pol-1 pair at max_shift 1 that is ~0.5 GB; band size grows as
O((n+m) * n * W^2 * Q), which caps single-pair sequence length well below
what the score-only scan (O(n * W^2 * Q) carry) could handle.

This module is the DP analog of gradient rematerialisation
(``jax.checkpoint``): the forward fill stores only the scan *carry* every
``C`` diagonals (a "checkpoint" = the two live diagonal slabs), and the
traceback walks the band block by block, recomputing each visited block of
``C`` diagonals on device from its checkpoint.  With C ~ sqrt(2*D) the
peak memory of the *band* is O(sqrt(D)) slabs instead of O(D) — ~14x less
for DNA-Pol-1 on the affine path.  (Non-affine savings are only ~2x: the
blocked mu2b tables stay device-resident at [D, P, W, W], which equals the
full non-affine band size.)  The walk is **bit-exact** with the full-band
traceback (same fill values, same co-optimal tie-breaking, reference
semantics bialignment.pyx:513-586).  This is deliberately NOT Hirschberg
divide-and-conquer: Hirschberg halves memory asymptotically the same way
but cannot reproduce the reference's global smart-shift argmin tie-break
(pyx:564), so its alignments would only be co-optimal, not identical.

Compute overhead: exactly one extra fill pass in the worst case (every
block recomputed once), on engines that fill at >10^8 cells/s.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .cases import STATES, STATE_BOTH_MATCH, NonAffineTables, NONAFFINE_COLS
from .device_traceback import (
    _affine_static_tables,
    _affine_const,
    _encode_col,
    _BIG_KEY,
    _KEY_SCALE,
)
from .xla_dp import (
    _build_affine_step,
    _build_nonaffine_step,
    _diag_mu_tables,
)


def default_block(D: int) -> int:
    """Block size minimizing checkpoints (2/C per diagonal) + one live
    block (C slabs): C = sqrt(2 D), floored at 8."""
    return max(8, int(math.ceil(math.sqrt(2.0 * D))))


@dataclass(frozen=True)
class CheckpointBand:
    """A checkpointed DP band: O(sqrt(D)) memory handle, device-resident.

    ``ckpts[b]`` is the scan carry (slabs of diagonals ``b*C - 1`` and
    ``b*C - 2``) entering block ``b``; ``final`` is the slab of diagonal
    ``n + m`` (score + traceback start).  ``db/mu1b/mu2b`` are the blocked
    scan inputs needed to recompute any block.

    """

    ckpts: jax.Array    # [NB, 2, Q, P, W, W] affine / [NB, 2, P, W, W]
    final: jax.Array    # [Q, P, W, W] / [P, W, W]
    db: jax.Array       # [NB, C]
    mu1b: jax.Array     # [NB, C, P]
    mu2b: jax.Array     # [NB, C, P, W, W]
    n: int
    m: int
    max_shift: int
    affine: bool
    params: tuple       # (beta, gamma, delta) / (gamma, delta)

    @property
    def block(self) -> int:
        return self.db.shape[1]

    def final_score(self) -> int:
        S = self.max_shift
        if self.affine:
            return int(jax.device_get(jnp.max(self.final[:, self.n, S, S])))
        return int(jax.device_get(self.final[self.n, S, S]))

    def _recompute(self, b: int) -> jax.Array:
        """Rematerialize block b; returns ys_ext[C+2, (Q,) ...] covering
        diagonals [b*C - 2, (b+1)*C)."""
        fn = _affine_block if self.affine else _nonaffine_block
        return fn(self.ckpts[b], self.db[b], self.mu1b[b], self.mu2b[b],
                  self.max_shift, self.params)

    def cells(self, idxs: np.ndarray) -> np.ndarray:
        """Exact values of non-affine band cells (i, j, k, l) — the verbose
        trace evaluator's read path; recomputes each touched block once."""
        idxs = np.asarray(idxs, dtype=np.int64)
        S = self.max_shift
        C = self.block
        d = idxs[:, 0] + idxs[:, 1]
        out = np.empty(len(idxs), dtype=np.int64)
        for b in np.unique(d // C):
            ys_ext = np.asarray(self._recompute(int(b)))
            sel = d // C == b
            ii, jj, kk, ll = (idxs[sel, c] for c in range(4))
            dd = ii + jj - int(b) * C + 2
            out[sel] = ys_ext[dd, ii, kk - ii + S, ll - jj + S]
        return out


# -- forward fill with checkpoints -------------------------------------------

@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _affine_ckpt_scan(db, mu1b, mu2b, n, m, S, params):
    P = mu1b.shape[2]
    step, invalid = _build_affine_step(P, S, params, True)
    target = n + m

    def inner(carry, xs):
        vm1, vm2, final = carry
        (val, nvm2), _ = step((vm1, vm2), xs)
        final = jnp.where(xs[0] == target, val, final)
        return (val, nvm2, final), None

    def outer(carry, xs):
        ck = jnp.stack([carry[0], carry[1]])
        carry, _ = lax.scan(inner, carry, xs)
        return carry, ck

    init = (invalid, invalid, invalid)
    (_, _, final), ckpts = lax.scan(outer, init, (db, mu1b, mu2b))
    return final, ckpts


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _nonaffine_ckpt_scan(db, mu1b, mu2b, n, m, S, params):
    P = mu1b.shape[2]
    step, invalid = _build_nonaffine_step(P, S, params, True)
    target = n + m

    def inner(carry, xs):
        vm1, vm2, final = carry
        (val, nvm2), _ = step((vm1, vm2), xs)
        final = jnp.where(xs[0] == target, val, final)
        return (val, nvm2, final), None

    def outer(carry, xs):
        ck = jnp.stack([carry[0], carry[1]])
        carry, _ = lax.scan(inner, carry, xs)
        return carry, ck

    init = (invalid, invalid, invalid)
    (_, _, final), ckpts = lax.scan(outer, init, (db, mu1b, mu2b))
    return final, ckpts


def _blocked_inputs(mu1d, mu2d, D: int, C: int):
    NB = -(-D // C)
    Dpad = NB * C
    mu1d = jnp.pad(mu1d, ((0, Dpad - D), (0, 0)))
    mu2d = jnp.pad(mu2d, ((0, Dpad - D),) + ((0, 0),) * 3)
    db = jnp.arange(Dpad, dtype=jnp.int32).reshape(NB, C)
    P = mu1d.shape[1]
    W = mu2d.shape[-1]
    return db, mu1d.reshape(NB, C, P), mu2d.reshape(NB, C, P, W, W)


def fill_affine_checkpoint(mu1, mu2, max_shift, beta, gamma, delta, *,
                           block: int | None = None) -> CheckpointBand:
    """Affine fill storing only block checkpoints (O(sqrt(D)) memory)."""
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    S = max_shift
    D = n + m + 1
    C = block or default_block(D)
    mu1d, mu2d = _diag_mu_tables(np.asarray(mu1), np.asarray(mu2), S)
    db, mu1b, mu2b = _blocked_inputs(mu1d, mu2d, D, C)
    params = (beta, gamma, delta)
    final, ckpts = _affine_ckpt_scan(db, mu1b, mu2b, n, m, S, params)
    return CheckpointBand(ckpts=ckpts, final=final, db=db, mu1b=mu1b,
                          mu2b=mu2b, n=n, m=m, max_shift=S, affine=True,
                          params=params)


def fill_nonaffine_checkpoint(mu1, mu2, max_shift, gamma, delta, *,
                              block: int | None = None) -> CheckpointBand:
    """Non-affine fill storing only block checkpoints."""
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    S = max_shift
    D = n + m + 1
    C = block or default_block(D)
    mu1d, mu2d = _diag_mu_tables(np.asarray(mu1), np.asarray(mu2), S)
    db, mu1b, mu2b = _blocked_inputs(mu1d, mu2d, D, C)
    params = (gamma, delta)
    final, ckpts = _nonaffine_ckpt_scan(db, mu1b, mu2b, n, m, S, params)
    return CheckpointBand(ckpts=ckpts, final=final, db=db, mu1b=mu1b,
                          mu2b=mu2b, n=n, m=m, max_shift=S, affine=False,
                          params=params)


# -- block rematerialisation --------------------------------------------------

@functools.partial(jax.jit, static_argnums=(4, 5))
def _affine_block(ck, db, mu1blk, mu2blk, S, params):
    """ys_ext[C+2, Q, P, W, W]: the checkpoint's two slabs (diagonals
    d0-2, d0-1) followed by the block's C recomputed diagonals."""
    P = mu1blk.shape[1]
    step, _ = _build_affine_step(P, S, params, False)
    _, ys = lax.scan(step, (ck[0], ck[1]), (db, mu1blk, mu2blk))
    return jnp.concatenate([ck[1][None], ck[0][None], ys], axis=0)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _nonaffine_block(ck, db, mu1blk, mu2blk, S, params):
    P = mu1blk.shape[1]
    step, _ = _build_nonaffine_step(P, S, params, False)
    _, ys = lax.scan(step, (ck[0], ck[1]), (db, mu1blk, mu2blk))
    return jnp.concatenate([ck[1][None], ck[0][None], ys], axis=0)


# -- blockwise traceback ------------------------------------------------------
#
# Same walk as device_traceback._affine_walk / _nonaffine_walk (reference
# semantics incl. co-optimal tie-breaking), restricted to one block: the
# while_loop additionally stops when i+j drops below the block's first
# diagonal, the host carries the tiny walk state to the previous block, and
# cell reads index the rematerialized ys_ext at d - d0 + 2.

def _blk_cap(C: int, S: int) -> int:
    # each step decreases i+j+k+l by >= 1; within a block i+j spans C+2
    # diagonals and k+l tracks i+j within 2S each side
    return 2 * C + 4 * S + 8


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _affine_blk_walk(ys_ext, mu1, mu2, case_const, S, n, C, d0, st0):
    m = mu1.shape[1] - 1
    Lblk = _blk_cap(C, S)

    src_t, col_t, mults_t = _affine_static_tables()
    SRC = jnp.asarray(src_t)
    COL = jnp.asarray(col_t)
    MU1C = jnp.asarray(mults_t[..., 0])
    MU2C = jnp.asarray(mults_t[..., 1])
    STATES_A = jnp.asarray([s[0] - s[2] for s in STATES], dtype=jnp.int32)
    STATES_B = jnp.asarray([s[1] - s[3] for s in STATES], dtype=jnp.int32)
    CODES = jnp.asarray(_encode_col(col_t))

    def cell(q, i, j, sk, sl):
        dd = jnp.clip(i + j - d0 + 2, 0, C + 1)
        return ys_ext[dd, q, i, sk, sl]

    def cond(st):
        return (st["done"] == 0) & (st["i"] + st["j"] >= d0) \
            & (st["step"] < Lblk)

    def body(st):
        i, j, k, l = st["i"], st["j"], st["k"], st["l"]
        q = st["q"]
        at_origin = (
            (i == 0) & (j == 0) & (k == 0) & (l == 0)
            & (q == STATE_BOTH_MATCH) & (~st["first"])
        )

        here = cell(q, i, j, k - i + S, l - j + S)

        col = COL[q]
        pi = i - col[:, 0]
        pj = j - col[:, 1]
        pk = k - col[:, 2]
        pl = l - col[:, 3]
        guard = (
            (pi >= 0) & (pj >= 0) & (pk >= 0) & (pl >= 0)
            & (jnp.abs(pk - pi) <= S) & (jnp.abs(pl - pj) <= S)
        )
        vals = (
            cell(SRC[q], jnp.clip(pi, 0, n), jnp.clip(pj, 0, m),
                 jnp.clip(pk - pi + S, 0, 2 * S),
                 jnp.clip(pl - pj + S, 0, 2 * S))
            + case_const[q]
            + MU1C[q] * mu1[i, j]
            + MU2C[q] * mu2[k, l]
        )
        is_cand = guard & (vals == here)

        tA = st["netA"] + (col[:, 0] - col[:, 2]) + STATES_A[SRC[q]]
        tB = st["netB"] + (col[:, 1] - col[:, 3]) + STATES_B[SRC[q]]
        key = (jnp.abs(tA) + jnp.abs(tB)) * _KEY_SCALE + jnp.abs(tB)
        key = jnp.where(is_cand, key, _BIG_KEY)
        sel = jnp.argmin(key)
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

    init = dict(st0)
    init["step"] = jnp.int32(0)
    init["trace"] = jnp.zeros(Lblk, dtype=jnp.int32)
    init["done"] = jnp.int32(0)
    out = lax.while_loop(cond, body, init)
    return out


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _nonaffine_blk_walk(ys_ext, mu1, mu2, case_const, S, n, C, d0, st0):
    m = mu1.shape[1] - 1
    Lblk = _blk_cap(C, S)

    COL = jnp.asarray(np.asarray(NONAFFINE_COLS, dtype=np.int32))
    tabs = NonAffineTables(0, 0)
    MU1C = jnp.asarray(tabs.mu1_coef)
    MU2C = jnp.asarray(tabs.mu2_coef)
    CODES = jnp.asarray(_encode_col(np.asarray(NONAFFINE_COLS)))

    def cell(i_, j_, sk_, sl_):
        dd = jnp.clip(i_ + j_ - d0 + 2, 0, C + 1)
        return ys_ext[dd, i_, sk_, sl_]

    def cond(st):
        at_origin = (st["i"] == 0) & (st["j"] == 0) & (st["k"] == 0) \
            & (st["l"] == 0)
        return (st["done"] == 0) & (~at_origin) \
            & (st["i"] + st["j"] >= d0) & (st["step"] < Lblk)

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
        sel = jnp.argmax(is_cand)
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

    init = dict(st0)
    init["step"] = jnp.int32(0)
    init["trace"] = jnp.zeros(Lblk, dtype=jnp.int32)
    init["done"] = jnp.int32(0)
    out = lax.while_loop(cond, body, init)
    return out


def _decode_codes(codes_walk_order):
    return [
        ((c >> 3) & 1, (c >> 2) & 1, (c >> 1) & 1, c & 1)
        for c in reversed(codes_walk_order)
    ]


def _check_step_cap(out, Lblk: int, d0: int) -> None:
    """Defensive: the per-block step cap (_blk_cap) is believed
    unreachable, but if it ever fired while the walker is still inside the
    block (i+j >= d0), the host loop would misread it as a block
    transition, descend a block, and read wrong diagonals — a silently
    corrupt trace.  Fail loudly instead."""
    if int(out["step"]) >= Lblk and int(out["i"]) + int(out["j"]) >= d0:
        raise RuntimeError(
            "checkpoint traceback: per-block step cap hit before leaving "
            f"the block (step={int(out['step'])}, i+j="
            f"{int(out['i']) + int(out['j'])}, block start diagonal {d0}) "
            "— trace would be corrupt; please report this input"
        )


def affine_traceback(cb: CheckpointBand, beta: int, gamma: int, delta: int,
                     mu1, mu2):
    """Blockwise affine traceback; (trace, complete) like the full-band
    device walk.  Host carries only the tiny walk state between blocks."""
    S = cb.max_shift
    n, m = cb.n, cb.m
    C = cb.block
    const = jnp.asarray(_affine_const(beta, gamma, delta))
    mu1j = jnp.asarray(mu1)
    mu2j = jnp.asarray(mu2)

    # start state (pyx:573-582): best final score, ties by intrinsic shift
    final = np.asarray(jax.device_get(cb.final[:, n, S, S]))
    score = final.max()
    intrinsic = np.asarray(
        [abs(s[0] - s[2]) + abs(s[1] - s[3]) for s in STATES]
    )
    start_q = int(np.argmin(np.where(final == score, intrinsic, 1 << 20)))

    st = dict(
        i=jnp.int32(n), j=jnp.int32(m), k=jnp.int32(n), l=jnp.int32(m),
        q=jnp.int32(start_q), netA=jnp.int32(0), netB=jnp.int32(0),
        first=jnp.bool_(True),
    )
    codes: list[int] = []
    done = 0
    b = (n + m) // C
    while b >= 0:
        ys_ext = cb._recompute(b)
        out = _affine_blk_walk(ys_ext, mu1j, mu2j, const, S, n, C,
                               jnp.int32(b * C), st)
        out = jax.device_get(out)
        codes.extend(out["trace"][: int(out["step"])].tolist())
        done = int(out["done"])
        if done:
            break
        _check_step_cap(out, _blk_cap(C, S), b * C)
        st = dict(
            i=jnp.int32(out["i"]), j=jnp.int32(out["j"]),
            k=jnp.int32(out["k"]), l=jnp.int32(out["l"]),
            q=jnp.int32(out["q"]), netA=jnp.int32(out["netA"]),
            netB=jnp.int32(out["netB"]), first=jnp.bool_(bool(out["first"])),
        )
        b -= 1
    return _decode_codes(codes), done == 1


def nonaffine_traceback(cb: CheckpointBand, gamma: int, delta: int, mu1,
                        mu2):
    """Blockwise non-affine traceback (forward trace list)."""
    S = cb.max_shift
    n, m = cb.n, cb.m
    C = cb.block
    tabs = NonAffineTables(gamma, delta)
    const = jnp.asarray(tabs.const)
    mu1j = jnp.asarray(mu1)
    mu2j = jnp.asarray(mu2)

    st = dict(
        i=jnp.int32(n), j=jnp.int32(m), k=jnp.int32(n), l=jnp.int32(m),
    )
    codes: list[int] = []
    b = (n + m) // C
    while b >= 0:
        ys_ext = cb._recompute(b)
        out = _nonaffine_blk_walk(ys_ext, mu1j, mu2j, const, S, n, C,
                                  jnp.int32(b * C), st)
        out = jax.device_get(out)
        codes.extend(out["trace"][: int(out["step"])].tolist())
        at_origin = (
            int(out["i"]) == 0 and int(out["j"]) == 0
            and int(out["k"]) == 0 and int(out["l"]) == 0
        )
        if at_origin or int(out["done"]):
            break
        _check_step_cap(out, _blk_cap(C, S), b * C)
        st = dict(
            i=jnp.int32(out["i"]), j=jnp.int32(out["j"]),
            k=jnp.int32(out["k"]), l=jnp.int32(out["l"]),
        )
        b -= 1
    return _decode_codes(codes)
