"""Sequence-split (context-parallel) scoring of ONE pair across devices.

The reference is single-threaded (SURVEY.md §2.4); batch data parallelism
(:mod:`bialign_tpu.parallel.batch`) covers corpora of pairs.  This module
covers the orthogonal axis: when a *single* pair is so long that one
device's fill is the bottleneck (or its band outgrows device memory), the
anti-diagonal wavefront itself is sharded over the mesh — the DP's analog
of context/sequence parallelism.

Design (mesh, shardings, XLA collectives between devices — NVLink on a
multi-GPU host):

* the per-diagonal slab ``V[(Q,) P, W, W]`` is split along the lattice-row
  axis ``P = n+1`` into contiguous chunks, one per device of the ``sp``
  mesh axis (``shard_map``);
* the recurrence's only cross-row dependency is row ``i-1`` (columns with
  a seqA advance, cases pyx:255-296), so each scan step exchanges a ONE-ROW
  halo ``[Q, 1, W, W]`` with the right neighbor via ``lax.ppermute`` —
  a nearest-neighbor transfer of ~Q*W*W ints (~324 B at max_shift 1)
  per carried slab per diagonal.  The step is structured so the transfer
  can genuinely overlap the math (:func:`_make_shard_step`): the halo is
  consumed ONLY by a tiny 2-row boundary fixup, while the interior slab
  update never depends on it — so in the compiled dependency graph the
  async collective-permute runs in parallel with the O(Pk*W^2*Q*cases)
  interior work, and the serial per-diagonal critical path is
  ~max(interior math, halo latency) + fixup.  (Collective time per
  step is not measured yet; the 8-device CPU mesh tests validate
  bit-exactness of the overlapped formulation.);
* each shard evaluates the shared step function
  (:func:`bialign_tpu.ops.xla_dp._build_affine_step`) on its halo-extended
  chunk with the correct *global* row offsets (``i_base``), so every cell
  is computed bit-exactly as in the single-device scan;
* the final score lives on the shard owning global row ``n``; a
  ``lax.pmax`` broadcasts it (replicated output).

Weak-scaling: per-diagonal work per device drops from O(n * W^2 * Q * cases)
to O(n/K ...); the halo is O(1).  The scan remains serial over the n+m+1
diagonals — inherent to the DP's data dependence.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

from ..ops.cases import NEG_INF, N_STATES
from ..ops.xla_dp import (
    INVALID,
    _build_affine_step,
    _build_nonaffine_step,
    _diag_mu_tables,
)


def _pad_rows(mu1d: np.ndarray, mu2d: np.ndarray, K: int):
    """Pad the lattice-row axis to a multiple of K (padded rows carry mu 0
    and global indices > n, so they never influence genuine cells: row
    information only flows toward HIGHER rows)."""
    P = mu1d.shape[1]
    Ppad = -(-P // K) * K
    mu1d = np.pad(mu1d, ((0, 0), (0, Ppad - P)))
    mu2d = np.pad(mu2d, ((0, 0), (0, Ppad - P)) + ((0, 0),) * 2)
    return mu1d, mu2d


def _make_shard_step(axis: str, K: int, S: int, params, affine: bool,
                     Pk: int, W: int):
    """Halo-overlapped per-diagonal step for one row-shard.

    The only cross-shard dependency of a diagonal is the LAST row of the
    left neighbor's previous two slabs.  Structuring the step as

    * ``ppermute`` the two one-row halos (issued first),
    * interior step over the shard's own Pk rows (does NOT read the halo;
      its row 0, which would need it, is discarded),
    * a 2-row boundary fixup (halo row + local row 0) that is the ONLY
      consumer of the transferred halos,

    puts the halo transfer latency in parallel with the interior slab math
    in the dependency graph — XLA's scheduler can overlap the async
    collective-permute with the O(Pk * W^2 * Q * cases) interior work,
    instead of serializing transfer -> whole-slab step as a halo-
    concatenated formulation would.  Bit-exact: interior rows >= 1 never
    read row -1, and the fixup evaluates global rows (idx*Pk - 1, idx*Pk)
    with the exact step function (i_base arithmetic included).

    Returns (shard_step, invalid_carry, row_ax) with
    ``shard_step((vm1, vm2), (d, mu1_row, mu2_blk)) -> val``.
    """
    Q = N_STATES
    build = _build_affine_step if affine else _build_nonaffine_step
    perm = [(k, k + 1) for k in range(K - 1)]
    idx = lax.axis_index(axis)
    step_int, _ = build(Pk, S, params, True, i_base=idx * Pk)
    step_fix, _ = build(2, S, params, True, i_base=idx * Pk - 1)

    shape = (Q, Pk, W, W) if affine else (Pk, W, W)
    # mark the carry as varying over the mesh axis (shard_map vma typing)
    invalid = lax.pcast(jnp.full(shape, INVALID, jnp.int32), (axis,),
                        to="varying")
    row_ax = 1 if affine else 0

    def halo(v):
        last = lax.slice_in_dim(v, Pk - 1, Pk, axis=row_ax)
        h = lax.ppermute(last, axis, perm)     # non-participants: zeros
        return jnp.where(idx == 0, INVALID, h)

    def shard_step(carry, xs):
        vm1, vm2 = carry
        d, mu1_row, mu2_blk = xs
        h1 = halo(vm1)                         # in flight during step_int
        h2 = halo(vm2)
        (vint, _), _ = step_int((vm1, vm2), (d, mu1_row, mu2_blk))
        vm1f = jnp.concatenate(
            [h1, lax.slice_in_dim(vm1, 0, 1, axis=row_ax)], axis=row_ax
        )
        vm2f = jnp.concatenate(
            [h2, lax.slice_in_dim(vm2, 0, 1, axis=row_ax)], axis=row_ax
        )
        mu1f = jnp.concatenate([jnp.zeros((1,), jnp.int32), mu1_row[:1]])
        mu2f = jnp.concatenate(
            [jnp.zeros((1, W, W), jnp.int32), mu2_blk[:1]]
        )
        (vfix, _), _ = step_fix((vm1f, vm2f), (d, mu1f, mu2f))
        row0 = lax.slice_in_dim(vfix, 1, 2, axis=row_ax)
        return jnp.concatenate(
            [row0, lax.slice_in_dim(vint, 1, Pk, axis=row_ax)],
            axis=row_ax,
        )

    return shard_step, invalid, row_ax


def _sharded_scan(mesh: Mesh, axis: str, n: int, m: int, S: int, params,
                  affine: bool):
    """Build the shard_map-ed scoring function over the given mesh axis."""
    K = mesh.shape[axis]
    W = 2 * S + 1

    def body(mu1_loc, mu2_loc):
        # mu1_loc: [D, Pk]; mu2_loc: [D, Pk, W, W]
        D, Pk = mu1_loc.shape
        idx = lax.axis_index(axis)
        shard_step, invalid, row_ax = _make_shard_step(
            axis, K, S, params, affine, Pk, W
        )

        def sstep(carry, xs):
            vm1, vm2 = carry
            val = shard_step((vm1, vm2), xs)
            return (val, vm1), None

        xs = (jnp.arange(n + m + 1, dtype=jnp.int32), mu1_loc, mu2_loc)
        (last, _), _ = lax.scan(sstep, (invalid, invalid), xs)

        row = n - idx * Pk
        owned = (row >= 0) & (row < Pk)
        rc = jnp.clip(row, 0, Pk - 1)
        mid = last[:, rc, S, S] if affine else last[rc, S, S]
        cand = jnp.where(owned, jnp.max(mid), NEG_INF)
        return lax.pmax(cand, axis)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(PS(None, axis), PS(None, axis, None, None)),
        out_specs=PS(),
    )


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7),
                   static_argnames=("mesh", "axis"))
def _score_jit(mu1d, mu2d, n, m, S, params, affine, K, *, mesh, axis):
    return _sharded_scan(mesh, axis, n, m, S, params, affine)(mu1d, mu2d)


def score_seqsplit(mu1, mu2, max_shift: int, params: tuple, *, mesh: Mesh,
                   axis: str = "sp", affine: bool = True) -> int:
    """Optimal score of one pair, wavefront sharded over ``mesh[axis]``.

    ``params``: (beta, gamma, delta) for affine, (gamma, delta) otherwise.
    Bit-exact with the single-device engines (tests/test_seqsplit.py).
    """
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    S = max_shift
    K = mesh.shape[axis]
    mu1d, mu2d = _diag_mu_tables(np.asarray(mu1), np.asarray(mu2), S)
    mu1d, mu2d = _pad_rows(np.asarray(mu1d), np.asarray(mu2d), K)

    row_sharding = NamedSharding(mesh, PS(None, axis))
    mu1d = jax.device_put(mu1d, row_sharding)
    mu2d = jax.device_put(
        jnp.asarray(mu2d), NamedSharding(mesh, PS(None, axis, None, None))
    )
    score = _score_jit(mu1d, mu2d, n, m, S, tuple(params), affine, K,
                       mesh=mesh, axis=axis)
    return int(jax.device_get(score))


# -- sequence-split fill WITH traceback (checkpointed, sharded) ---------------
#
# VERDICT r2 item 5: a pair long enough to need sharding must still yield
# the full bit-exact alignment.  The fill runs the same halo-exchange
# wavefront but stores the scan carry every C diagonals (the checkpoint-
# band recipe, ops/checkpoint_dp.py); blocks are rematerialized SHARDED on
# demand, so no device ever holds more than its row slice of a block, and
# the tiny blockwise walk itself reuses checkpoint_dp's reference-exact
# traceback (smart-shift argmin, pyx:535-586) on the gathered block.

import math
from dataclasses import dataclass, field

from ..ops.checkpoint_dp import (
    CheckpointBand,
    affine_traceback as _ckpt_affine_traceback,  # noqa: F401 (re-export)
    default_block,
)


def _halo_machinery(axis: str, K: int, S: int, params, affine: bool,
                    Pk: int, W: int):
    """Shared per-shard pieces for the checkpointed fill/remat: the
    halo-overlapped step (:func:`_make_shard_step`) wrapped as a scan
    body that also emits the slab as ys."""
    shard_step, invalid, row_ax = _make_shard_step(
        axis, K, S, params, affine, Pk, W
    )

    def sstep(carry, xs):
        vm1, vm2 = carry
        val = shard_step((vm1, vm2), xs)
        return (val, vm1), val

    return sstep, invalid, row_ax


@functools.lru_cache(maxsize=32)
def _ckpt_fill_fn(mesh, axis, n, m, S, params, affine, K):
    """shard_map-ed checkpointing fill: (db, mu1b, mu2b) -> (final, ckpts)."""
    W = 2 * S + 1

    def body(db, mu1b_loc, mu2b_loc):
        NB, C, Pk = mu1b_loc.shape
        sstep, invalid, _ = _halo_machinery(
            axis, K, S, params, affine, Pk, W
        )

        def inner(carry, xs):
            vm1, vm2, final = carry
            (val, pvm1), _ = sstep((vm1, vm2), xs)
            final = jnp.where(xs[0] == n + m, val, final)
            return (val, pvm1, final), None

        def outer(carry, xs):
            ck = jnp.stack([carry[0], carry[1]])
            carry, _ = lax.scan(inner, carry, xs)
            return carry, ck

        init = (invalid, invalid, invalid)
        (_, _, final), ckpts = lax.scan(
            outer, init, (db, mu1b_loc, mu2b_loc)
        )
        return final, ckpts

    if affine:
        fin_spec, ck_spec = PS(None, axis), PS(None, None, None, axis)
    else:
        fin_spec, ck_spec = PS(axis), PS(None, None, axis)
    return jax.jit(jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(PS(), PS(None, None, axis),
                  PS(None, None, axis, None, None)),
        out_specs=(fin_spec, ck_spec),
    ))


@functools.lru_cache(maxsize=32)
def _block_remat_fn(mesh, axis, S, params, affine, K):
    """shard_map-ed block rematerialisation: ys_ext[C+2, (Q,) P, W, W]."""
    W = 2 * S + 1

    def body(ck_loc, db, mu1blk_loc, mu2blk_loc):
        C, Pk = mu1blk_loc.shape
        sstep, _, _ = _halo_machinery(axis, K, S, params, affine, Pk, W)
        (_, _), ys = lax.scan(
            sstep, (ck_loc[0], ck_loc[1]), (db, mu1blk_loc, mu2blk_loc)
        )
        return jnp.concatenate([ck_loc[1][None], ck_loc[0][None], ys],
                               axis=0)

    if affine:
        ck_spec, ys_spec = PS(None, None, axis), PS(None, None, axis)
    else:
        ck_spec, ys_spec = PS(None, axis), PS(None, axis)
    return jax.jit(jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(ck_spec, PS(), PS(None, axis),
                  PS(None, axis, None, None)),
        out_specs=ys_spec,
    ))


@dataclass(frozen=True)
class SeqsplitBand(CheckpointBand):
    """Checkpointed band whose fill AND block rematerialisation run
    sharded over the ``axis`` mesh axis; the inherited blockwise
    traceback / cells() walk the gathered blocks bit-exactly."""

    mesh: Mesh = None
    axis: str = "sp"

    def _recompute(self, b: int):
        fn = _block_remat_fn(self.mesh, self.axis, self.max_shift,
                             tuple(self.params), self.affine,
                             self.mesh.shape[self.axis])
        ys_ext = fn(self.ckpts[b], self.db[b], self.mu1b[b], self.mu2b[b])
        # gather to host: the walk reads scattered single cells, which
        # would otherwise become per-cell cross-device collectives
        return np.asarray(jax.device_get(ys_ext))


def fill_seqsplit(mu1, mu2, max_shift: int, params: tuple, *, mesh: Mesh,
                  axis: str = "sp", affine: bool = True,
                  block: int | None = None) -> SeqsplitBand:
    """Sequence-split fill of one pair with traceback support.

    Returns a :class:`SeqsplitBand` (a :class:`CheckpointBand`), so
    ``checkpoint_dp.affine_traceback`` / ``nonaffine_traceback`` and the
    BiAligner decode path work on it unchanged.
    """
    from ..ops.checkpoint_dp import _blocked_inputs

    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    S = max_shift
    K = mesh.shape[axis]
    D = n + m + 1
    C = block or default_block(D)

    mu1d, mu2d = _diag_mu_tables(np.asarray(mu1), np.asarray(mu2), S)
    mu1d, mu2d = _pad_rows(np.asarray(mu1d), np.asarray(mu2d), K)
    db, mu1b, mu2b = _blocked_inputs(
        jnp.asarray(mu1d), jnp.asarray(mu2d), D, C
    )

    row = NamedSharding(mesh, PS(None, None, axis))
    mu1b = jax.device_put(mu1b, row)
    mu2b = jax.device_put(
        mu2b, NamedSharding(mesh, PS(None, None, axis, None, None))
    )
    fn = _ckpt_fill_fn(mesh, axis, n, m, S, tuple(params), affine, K)
    final, ckpts = fn(db, mu1b, mu2b)
    return SeqsplitBand(
        ckpts=ckpts, final=final, db=db, mu1b=mu1b, mu2b=mu2b, n=n, m=m,
        max_shift=S, affine=affine, params=tuple(params), mesh=mesh,
        axis=axis,
    )
