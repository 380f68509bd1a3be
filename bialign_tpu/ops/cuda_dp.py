"""JAX side of the CUDA wavefront kernel (:mod:`bialign_tpu.cuda`).

The kernel fills a batch of pairs in one launch, one thread block per
pair, from dense zero-padded score tables ``[B, P, M]`` and the true
lengths ``ns``/``ms``.  It emits either the band in the XLA scan's layout
``[B, D, (Q,) P, W, W]`` (D = P + M - 1), which the device walks read
unchanged, or only the scores.  It has no interpret mode: on the CPU the
XLA scan (:mod:`bialign_tpu.ops.xla_dp`) is the same recurrence, and the
CPU tests check everything this module does around the kernel (case
constants, shapes, layout, the choice of kernel).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from .cases import N_STATES, NonAffineTables, iter_affine_cases

# widest band the kernel is built for: a lattice row's W*W cells must fit
# the 32 lanes of one warp (W = 5 at max_shift 2)
MAX_SHIFT = 2


def supports(max_shift: int) -> bool:
    """Whether the kernel covers this band width (wider bands run the
    XLA scan)."""
    return 0 <= int(max_shift) <= MAX_SHIFT


@functools.lru_cache(maxsize=None)
def case_consts(params: tuple, affine: bool) -> np.ndarray:
    """Parameter-bound case constants in the kernel's case order
    (``cases_gen.h``): the affine 9 x 15 cases of
    :func:`~bialign_tpu.ops.cases.iter_affine_cases`, or the 13
    non-affine columns."""
    if not affine:
        gamma, delta = params
        return np.ascontiguousarray(
            NonAffineTables(gamma, delta).const, dtype=np.int32)
    beta, gamma, delta = params
    out = [ng * gamma + nb * beta + nd * delta
           for q in range(N_STATES)
           for (_s, _c, _m1, _m2, ng, nb, nd, _g) in iter_affine_cases(q)]
    return np.asarray(out, dtype=np.int32)


def slab_shape(B: int, P: int, M: int, max_shift: int, affine: bool,
               band: bool) -> tuple:
    """Shape of the kernel's second result: the band ``[B, D, Q, P, W,
    W]`` or, score-only, a ring of three diagonal slabs."""
    W = 2 * max_shift + 1
    Q = N_STATES if affine else 1
    return (B, P + M - 1 if band else 3, Q, P, W, W)


def fill(mu1p, mu2p, ns, ms, max_shift: int, params: tuple, affine: bool,
         band: bool):
    """Run the kernel (traced; call inside ``jit``).

    ``mu1p``/``mu2p``: ``[B, P, M]`` integer tables, zero beyond each
    pair's (n+1, m+1); ``ns``/``ms``: ``[B]`` int32.  Returns ``(scores
    [B] int32, ys)`` with ``ys`` the band ``[B, D, (Q,) P, W, W]`` when
    ``band`` else None."""
    from .. import cuda

    if not supports(max_shift):
        raise ValueError(f"the CUDA kernel covers max_shift <= {MAX_SHIFT}")
    cuda.register()
    B, P, M = mu1p.shape
    shape = slab_shape(B, P, M, max_shift, affine, band)
    call = jax.ffi.ffi_call(
        cuda.TARGET,
        (jax.ShapeDtypeStruct((B,), jnp.int32),
         jax.ShapeDtypeStruct(shape, jnp.int32)),
    )
    scores, slabs = call(
        mu1p.astype(jnp.int32), mu2p.astype(jnp.int32),
        ns.astype(jnp.int32), ms.astype(jnp.int32),
        max_shift=np.int32(max_shift), affine=np.int32(affine),
        band=np.int32(band), cst=case_consts(tuple(params), affine),
    )
    if not band:
        return scores, None
    return scores, slabs if affine else slabs[:, :, 0]


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _fill_one(mu1, mu2, max_shift, params, affine):
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    _, ys = fill(mu1[None], mu2[None], jnp.full((1,), n, jnp.int32),
                 jnp.full((1,), m, jnp.int32), max_shift, params, affine,
                 True)
    return ys[0]


def fill_device(mu1, mu2, max_shift: int, params: tuple, affine: bool):
    """Lone-pair band fill on the kernel; returns a DeviceBand."""
    from .band import DeviceBand

    mu1 = np.asarray(mu1, dtype=np.int32)
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    ys = _fill_one(jnp.asarray(mu1), jnp.asarray(mu2, dtype=jnp.int32),
                   int(max_shift), tuple(int(p) for p in params),
                   bool(affine))
    return DeviceBand(ys=ys, n=n, m=m, max_shift=int(max_shift),
                      affine=bool(affine))
