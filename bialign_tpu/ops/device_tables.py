"""Score-table builders that run on the device, for every backend.

The wavefront engines read the score tables in diagonal layout
``MU1D[d, i] = mu1[i, d - i]`` and ``MU2D[d, i, sk, sl] = mu2[i + sk - S,
d - i + sl - S]`` (zero out of range, see :func:`bialign_tpu.ops.xla_dp.
_diag_mu_tables`).  Building those on the host costs O(D * P * W^2) numpy
work and as many bytes over the host link per pair; these builders make
them on the device from the dense tables (or, for protein, from O(n) code
vectors and one 256x256 LUT), as plain ``jnp`` that XLA compiles on any
backend.  All functions are traced: call them inside ``jit``.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def skew(a, D: int):
    """[P, C] -> [P, D] with out[i, d] = a[i, d - i] (0 outside
    0 <= d - i < C): the anti-diagonal shear as pad + reshape, with no
    gather."""
    P, C = a.shape
    width = max(D, C + P - 1)
    ap = jnp.pad(a, ((0, 0), (0, width + 1 - C)))
    flat = ap.reshape(-1)[: P * width]
    return flat.reshape(P, width)[:, :D]


def shifted(mu, dk: int, dl: int):
    """[P, M] -> same shape with out[i, j] = mu[i + dk, j + dl], zeros out
    of range (static pad + slice)."""
    P, M = mu.shape
    padded = jnp.pad(mu, ((max(-dk, 0), max(dk, 0)),
                          (max(-dl, 0), max(dl, 0))))
    return padded[max(dk, 0): max(dk, 0) + P, max(dl, 0): max(dl, 0) + M]


def diag_tables(mu1p, mu2p, S: int, D: int):
    """Diagonal-layout tables from dense ``[P, M]`` tables.

    Returns MU1D ``[D, P]`` and MU2D ``[D, P, W, W]`` int32, the layout
    the XLA scan reads.  Each (sk, sl) plane is a statically shifted copy
    of mu2 sheared by :func:`skew`: relayout copies only."""
    W = 2 * S + 1
    mu1d = skew(mu1p.astype(jnp.int32), D).T
    m2 = mu2p.astype(jnp.int32)
    planes = jnp.stack([
        jnp.stack([skew(shifted(m2, sk - S, sl - S), D).T
                   for sl in range(W)])
        for sk in range(W)
    ])                                           # [W, W, D, P]
    return mu1d, planes.transpose(2, 3, 0, 1)


def narrow_if_fits(mu: np.ndarray) -> np.ndarray:
    """int16 copy of a host score table when its values fit, which halves
    the bytes sent to the device; every consumer widens to int32 before
    any arithmetic, so scores are unchanged."""
    mu = np.asarray(mu)
    if mu.dtype == np.int16:
        return mu
    if int(np.abs(mu).max(initial=0)) < (1 << 15):
        return mu.astype(np.int16)
    return mu.astype(np.int32)


def mu_planes_from_codes(lut, ca, cb, sa, sb, ns, ms, sw):
    """``[B, P]`` / ``[B, M]`` uint8 code vectors -> int32 mu planes.

    mu1[b, i, j] = lut[ca[b, i], cb[b, j]] and mu2[b, i, j] =
    sw * (sa == sb), masked to the true 1-based (n, m) region (zeros
    elsewhere, row and column 0 included): exactly the host tables
    (scoring/tables.py sequence and structure similarity).

    The LUT is applied as two one-hot contractions.  They are exact only
    at ``Precision.HIGHEST`` (true fp32; the GPU's default may round the
    operands to TF32, whose 10-bit mantissa cannot hold values like 500)
    and only while every LUT entry is below 2^24 in magnitude, which the
    codes dispatchers check (parallel/batch.py).
    """
    B, P = ca.shape
    M = cb.shape[1]
    i_ = jnp.arange(P, dtype=jnp.int32)[None, :, None]
    j_ = jnp.arange(M, dtype=jnp.int32)[None, None, :]
    mask = ((i_ >= 1) & (i_ <= ns[:, None, None])
            & (j_ >= 1) & (j_ <= ms[:, None, None]))
    hi = jax.lax.Precision.HIGHEST
    sym = jnp.arange(256, dtype=jnp.int32)
    e_a = (ca.astype(jnp.int32)[:, :, None] == sym).astype(jnp.float32)
    e_b = (cb.astype(jnp.int32)[:, :, None] == sym).astype(jnp.float32)
    rows = jnp.einsum("bpc,cd->bpd", e_a, lut.astype(jnp.float32),
                      precision=hi)
    mu1 = jnp.einsum("bpd,bmd->bpm", rows, e_b,
                     precision=hi).astype(jnp.int32)
    mu1 = jnp.where(mask, mu1, 0)
    mu2 = jnp.where(mask & (sa[:, :, None] == sb[:, None, :]),
                    jnp.int32(sw), 0)
    return mu1, mu2
