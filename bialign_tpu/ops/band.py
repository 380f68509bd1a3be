"""Device-resident DP band handle.

The wavefront engines (:mod:`bialign_tpu.ops.xla_dp`,
:mod:`bialign_tpu.ops.cuda_dp`) fill the band in diagonal-major layout
``ys[d, (q,) i, sk, sl]`` with ``d = i + j``.  The reference keeps its band
in host memory and walks it with Python (bialignment.pyx:513-586); here
the band stays in device memory and the traceback runs on the device
(:mod:`bialign_tpu.ops.device_traceback`), so only the trace itself —
O(n+m) small integers — ever crosses the host boundary.

:class:`DeviceBand` wraps the device array plus its geometry and offers
exact cell reads (vectorized gathers) for the verbose trace evaluator and
for cross-engine tests.
"""

from __future__ import annotations

from dataclasses import dataclass

import functools

import numpy as np

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnums=(2,))
def _gather_cells(ys, idxs, affine):
    """Gather band cells; idxs columns are (q,) i, j, sk, sl."""
    i = idxs[:, -4]
    d = i + idxs[:, -3]
    sk = idxs[:, -2]
    sl = idxs[:, -1]
    if affine:
        return ys[d, idxs[:, 0], i, sk, sl]
    return ys[d, i, sk, sl]


@functools.partial(jax.jit, static_argnums=(4,))
def _final_score(ys, n, m, S, affine):
    if affine:
        return jnp.max(ys[n + m, :, n, S, S])
    return ys[n + m, n, S, S]


def _pad_pow2(x: np.ndarray) -> np.ndarray:
    """Pad the leading axis to the next power of two (bounds the number of
    distinct gather compilations; padded rows repeat row 0)."""
    N = len(x)
    P = 1
    while P < N:
        P *= 2
    if P == N:
        return x
    return np.concatenate([x, np.repeat(x[:1], P - N, axis=0)])


@dataclass(frozen=True)
class DeviceBand:
    """A filled DP band living on device.

    ``ys``: ``[D, Q, P, W, W]`` (affine) or ``[D, P, W, W]`` (non-affine),
    diagonal-major, int32.  Cell (q, i, j, sk, sl) = ``ys[i+j, q, i, sk, sl]``.
    """

    ys: jax.Array
    n: int
    m: int
    max_shift: int
    affine: bool

    def cells(self, idxs: np.ndarray) -> np.ndarray:
        """Exact values of a batch of cells; one vectorized device gather.

        ``idxs``: int array ``[N, 5]`` of (q, i, j, k, l) for affine bands,
        ``[N, 4]`` of (i, j, k, l) otherwise (absolute k/l, like the
        reference's SparseMatrix4D indexing, pyx:24-41).
        """
        idxs = np.asarray(idxs, dtype=np.int32)
        N = len(idxs)
        S = self.max_shift
        rel = idxs.copy()
        rel[:, -2] = idxs[:, -2] - idxs[:, -4] + S   # sk = k - i + S
        rel[:, -1] = idxs[:, -1] - idxs[:, -3] + S   # sl = l - j + S
        rel = _pad_pow2(rel)
        vals = jax.device_get(
            _gather_cells(self.ys, jnp.asarray(rel), self.affine)
        )
        return vals[:N]

    def cell(self, *idx) -> int:
        return int(self.cells(np.asarray([idx]))[0])

    def final_score(self) -> int:
        """Optimal score read from the final cell (one tiny transfer)."""
        return int(jax.device_get(_final_score(
            self.ys, self.n, self.m, self.max_shift, self.affine,
        )))

    def to_numpy(self) -> np.ndarray:
        """Full band in oracle layout H[(q,) i, j, sk, sl] (tests only —
        transfers the entire band to host)."""
        ys = np.asarray(self.ys)
        n, m = self.n, self.m
        W = 2 * self.max_shift + 1
        if self.affine:
            Q = ys.shape[1]
            H = np.empty((Q, n + 1, m + 1, W, W), dtype=np.int64)
            for i in range(n + 1):
                H[:, i] = ys[i:i + m + 1, :, i].swapaxes(0, 1)
        else:
            H = np.empty((n + 1, m + 1, W, W), dtype=np.int64)
            for i in range(n + 1):
                H[i] = ys[i:i + m + 1, i]
        return H
