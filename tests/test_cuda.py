"""The CUDA wavefront kernel's wrapper (CPU) and the kernel itself (GPU).

The kernel has no interpret mode.  On the CPU these tests check what
surrounds it: the case tables it is built and called with, the shapes
and layout of its results, the padding of its inputs, and which engine
runs.  The ``gpu`` tests compare the compiled kernel with the host C++
engine, the oracle and the XLA path bit for bit, on the card.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bialign_tpu import cuda
from bialign_tpu.ops import cuda_dp, native_dp, reference_dp
from bialign_tpu.ops import traceback as host_tb
from bialign_tpu.ops.cases import (
    N_STATES,
    NONAFFINE_COLS,
    iter_affine_cases,
    nonaffine_case_multiplicities,
)
from bialign_tpu.parallel import batch as pbatch


def _genuine_mask(n, m, S):
    i = np.arange(n + 1)[:, None, None, None]
    j = np.arange(m + 1)[None, :, None, None]
    k = i + np.arange(2 * S + 1)[None, None, :, None] - S
    l = j + np.arange(2 * S + 1)[None, None, None, :] - S
    return (k >= 0) & (k <= n) & (l >= 0) & (l <= m)


def _rand_pair(rng, n, m, scale=100):
    mu1 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu2 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu1[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * scale
    mu2[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * scale
    return mu1, mu2


def test_case_consts_match_native_tables():
    """The kernel's constants are the host engine's, in its case order."""
    for params in [(-150, -50, -150), (-7, -13, -29), (100, 50, 75)]:
        cst = native_dp._affine_tables(*params)[2]
        assert (cuda_dp.case_consts(params, True) == cst.ravel()).all()
    for params in [(-200, -250), (-50, -100)]:
        cst = native_dp._nonaffine_tables(*params)[1]
        assert (cuda_dp.case_consts(params, False) == cst).all()


def _header_table(name):
    text = cuda.case_header()
    body = re.search(name + r"\(int i\) \{\n  constexpr int t\[\d+\] = "
                     r"\{([^}]*)\}", text).group(1)
    return [int(v) for v in body.split(",")]


def _decode(meta):
    col = tuple((meta >> b) & 1 for b in range(4))
    return (col, (meta >> 4) & 15, (meta >> 8) & 1, (meta >> 9) & 1,
            (meta >> 10) & 1)


def test_case_header_decodes_to_cases():
    """cases_gen.h packs cases.py's tables losslessly, in order; the k/l
    guard is dropped exactly for the affine seq-only half columns."""
    aff = [_decode(v) for v in _header_table("aff_meta")]
    want = [
        (tuple(col), src, m1, m2, 0 if col[2] == col[3] == 0 else 1)
        for q in range(N_STATES)
        for (src, col, m1, m2, _g, _b, _d, _grp) in iter_affine_cases(q)
    ]
    assert aff == want
    na = [_decode(v) for v in _header_table("na_meta")]
    want_na = [(tuple(col), 0) + nonaffine_case_multiplicities(col)[:2]
               + (1,) for col in NONAFFINE_COLS]
    assert na == want_na


@pytest.mark.parametrize("affine", [True, False])
def test_result_shapes_and_layout(monkeypatch, affine):
    """The FFI call returns scores [B] and the band in the XLA layout
    [B, D, (Q,) P, W, W] (non-affine drops the state axis), or a
    three-slab ring when only scores are wanted."""
    monkeypatch.setattr(cuda, "register", lambda: None)
    B, P, M, S = 3, 9, 6, 2
    params = (-150, -50, -150) if affine else (-200, -250)
    args = (jnp.zeros((B, P, M), jnp.int16), jnp.zeros((B, P, M), jnp.int16),
            jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32))

    def run(band):
        return jax.eval_shape(
            lambda *a: cuda_dp.fill(*a, S, params, affine, band), *args)

    scores, ys = run(True)
    assert scores.shape == (B,) and scores.dtype == jnp.int32
    W = 2 * S + 1
    want = (B, P + M - 1, 9, P, W, W) if affine else (B, P + M - 1, P, W, W)
    assert ys.shape == want
    assert run(False)[1] is None
    assert cuda_dp.slab_shape(B, P, M, S, affine, False)[1] == 3
    jaxpr = jax.make_jaxpr(
        lambda *a: cuda_dp.fill(*a, S, params, affine, True))(*args)
    (call,) = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "ffi_call"]
    assert call.params["target_name"] == cuda.TARGET


def test_kernel_band_widths():
    assert [cuda_dp.supports(s) for s in range(5)] == [
        True, True, True, False, False]
    with pytest.raises(ValueError, match="max_shift"):
        cuda_dp.fill(None, None, None, None, 3, (-200, -250), False, True)


def test_bucket_inputs_are_dense_padded_tables():
    """The kernel reads dense [B, N+1, M+1] tables zero-padded per pair
    (int16 on the wire when the values fit) and per-pair true lengths."""
    rng = np.random.default_rng(3)
    pairs = [_rand_pair(rng, 5, 7), _rand_pair(rng, 8, 4)]
    (b,) = pbatch.make_buckets(pairs, 8).values()
    mu1p, mu2p, ns, ms = pbatch._pack(b, 0, 2, None)
    assert mu1p.shape == mu2p.shape == (2, 9, 9)
    assert mu1p.dtype == np.int16
    assert ns.tolist() == [5, 8] and ms.tolist() == [7, 4]
    assert (mu1p[0, :6, :8] == pairs[0][0]).all()
    assert not mu1p[0, 6:].any() and not mu1p[0, :, 8:].any()


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("affine", [True, False])
def test_kernel_band_matches_host_engine(gpu, affine):
    """The compiled kernel's band == the host C++ engine's (oracle
    layout) on every genuine cell, across band widths and degenerate
    lengths."""
    from bialign_tpu.ops.device_traceback import affine_traceback

    rng = np.random.default_rng(1)
    for S in (0, 1, 2):
        for n, m in [(5, 7), (1, 1), (0, 4), (40, 37), (70, 90)]:
            mu1, mu2 = _rand_pair(rng, n, m)
            params = (-150, -50, -150) if affine else (-200, -250)
            kb = cuda_dp.fill_device(mu1, mu2, S, params, affine)
            fill = (native_dp.fill_affine if affine
                    else native_dp.fill_nonaffine)
            H = fill(mu1, mu2, S, *params)
            ok = _genuine_mask(n, m, S)
            got = kb.to_numpy()
            assert np.where(ok, got == H, True).all(), (S, n, m)
            if affine and n and m:
                tr, _ = affine_traceback(kb, *params, mu1, mu2)
                want, _ = host_tb.affine_traceback(H, mu1, mu2, S, *params)
                assert tr == want, (S, n, m)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [0, 1, 2])
def test_kernel_batch_matches_oracle(gpu, S):
    rng = np.random.default_rng(2 + S)
    pairs = [_rand_pair(rng, 10 + i, 14 - i) for i in range(6)]
    params = (-150, -50, -150)
    want = []
    for mu1, mu2 in pairs:
        H = reference_dp.fill_affine(mu1, mu2, S, *params)
        want.append(reference_dp.affine_score_from_band(
            H, mu1.shape[0] - 1, mu1.shape[1] - 1, S))
    got = pbatch.score_batch(pairs, S, params, affine=True,
                             bucket_quantum=16, engine="cuda")
    assert got.tolist() == want
    sc, tr, _ = pbatch.align_batch(pairs, S, params, affine=True,
                                   bucket_quantum=16, engine="cuda")
    sx, tx, _ = pbatch.align_batch(pairs, S, params, affine=True,
                                   bucket_quantum=16, engine="xla")
    assert sc.tolist() == want and tr == tx
