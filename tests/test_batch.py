"""Batched + sharded scoring must equal per-pair oracle scores exactly."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from bialign_tpu.ops import reference_dp
from bialign_tpu.parallel import batch as pbatch


def _rand_pair(rng, n, m):
    mu1 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu2 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu1[1:, 1:] = rng.integers(-400, 900, size=(n, m))
    mu2[1:, 1:] = rng.integers(-400, 900, size=(n, m))
    return mu1, mu2


SIZES = [(5, 7), (8, 8), (3, 12), (12, 3), (1, 1), (6, 6), (9, 4), (7, 7)]


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(42)
    return [_rand_pair(rng, n, m) for n, m in SIZES]


def _oracle_scores(pairs, S, beta, gamma, delta, affine):
    out = []
    for mu1, mu2 in pairs:
        n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
        if affine:
            H = reference_dp.fill_affine(mu1, mu2, S, beta, gamma, delta)
            out.append(reference_dp.affine_score_from_band(H, n, m, S))
        else:
            H = reference_dp.fill_nonaffine(mu1, mu2, S, gamma, delta)
            out.append(reference_dp.nonaffine_score_from_band(H, n, m, S))
    return np.asarray(out)


def test_batched_affine_matches_oracle(pairs):
    S, beta, gamma, delta = 1, -150, -50, -150
    want = _oracle_scores(pairs, S, beta, gamma, delta, True)
    got = pbatch.score_batch(
        pairs, S, (beta, gamma, delta), affine=True, bucket_quantum=8
    )
    assert (got == want).all()


def test_batched_nonaffine_matches_oracle(pairs):
    S, gamma, delta = 2, -200, -250
    want = _oracle_scores(pairs, S, 0, gamma, delta, False)
    got = pbatch.score_batch(
        pairs, S, (gamma, delta), affine=False, bucket_quantum=8
    )
    assert (got == want).all()


def test_sharded_affine_matches_oracle(pairs):
    S, beta, gamma, delta = 1, -150, -50, -150
    devices = np.array(jax.devices())
    assert len(devices) == 8, "conftest should provide 8 virtual devices"
    mesh = Mesh(devices, ("data",))
    want = _oracle_scores(pairs, S, beta, gamma, delta, True)
    got = pbatch.score_batch(
        pairs, S, (beta, gamma, delta), affine=True, mesh=mesh,
        bucket_quantum=16,
    )
    assert (got == want).all()


def test_batched_xla_engine_matches_oracle(pairs):
    """Explicit engine="xla": vmapped scan with device-built tables."""
    S, beta, gamma, delta = 1, -150, -50, -150
    want = _oracle_scores(pairs, S, beta, gamma, delta, True)
    got = pbatch.score_batch(
        pairs, S, (beta, gamma, delta), affine=True, bucket_quantum=8,
        engine="xla",
    )
    assert (got == want).all()


def test_sharded_xla_engine_matches_oracle(pairs):
    """shard_map of the batched scorer over an 8-device data mesh with
    an explicit engine vs per-pair oracle."""
    S, beta, gamma, delta = 1, -150, -50, -150
    devices = np.array(jax.devices())
    assert len(devices) == 8, "conftest should provide 8 virtual devices"
    mesh = Mesh(devices, ("data",))
    want = _oracle_scores(pairs, S, beta, gamma, delta, True)
    got = pbatch.score_batch(
        pairs, S, (beta, gamma, delta), affine=True, mesh=mesh,
        bucket_quantum=16, engine="xla",
    )
    assert (got == want).all()


def test_batched_xla_nonaffine_matches_oracle(pairs):
    S, gamma, delta = 1, -200, -250
    want = _oracle_scores(pairs, S, 0, gamma, delta, False)
    got = pbatch.score_batch(
        pairs, S, (gamma, delta), affine=False, bucket_quantum=8,
        engine="xla",
    )
    assert (got == want).all()


def test_sharded_xla_nonaffine_matches_oracle(pairs):
    S, gamma, delta = 2, -200, -250
    devices = np.array(jax.devices())
    mesh = Mesh(devices, ("data",))
    want = _oracle_scores(pairs, S, 0, gamma, delta, False)
    got = pbatch.score_batch(
        pairs, S, (gamma, delta), affine=False, mesh=mesh,
        bucket_quantum=16, engine="xla",
    )
    assert (got == want).all()


def test_mixed_length_bucket_matches_oracle():
    """One bucket of 16 pairs with mixed true lengths, both
    recurrences: padding must never change a score."""
    rng = np.random.default_rng(11)
    pairs = [
        _rand_pair(rng, 5 + (i % 4), 6 + (i % 3)) for i in range(16)
    ]
    S, beta, gamma, delta = 1, -150, -50, -150
    want = _oracle_scores(pairs, S, beta, gamma, delta, True)
    got = pbatch.score_batch(
        pairs, S, (beta, gamma, delta), affine=True, bucket_quantum=8,
    )
    assert (got == want).all(), (got, want)

    want_na = _oracle_scores(pairs, S, 0, -200, -250, False)
    got_na = pbatch.score_batch(
        pairs, S, (-200, -250), affine=False, bucket_quantum=8,
    )
    assert (got_na == want_na).all(), (got_na, want_na)


def _oracle_traces(pairs, S, beta, gamma, delta, affine):
    from bialign_tpu.ops import traceback as tb

    traces, comps = [], []
    for mu1, mu2 in pairs:
        if affine:
            H = reference_dp.fill_affine(mu1, mu2, S, beta, gamma, delta)
            tr, comp = tb.affine_traceback(H, mu1, mu2, S, beta, gamma,
                                           delta)
        else:
            H = reference_dp.fill_nonaffine(mu1, mu2, S, gamma, delta)
            tr = tb.nonaffine_traceback(H, mu1, mu2, S, gamma, delta)
            comp = True
        traces.append(tr)
        comps.append(comp)
    return traces, comps


def test_align_batch_affine_bit_exact(pairs):
    """Batched fill+walk traces == per-pair host walk (exact reference
    tie-breaking), VERDICT r3 item 1."""
    S, beta, gamma, delta = 1, -150, -50, -150
    want_scores = _oracle_scores(pairs, S, beta, gamma, delta, True)
    want_traces, want_comps = _oracle_traces(pairs, S, beta, gamma,
                                             delta, True)
    scores, traces, comps = pbatch.align_batch(
        pairs, S, (beta, gamma, delta), affine=True, bucket_quantum=8
    )
    assert (scores == want_scores).all()
    assert comps == want_comps
    for got, want in zip(traces, want_traces):
        assert got == want


def test_align_batch_nonaffine_bit_exact(pairs):
    S, gamma, delta = 2, -200, -250
    want_scores = _oracle_scores(pairs, S, 0, gamma, delta, False)
    want_traces, _ = _oracle_traces(pairs, S, 0, gamma, delta, False)
    scores, traces, _ = pbatch.align_batch(
        pairs, S, (gamma, delta), affine=False, bucket_quantum=8
    )
    assert (scores == want_scores).all()
    for got, want in zip(traces, want_traces):
        assert got == want


def test_align_batch_64_pairs_chunked():
    """64-pair bucket, chunk smaller than the batch (multiple fused
    dispatches), mixed lengths — the bench workload's CPU parity tier."""
    rng = np.random.default_rng(7)
    pairs = [_rand_pair(rng, 4 + (i % 5), 5 + (i % 4)) for i in range(64)]
    S, beta, gamma, delta = 1, -150, -50, -150
    want_scores = _oracle_scores(pairs, S, beta, gamma, delta, True)
    want_traces, want_comps = _oracle_traces(pairs, S, beta, gamma,
                                             delta, True)
    scores, traces, comps = pbatch.align_batch(
        pairs, S, (beta, gamma, delta), affine=True, bucket_quantum=8,
        chunk=24,
    )
    assert (scores == want_scores).all()
    assert comps == want_comps
    for got, want in zip(traces, want_traces):
        assert got == want


def test_prepared_batch_matches_score_batch(pairs):
    """PreparedBatch (cached device buckets) == fresh score_batch."""
    S, beta, gamma, delta = 1, -150, -50, -150
    want = pbatch.score_batch(
        pairs, S, (beta, gamma, delta), affine=True, bucket_quantum=8,
    )
    prep = pbatch.PreparedBatch(pairs, S, (beta, gamma, delta),
                                affine=True, bucket_quantum=8)
    got = prep.scores()
    assert (got == want).all()
    # second call reuses the cached device arrays
    assert (prep.scores() == want).all()
    # and score_batch accepts the prepared object directly
    assert (pbatch.score_batch(prep, S, (beta, gamma, delta),
                               affine=True) == want).all()
    # conflicting engine / bucket_quantum must fail loudly, like the
    # stale-parameter policy (a PreparedBatch bakes in its engine and
    # its bucketing)
    assert prep.engine == "xla"          # the CPU's choice
    with pytest.raises(ValueError, match="engine"):
        pbatch.score_batch(prep, S, (beta, gamma, delta), affine=True,
                           engine="cuda")
    with pytest.raises(ValueError, match="bucket_quantum"):
        pbatch.score_batch(prep, S, (beta, gamma, delta), affine=True,
                           bucket_quantum=16)
    # matching explicit values are a cache hit, not a conflict
    assert (pbatch.score_batch(prep, S, (beta, gamma, delta),
                               affine=True, engine="xla",
                               bucket_quantum=8) == want).all()


def test_prepared_batch_sharded(pairs):
    S, beta, gamma, delta = 1, -150, -50, -150
    devices = np.array(jax.devices())
    mesh = Mesh(devices, ("data",))
    want = _oracle_scores(pairs, S, beta, gamma, delta, True)
    prep = pbatch.PreparedBatch(pairs, S, (beta, gamma, delta),
                                affine=True, mesh=mesh, bucket_quantum=16)
    assert (prep.scores() == want).all()


def test_align_batch_sharded_bit_exact(pairs):
    """Sharded alignments: fused fill+walk under shard_map over an
    8-device data mesh == per-pair host walk."""
    S, beta, gamma, delta = 1, -150, -50, -150
    devices = np.array(jax.devices())
    mesh = Mesh(devices, ("data",))
    want_scores = _oracle_scores(pairs, S, beta, gamma, delta, True)
    want_traces, want_comps = _oracle_traces(pairs, S, beta, gamma,
                                             delta, True)
    scores, traces, comps = pbatch.align_batch(
        pairs, S, (beta, gamma, delta), affine=True, mesh=mesh,
        bucket_quantum=16,
    )
    assert (scores == want_scores).all()
    assert comps == want_comps
    for got, want in zip(traces, want_traces):
        assert got == want


@pytest.mark.parametrize("S", [0, 3])
def test_align_batch_shift_extremes(S):
    """align_batch parity at max_shift 0 (degenerate band) and 3 (wide
    band) — the walk and band layouts must agree across W."""
    rng = np.random.default_rng(5 + S)
    pairs = [_rand_pair(rng, 5 + i, 6 + (i % 3)) for i in range(6)]
    beta, gamma, delta = -150, -50, -150
    want_scores = _oracle_scores(pairs, S, beta, gamma, delta, True)
    want_traces, want_comps = _oracle_traces(pairs, S, beta, gamma,
                                             delta, True)
    scores, traces, comps = pbatch.align_batch(
        pairs, S, (beta, gamma, delta), affine=True, bucket_quantum=8
    )
    assert (scores == want_scores).all()
    assert comps == want_comps
    for got, want in zip(traces, want_traces):
        assert got == want


def test_align_batch_empty():
    scores, traces, comps = pbatch.align_batch(
        [], 1, (-150, -50, -150), affine=True
    )
    assert len(scores) == 0 and traces == [] and comps == []


def test_batch_int32_overflow_guard():
    """Unsafe scoring magnitudes must raise, not silently wrap (the
    batched engines have no int64 twin)."""
    n = m = 8
    mu1 = np.full((n + 1, m + 1), 2_000_000, dtype=np.int32)
    mu2 = np.full((n + 1, m + 1), 2_000_000, dtype=np.int32)
    big = (-20_000_000, -2_000_000, -2_000_000)
    for engine in ("auto", "xla", "cuda"):
        with pytest.raises(ValueError, match="int32"):
            pbatch.score_batch([(mu1, mu2)], 1, big, affine=True,
                               bucket_quantum=8, engine=engine)
    with pytest.raises(ValueError, match="int32"):
        pbatch.PreparedBatch([(mu1, mu2)], 1, big, affine=True,
                             bucket_quantum=8)
    with pytest.raises(ValueError, match="int32"):
        pbatch.align_batch([(mu1, mu2)], 1, big, affine=True,
                           bucket_quantum=8)


def test_align_batch_multi_sublane_bucket():
    """Pairs longer than 128 rows in one 192-row bucket: the batched
    band and walk vs the lone-pair device band and walk."""
    rng = np.random.default_rng(17)
    pairs = [_rand_pair(rng, 130 + i, 131 - i) for i in range(2)]
    S, beta, gamma, delta = 1, -150, -50, -150
    scores, traces, comps = pbatch.align_batch(
        pairs, S, (beta, gamma, delta), affine=True, bucket_quantum=64
    )
    from bialign_tpu.ops import xla_dp
    from bialign_tpu.ops import device_traceback as dtb

    for (mu1, mu2), sc, tr, comp in zip(pairs, scores, traces, comps):
        band = xla_dp.fill_affine_device(mu1, mu2, S, beta, gamma, delta)
        want_tr, want_comp = dtb.affine_traceback(band, beta, gamma,
                                                  delta, mu1, mu2)
        assert sc == band.final_score()
        assert tr == want_tr
        assert comp == want_comp


def test_prepared_batch_arg_mismatch_raises(pairs):
    """score_batch(PreparedBatch) must reject drifted arguments instead
    of silently returning stale-parameter scores (review r4)."""
    prep = pbatch.PreparedBatch(pairs, 1, (-150, -50, -150), affine=True,
                                bucket_quantum=8)
    with pytest.raises(ValueError, match="PreparedBatch"):
        pbatch.score_batch(prep, 2, (-150, -50, -150), affine=True)
    with pytest.raises(ValueError, match="PreparedBatch"):
        pbatch.score_batch(prep, 1, (-200, -80, -200), affine=True)


def test_ms0_batched_matches_oracle():
    """max_shift 0 batched scoring and alignments vs the per-pair
    oracle."""
    rng = np.random.default_rng(23)
    pairs = [_rand_pair(rng, 5 + (i % 4), 6 + (i % 3)) for i in range(16)]
    beta, gamma, delta = -150, -50, -150
    want = _oracle_scores(pairs, 0, beta, gamma, delta, True)
    got = pbatch.score_batch(
        pairs, 0, (beta, gamma, delta), affine=True, bucket_quantum=8,
    )
    assert (got == want).all(), (got, want)
    scores, _, _ = pbatch.align_batch(
        pairs, 0, (beta, gamma, delta), affine=True, bucket_quantum=8,
    )
    assert (scores == want).all()
