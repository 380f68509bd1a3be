"""Codes-input serving path and the device table builders.

The codes path ships O(n) code vectors and one LUT and builds the score
tables on the device (ops/device_tables.py); these tests pin it against
the per-pair BiAligner (scores and traces, with and without a mesh), the
builders' shear and shift primitives against their index definitions,
and the guards that keep the f32 LUT contraction exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bialign_tpu.ops import device_tables
from bialign_tpu.parallel import batch as pbatch
from bialign_tpu.parallel.driver import PairRecord, StreamingAligner

AFF = (-150, -50, -150)


def _rand_pair(rng, n, m):
    mu1 = rng.integers(-300, 900, (n + 1, m + 1)).astype(np.int32)
    mu2 = rng.integers(0, 800, (n + 1, m + 1)).astype(np.int32)
    mu1[0, :] = 0
    mu1[:, 0] = 0
    mu2[0, :] = 0
    mu2[:, 0] = 0
    return mu1, mu2


def test_skew_and_shift_primitives():
    """_skew (pad+reshape shear) and _shifted against their index
    definitions — these carry every gather-free table build."""
    rng = np.random.default_rng(2)
    a = rng.integers(-50, 50, (5, 7)).astype(np.int32)
    for D_pad in (7, 9, 16, 30):
        got = np.asarray(device_tables.skew(jnp.asarray(a), D_pad))
        assert got.shape == (5, D_pad)
        for i in range(5):
            for d in range(D_pad):
                want = a[i, d - i] if 0 <= d - i < 7 else 0
                assert got[i, d] == want, (i, d)
    for dk in (-2, 0, 1):
        for dl in (-1, 0, 2):
            got = np.asarray(device_tables.shifted(jnp.asarray(a), dk, dl))
            for i in range(5):
                for j in range(7):
                    want = (a[i + dk, j + dl]
                            if 0 <= i + dk < 5 and 0 <= j + dl < 7
                            else 0)
                    assert got[i, j] == want, (dk, dl, i, j)


@pytest.mark.parametrize("S", [0, 1, 2])
def test_diag_tables_match_host_builder(S):
    """The device diagonal-table build equals the host numpy build on
    every cell a genuine lattice row reads (0 <= j <= m)."""
    from bialign_tpu.ops import xla_dp

    rng = np.random.default_rng(50 + S)
    mu1, mu2 = _rand_pair(rng, 9, 13)
    n, m = 9, 13
    D = n + m + 1
    h1, h2 = (np.asarray(t) for t in xla_dp._diag_mu_tables(mu1, mu2, S))
    d1, d2 = (np.asarray(t) for t in device_tables.diag_tables(
        jnp.asarray(mu1), jnp.asarray(mu2), S, D))
    assert d1.shape == h1.shape and d2.shape == h2.shape
    d_ = np.arange(D)[:, None]
    i_ = np.arange(n + 1)[None, :]
    live = (d_ - i_ >= 0) & (d_ - i_ <= m)
    assert (d1[live] == h1[live]).all()
    assert (d2[live] == h2[live]).all()


@pytest.mark.parametrize("S", [0, 2])
def test_codes_scores_shift_extremes_both_recurrences(S):
    """Codes-path scores at max_shift 0 and 2, affine and non-affine, vs
    the oracle on the host-built tables."""
    import random

    from bialign_tpu import BiAligner

    recs = _protein_records(random.Random(20 + S), 5)
    for params in (dict(PARAMS, max_shift=S),
                   dict(PARAMS, max_shift=S, gap_opening_cost=0)):
        sa = StreamingAligner(params, chunk_pairs=5, bucket_quantum=8,
                              codes=True)
        got = dict(sa.run(iter(recs)))
        for r in recs:
            ba = BiAligner(r.seqA, r.seqB, r.strA, r.strB, engine="numpy",
                           **params)
            assert got[r.id] == ba.optimize(), (S, r.id)


def test_codes_scores_match_tables_path():
    """dispatch_score_batch_codes on 100-160 aa DNA-Pol windows == the
    tables-input score_batch on host-built tables."""
    import random

    from bialign_tpu.data import example_path
    from bialign_tpu.io.cfssp import read_molecule_from_file
    from bialign_tpu.models.molecule import preprocess_molecule
    from bialign_tpu.scoring.tables import _sim_lut, build_score_tables

    sA, tA = read_molecule_from_file(
        example_path("DNAPolymerase1_Escherichia.cfssp"), "Protein")
    sB, tB = read_molecule_from_file(
        example_path("DNAPolymerase1_Xanthomonas.cfssp"), "Protein")
    rng = random.Random(9)
    params = dict(PARAMS)
    pairs, tables = [], []
    for _ in range(3):
        la = rng.randint(100, 160)
        a0 = rng.randint(0, len(sA) - la)
        lb = la + rng.randint(-8, 8)
        b0 = rng.randint(0, len(sB) - lb)
        a, sa_ = sA[a0:a0 + la], tA[a0:a0 + la]
        b, sb_ = sB[b0:b0 + lb], tB[b0:b0 + lb]
        pairs.append(pbatch.encode_pair(a, b, sa_, sb_))
        tables.append(build_score_tables(
            preprocess_molecule(a, sa_, is_rna=False),
            preprocess_molecule(b, sb_, is_rna=False), params,
            is_rna=False))
    lut, _ = _sim_lut("BLOSUM62")
    got = pbatch.dispatch_score_batch_codes(
        pairs, 1, AFF, affine=True, lut=lut, structure_weight=800).get()
    want = pbatch.score_batch(tables, 1, AFF, affine=True)
    assert (got == want).all(), (got, want)


def _protein_records(rng, k, lo=6, hi=14):
    alpha = "ARNDCQEGHILKMFPSTWYV"
    ss = "CHET"
    out = []
    for i in range(k):
        la = rng.randint(lo, hi)
        lb = rng.randint(lo, hi)
        out.append(PairRecord(
            id=f"p{i}",
            seqA="".join(rng.choice(alpha) for _ in range(la)),
            seqB="".join(rng.choice(alpha) for _ in range(lb)),
            strA="".join(rng.choice(ss) for _ in range(la)),
            strB="".join(rng.choice(ss) for _ in range(lb)),
        ))
    return out


PARAMS = dict(type="Protein", structure_weight=800, simmatrix="BLOSUM62",
              gap_opening_cost=-150, gap_cost=-50, shift_cost=-150,
              max_shift=1)


def test_codes_path_matches_bialigner():
    """The streaming driver's codes path (device LUT table build) is
    bit-exact vs the per-pair BiAligner, scores AND traces."""
    import random

    from bialign_tpu import BiAligner

    recs = _protein_records(random.Random(3), 8)
    sa = StreamingAligner(PARAMS, chunk_pairs=4, bucket_quantum=8,
                          alignments=True, codes=True)
    assert sa._codes_lut is not None, "codes path should be active"
    got = {i: (s, t) for i, s, t in sa.run(iter(recs))}
    for r in recs:
        ba = BiAligner(r.seqA, r.seqB, r.strA, r.strB, engine="numpy",
                       **PARAMS)
        assert got[r.id][0] == ba.optimize()
        assert got[r.id][1] == ba.traceback()


def test_codes_path_match_mismatch_and_keyerror():
    import random

    from bialign_tpu import BiAligner

    p2 = dict(PARAMS, simmatrix=None)
    recs = _protein_records(random.Random(5), 4)
    sa = StreamingAligner(p2, chunk_pairs=4, bucket_quantum=8,
                          codes=True)
    assert sa._codes_lut is not None
    got = dict(sa.run(iter(recs)))
    for r in recs:
        ba = BiAligner(r.seqA, r.seqB, r.strA, r.strB, engine="numpy",
                       **p2)
        assert got[r.id] == ba.optimize()

    # unknown residue raises KeyError like the reference's dict access
    sa2 = StreamingAligner(PARAMS, chunk_pairs=4, codes=True)
    bad = [PairRecord(id="bad", seqA="AX?", seqB="ARN", strA="CCC",
                      strB="CCC")]
    with pytest.raises(KeyError):
        list(sa2.run(iter(bad)))


def test_codes_path_sharded_mesh():
    """Codes dispatchers under an 8-device data mesh: scores AND traces
    bit-exact vs the per-pair oracle."""
    import random

    from jax.sharding import Mesh

    from bialign_tpu import BiAligner

    devices = np.array(jax.devices())
    mesh = Mesh(devices, ("data",))
    recs = _protein_records(random.Random(13), 10)
    sa = StreamingAligner(PARAMS, chunk_pairs=5, bucket_quantum=8,
                          mesh=mesh, alignments=True, codes=True)
    assert sa._codes_lut is not None
    got = {i: (s, t) for i, s, t in sa.run(iter(recs))}
    for r in recs:
        ba = BiAligner(r.seqA, r.seqB, r.strA, r.strB, engine="numpy",
                       **PARAMS)
        assert got[r.id][0] == ba.optimize()
        assert got[r.id][1] == ba.traceback()
    sa2 = StreamingAligner(PARAMS, chunk_pairs=5, bucket_quantum=8,
                           mesh=mesh, codes=True)
    got2 = dict(sa2.run(iter(recs)))
    for r in recs:
        assert got2[r.id] == got[r.id][0]


def test_codes_path_rejects_f32_unsafe_lut():
    """LUT values >= 2^24 would break the one-hot f32 contraction's
    exactness — the codes dispatch must refuse them loudly."""
    lut = pbatch.match_mismatch_lut(1 << 24, 0)
    pairs = [pbatch.encode_pair("AR", "AR", "CC", "CC")]
    with pytest.raises(ValueError, match="2\\^24"):
        pbatch.dispatch_score_batch_codes(
            pairs, 1, AFF, affine=True, lut=lut, structure_weight=100)


def test_rna_stream_keeps_host_tables():
    """RNA streams must NOT take the codes path (float64 mu2 parity)."""
    p = dict(type="RNA", structure_weight=400, gap_opening_cost=-200,
             gap_cost=-50, shift_cost=-150, max_shift=1)
    sa = StreamingAligner(p, chunk_pairs=4)
    assert sa._codes_lut is None
