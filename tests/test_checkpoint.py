"""Checkpointed (linear-memory) fill + rematerializing traceback parity.

The checkpoint path must be bit-exact with the oracle: identical score,
identical trace (same co-optimal tie-breaking), identical decoded
alignment — for affine and non-affine, RNA and protein, across block
sizes including degenerate ones (single block covering the whole band,
and tiny blocks forcing many rematerializations).
"""

import numpy as np
import pytest

from bialign_tpu import BiAligner
from bialign_tpu.ops import checkpoint_dp

from golden import (
    TOY_RNA,
    TOY_RNA_AFFINE_PARAMS,
    TOY_RNA_AFFINE_SCORE,
    TOY_RNA_NONAFFINE_PARAMS,
    TOY_RNA_NONAFFINE_SCORE,
    TOY_PROTEIN,
    TOY_PROTEIN_PARAMS,
    TOY_PROTEIN_SCORE,
)


def _aligner(mol, params, **extra):
    return BiAligner(mol["seqA"], mol["seqB"], mol.get("strA"),
                     mol.get("strB"), **params, **extra)


def _lines(ba):
    return list(ba.decode_trace())


@pytest.mark.parametrize("block", [None, 4, 7, 1000])
def test_affine_rna_checkpoint_parity(block):
    ref = _aligner(TOY_RNA, TOY_RNA_AFFINE_PARAMS, engine="numpy")
    ck = _aligner(TOY_RNA, TOY_RNA_AFFINE_PARAMS, engine="xla",
                  lowmem=True, checkpoint_block=block)
    assert ref.optimize() == TOY_RNA_AFFINE_SCORE
    assert ck.optimize() == TOY_RNA_AFFINE_SCORE
    assert ck.traceback() == ref.traceback()
    assert _lines(ck) == _lines(ref)


@pytest.mark.parametrize("block", [None, 5])
def test_nonaffine_rna_checkpoint_parity(block):
    ref = _aligner(TOY_RNA, TOY_RNA_NONAFFINE_PARAMS, engine="numpy")
    ck = _aligner(TOY_RNA, TOY_RNA_NONAFFINE_PARAMS, engine="xla",
                  lowmem=True, checkpoint_block=block)
    assert ref.optimize() == TOY_RNA_NONAFFINE_SCORE
    assert ck.optimize() == TOY_RNA_NONAFFINE_SCORE
    assert ck.traceback() == ref.traceback()
    assert _lines(ck) == _lines(ref)


def test_affine_protein_checkpoint_parity():
    ref = _aligner(TOY_PROTEIN, TOY_PROTEIN_PARAMS, engine="numpy")
    ck = _aligner(TOY_PROTEIN, TOY_PROTEIN_PARAMS, engine="xla",
                  lowmem=True)
    assert ck.optimize() == TOY_PROTEIN_SCORE
    assert ck.traceback() == ref.traceback()
    assert _lines(ck) == _lines(ref)


def test_nonaffine_eval_trace_via_checkpoint_cells():
    """The verbose evaluator reads band cells through block recompute."""
    ref = _aligner(TOY_RNA, TOY_RNA_NONAFFINE_PARAMS, engine="numpy")
    ck = _aligner(TOY_RNA, TOY_RNA_NONAFFINE_PARAMS, engine="xla",
                  lowmem=True, checkpoint_block=6)
    ck.optimize()
    ref.optimize()
    assert list(ck.eval_trace()) == list(ref.eval_trace())


def test_checkpoint_memory_is_sublinear():
    """The stored arrays must be O(sqrt(D)) slabs, not O(D)."""
    ba = _aligner(TOY_RNA, TOY_RNA_AFFINE_PARAMS, engine="xla",
                  lowmem=True)
    ba.optimize()
    cb = ba._H
    assert isinstance(cb, checkpoint_dp.CheckpointBand)
    n, m = cb.n, cb.m
    D = n + m + 1
    NB = cb.ckpts.shape[0]
    # full band would be D slabs; checkpoints store 2*NB (+1 final)
    assert 2 * NB + 1 < D
    assert cb.block >= checkpoint_dp.default_block(D) or cb.block >= 8


def test_default_block_scaling():
    assert checkpoint_dp.default_block(8) == 8
    assert checkpoint_dp.default_block(1862) == 62


def test_lowmem_unsupported_engine_warns():
    """lowmem=True with a non-JAX engine warns instead of silently
    ignoring the request (ADVICE r2)."""
    ba = _aligner(TOY_RNA, TOY_RNA_AFFINE_PARAMS, engine="numpy",
                  lowmem=True)
    with pytest.warns(RuntimeWarning, match="lowmem"):
        score = ba.optimize()
    assert score == TOY_RNA_AFFINE_SCORE


# -- lowmem under the CUDA engine ---------------------------------------------
#
# The kernel has no checkpoint mode: lowmem with engine="cuda" runs the
# XLA checkpoint scan, so these run on any backend.

@pytest.mark.parametrize("block", [None, 40])
def test_affine_rna_cuda_engine_lowmem_parity(block):
    ref = _aligner(TOY_RNA, TOY_RNA_AFFINE_PARAMS, engine="numpy")
    ck = _aligner(TOY_RNA, TOY_RNA_AFFINE_PARAMS, engine="cuda",
                  lowmem=True, checkpoint_block=block)
    assert ref.optimize() == TOY_RNA_AFFINE_SCORE
    assert ck.optimize() == TOY_RNA_AFFINE_SCORE
    assert isinstance(ck._H, checkpoint_dp.CheckpointBand)
    assert ck.traceback() == ref.traceback()
    assert _lines(ck) == _lines(ref)


def test_nonaffine_rna_cuda_engine_lowmem_parity():
    ref = _aligner(TOY_RNA, TOY_RNA_NONAFFINE_PARAMS, engine="numpy")
    ck = _aligner(TOY_RNA, TOY_RNA_NONAFFINE_PARAMS, engine="cuda",
                  lowmem=True)
    assert ck.optimize() == TOY_RNA_NONAFFINE_SCORE
    assert isinstance(ck._H, checkpoint_dp.CheckpointBand)
    assert ck.traceback() == ref.traceback()
    assert _lines(ck) == _lines(ref)


def test_affine_protein_cuda_engine_lowmem_parity():
    ref = _aligner(TOY_PROTEIN, TOY_PROTEIN_PARAMS, engine="numpy")
    ck = _aligner(TOY_PROTEIN, TOY_PROTEIN_PARAMS, engine="cuda",
                  lowmem=True)
    assert ck.optimize() == TOY_PROTEIN_SCORE
    assert ck.traceback() == ref.traceback()
    assert _lines(ck) == _lines(ref)


def test_nonaffine_eval_trace_via_cuda_engine_lowmem_cells():
    """Verbose evaluator reads cells through the XLA block remat."""
    ref = _aligner(TOY_RNA, TOY_RNA_NONAFFINE_PARAMS, engine="numpy")
    ck = _aligner(TOY_RNA, TOY_RNA_NONAFFINE_PARAMS, engine="cuda",
                  lowmem=True)
    ck.optimize()
    ref.optimize()
    assert list(ck.eval_trace()) == list(ref.eval_trace())
