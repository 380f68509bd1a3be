"""Golden parity tests against the reference README / SURVEY.md §8 outputs."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
import golden as G

from bialign_tpu import BiAligner

from bialign_tpu.ops import native_dp

# "auto" is the platform's choice (xla on the CPU test tier)
ENGINES = ["numpy", "xla", "auto"]
if native_dp.available():
    ENGINES.append("native")


@pytest.mark.parametrize("engine", ENGINES)
def test_toy_rna_affine_score_and_default(engine):
    ba = BiAligner(
        G.TOY_RNA["seqA"], G.TOY_RNA["seqB"],
        G.TOY_RNA["strA"], G.TOY_RNA["strB"],
        engine=engine, **G.TOY_RNA_AFFINE_PARAMS,
    )
    assert ba.optimize() == G.TOY_RNA_AFFINE_SCORE
    assert ba.decode_trace() == G.TOY_RNA_AFFINE_DEFAULT_OUT


@pytest.mark.parametrize("engine", ENGINES)
def test_toy_rna_affine_full(engine):
    params = dict(G.TOY_RNA_AFFINE_PARAMS, outmode="full")
    ba = BiAligner(
        G.TOY_RNA["seqA"], G.TOY_RNA["seqB"],
        G.TOY_RNA["strA"], G.TOY_RNA["strB"],
        engine=engine, **params,
    )
    assert ba.optimize() == G.TOY_RNA_AFFINE_SCORE
    assert ba.decode_trace() == G.TOY_RNA_AFFINE_FULL_OUT


@pytest.mark.parametrize("engine", ENGINES)
def test_toy_rna_nonaffine(engine):
    ba = BiAligner(
        G.TOY_RNA["seqA"], G.TOY_RNA["seqB"],
        G.TOY_RNA["strA"], G.TOY_RNA["strB"],
        engine=engine, **G.TOY_RNA_NONAFFINE_PARAMS,
    )
    assert ba.optimize() == G.TOY_RNA_NONAFFINE_SCORE
    assert ba.decode_trace() == G.TOY_RNA_NONAFFINE_DEFAULT_OUT


@pytest.mark.parametrize("engine", ENGINES)
def test_toy_protein_sorted(engine):
    ba = BiAligner(
        G.TOY_PROTEIN["seqA"], G.TOY_PROTEIN["seqB"],
        G.TOY_PROTEIN["strA"], G.TOY_PROTEIN["strB"],
        engine=engine, **G.TOY_PROTEIN_PARAMS,
    )
    assert ba.optimize() == G.TOY_PROTEIN_SCORE
    assert ba.decode_trace() == G.TOY_PROTEIN_SORTED_OUT


def test_cli_toy_rna(capsys):
    from bialign_tpu.cli import main

    main([
        G.TOY_RNA["seqA"], G.TOY_RNA["seqB"],
        "--strA", G.TOY_RNA["strA"], "--strB", G.TOY_RNA["strB"],
        "--structure", "400",  # argparse prefix of --structure_weight
        "--gap_opening_cost", "-200", "--gap_cost", "-50",
        "--max_shift", "1", "--shift_cost", "-150",
        "--engine", "numpy",
    ])
    out = capsys.readouterr().out.splitlines()
    expected = [
        "Input:",
        "seqA\t " + G.TOY_RNA["seqA"],
        "seqB\t " + G.TOY_RNA["seqB"],
        "strA\t " + G.TOY_RNA["strA"],
        "strB\t " + G.TOY_RNA["strB"],
        "SCORE: 6800",
        "",
    ] + G.TOY_RNA_AFFINE_DEFAULT_OUT
    assert out == expected
