"""DNA-Polymerase-1 CFSSP example: file-input path + long-protein anchor.

SCORE anchors measured from the reference algorithm (SURVEY.md §8 /
BASELINE.md): prefix-150 with gap -200/-50, shift -210, sw 800, ms 1
scores 117180.
"""

import pytest

from bialign_tpu import BiAligner
from bialign_tpu.io.cfssp import read_molecule_from_file

from bialign_tpu.data import example_path

PARAMS = dict(
    type="Protein",
    shift_cost=-210,
    structure_weight=800,
    simmatrix="BLOSUM62",
    gap_opening_cost=-200,
    gap_cost=-50,
    max_shift=1,
)


@pytest.fixture(scope="module")
def dnapol():
    seqA, strA = read_molecule_from_file(
        example_path("DNAPolymerase1_Escherichia.cfssp"), "Protein"
    )
    seqB, strB = read_molecule_from_file(
        example_path("DNAPolymerase1_Xanthomonas.cfssp"), "Protein"
    )
    return seqA, seqB, strA, strB


def test_cfssp_lengths(dnapol):
    seqA, seqB, strA, strB = dnapol
    assert len(seqA) == len(strA) == 928
    assert len(seqB) == len(strB) == 933


def test_dnapol_prefix150_score(dnapol):
    seqA, seqB, strA, strB = dnapol
    ba = BiAligner(
        seqA[:150], seqB[:150], strA[:150], strB[:150],
        engine="xla", **PARAMS,
    )
    assert ba.optimize() == 117180
    # property check: re-scoring the decoded trace reproduces the score
    lines = list(ba.eval_trace())
    assert lines[-1].split(" --> ")[-1] == "117180"


import hashlib
import os

FULL_MD5 = {
    "A": "4f49c3ed126e81d65bc13e6b963384fd",
    "B": "cf1a0953be5d5fffa9eb8a63e03aed51",
    "A ss": "755f0f228092a86aaf2458b7962b6c7b",
    "B ss": "89a56b820328ee1e1ed80c4f10370c49",
    "A shifts": "d5c459dce9c5e48d2eca62e1851e053a",
    "B shifts": "57bc03db8fe01bdfa4fdc169078679de",
}


@pytest.mark.skipif(
    not os.environ.get("BIALIGN_SLOW_TESTS"),
    reason="full 928x933 pair; set BIALIGN_SLOW_TESTS=1 (chip_smoke.py "
    "checks SCORE 761500 and every md5 anchor on the GPU)",
)
def test_dnapol_full_md5(dnapol):
    """Full-pair parity: SCORE 761500 + SURVEY.md §8 per-row md5 anchors."""
    seqA, seqB, strA, strB = dnapol
    ba = BiAligner(
        seqA, seqB, strA, strB, engine="xla",
        type="Protein", shift_cost=-150, structure_weight=800,
        simmatrix="BLOSUM62", gap_opening_cost=-150, gap_cost=-50,
        max_shift=1,
    )
    assert ba.optimize() == 761500
    for line in ba.decode_trace():
        name = line[:16].rstrip()
        body = line[16:]
        assert hashlib.md5(body.encode()).hexdigest() == FULL_MD5[name], name
