"""Tests for AlignConfig, DSSP/STRIDE readers, and matrix materialization."""

import pytest

from bialign_tpu import AlignConfig, BiAligner
from bialign_tpu.io.simmatrix import materialize_matrix, read_simmatrix
from bialign_tpu.io.structure_files import read_dssp, read_stride

from golden import TOY_RNA, TOY_RNA_AFFINE_SCORE


# -- AlignConfig ------------------------------------------------------------

def test_config_defaults_match_aligner_defaults():
    from bialign_tpu.aligner import PARAM_DEFAULTS

    cfg = AlignConfig()
    params = cfg.to_params()
    for key, val in PARAM_DEFAULTS.items():
        assert params[key] == val, key


def test_config_validation():
    with pytest.raises(ValueError):
        AlignConfig(type="DNA")
    with pytest.raises(ValueError):
        AlignConfig(max_shift=-1)
    with pytest.raises(ValueError):
        AlignConfig(engine="pallas")


def test_config_affine_property():
    assert not AlignConfig().affine
    assert AlignConfig(gap_opening_cost=-150).affine


def test_config_from_params_ignores_unknown():
    cfg = AlignConfig.from_params(
        {"max_shift": 1, "verbose": True, "fileinput": False}
    )
    assert cfg.max_shift == 1


def test_config_builds_working_aligner():
    cfg = AlignConfig(
        structure_weight=400, gap_opening_cost=-200, gap_cost=-50,
        shift_cost=-150, max_shift=1, engine="numpy",
    )
    ba = cfg.aligner(TOY_RNA["seqA"], TOY_RNA["seqB"],
                     TOY_RNA["strA"], TOY_RNA["strB"])
    assert ba.optimize() == TOY_RNA_AFFINE_SCORE


# -- materialize_matrix -----------------------------------------------------

def test_materialize_matrix_roundtrip(tmp_path):
    path = materialize_matrix("BLOSUM62", directory=str(tmp_path))
    assert read_simmatrix(path) == read_simmatrix("BLOSUM62")


def test_materialize_matrix_unknown():
    with pytest.raises(ValueError):
        materialize_matrix("PAM250")


# -- DSSP reader ------------------------------------------------------------

def _dssp_line(aa: str, ss: str, chain: str) -> str:
    # synthetic DSSP-4 wide data line: aa at col 13, ss at col 16,
    # auth chain at col 152, >=190 chars total
    line = [" "] * 195
    line[13] = aa
    line[16] = ss
    line[152] = chain
    return "".join(line)


DSSP_TEXT = "\n".join(
    [
        "==== Secondary Structure Definition ====",
        "  #  RESIDUE AA STRUCTURE BP1 BP2  ACC ...",
        _dssp_line("M", "H", "A"),
        _dssp_line("K", "H", "A"),
        _dssp_line("V", " ", "A"),
        _dssp_line("G", "E", "D"),
        _dssp_line("L", "E", "D"),
        "short line skipped",
    ]
)


def test_read_dssp_all_chains():
    res = read_dssp(DSSP_TEXT)
    assert res["seq"] == "MKVGL"
    assert res["str"] == "HHCEE"  # blank SS -> C


def test_read_dssp_chain_filter():
    res = read_dssp(DSSP_TEXT, chain="D")
    assert res["seq"] == "GL"
    assert res["str"] == "EE"


def test_read_dssp_ignores_preheader():
    res = read_dssp("no header at all\n" + _dssp_line("W", "H", "A"))
    assert res["seq"] == ""


# -- STRIDE reader ----------------------------------------------------------

STRIDE_TEXT = "\n".join(
    [
        "REM  --------------- stride output ---------------",
        "CHN  /tmp/x.pdb A",
        "SEQ  1    MKVLQ                                1",
        "STR       HHH E                                ",
        "CHN  /tmp/x.pdb D",
        "SEQ  1    GGG                                  1",
        "STR       TTT                                  ",
    ]
)


def _stride_records(seq: str, ss: str, chain: str, start: int = 1):
    end = start + len(seq) - 1
    pad = " " * (50 - 10 - len(seq))
    return [
        f"CHN  /tmp/x.pdb {chain}",
        f"SEQ  {start:<4} {seq}{pad}{end}",
        f"STR       {ss}{pad}",
    ]


def test_read_stride_chain_filter():
    text = "\n".join(
        _stride_records("MKVLQ", "HHH E", "A")
        + _stride_records("GGG", "TTT", "D")
    )
    res_a = read_stride(text, chain="A")
    assert res_a["seq"] == "MKVLQ"
    assert res_a["str"] == "HHHCE"
    res_d = read_stride(text, chain="D")
    assert res_d["seq"] == "GGG"
    assert res_d["str"] == "TTT"


def test_read_stride_all_chains_concatenates():
    text = "\n".join(
        _stride_records("MKV", "HHH", "A") + _stride_records("GG", "TT", "D")
    )
    res = read_stride(text)
    assert res["seq"] == "MKVGG"
    assert res["str"] == "HHHTT"


def test_stride_output_feeds_aligner():
    text = "\n".join(_stride_records("RAKLPLKEKKL", "CHHHHHHHHHH", "A"))
    mol = read_stride(text, chain="A")
    ba = BiAligner(
        mol["seq"], mol["seq"], mol["str"], mol["str"],
        type="Protein", simmatrix="BLOSUM62", structure_weight=800,
        gap_opening_cost=-150, gap_cost=-50, shift_cost=-150, max_shift=1,
        engine="numpy",
    )
    assert ba.optimize() > 0
