"""Seeded pair corpora for the smoke checks and the benchmark.

Nothing can be downloaded where these run, so every workload is made from
a seed: protein pairs are windows of the bundled DNA-Polymerase-1 pair
(sequence and CFSSP structure cut at the same offsets), and RNA pairs are
random sequences, the second a point-mutated copy of the first, each with
a random balanced dot-bracket structure.
"""

from __future__ import annotations

import random

from . import example_path


def dnapol_pair():
    """(seqA, strA, seqB, strB) of the bundled 928 x 933 aa pair."""
    from ..io.cfssp import read_molecule_from_file

    seqA, strA = read_molecule_from_file(
        example_path("DNAPolymerase1_Escherichia.cfssp"), "Protein")
    seqB, strB = read_molecule_from_file(
        example_path("DNAPolymerase1_Xanthomonas.cfssp"), "Protein")
    return seqA, strA, seqB, strB


def dnapol_windows(n_pairs: int, lo: int, hi: int, seed: int):
    """``n_pairs`` PairRecords: windows of lo..hi aa at random offsets
    of the DNA-Pol pair, the B window within 8 residues of A's length."""
    from ..parallel.driver import PairRecord

    seqA, strA, seqB, strB = dnapol_pair()
    rng = random.Random(seed)
    out = []
    for k in range(n_pairs):
        la = rng.randint(lo, hi)
        lb = min(max(lo, la + rng.randint(-8, 8)), hi)
        a0 = rng.randint(0, len(seqA) - la)
        b0 = rng.randint(0, len(seqB) - lb)
        out.append(PairRecord(
            id=f"p{k}", seqA=seqA[a0:a0 + la], seqB=seqB[b0:b0 + lb],
            strA=strA[a0:a0 + la], strB=strB[b0:b0 + lb],
        ))
    return out


def random_dotbracket(rng: random.Random, length: int) -> str:
    """A balanced dot-bracket string with hairpin loops of >= 3 bases,
    except where the end of the string forces the open pairs shut."""
    out = ["."] * length
    stack: list = []
    for i in range(length):
        left = length - i
        if stack and (left <= len(stack)
                      or (i - stack[-1] > 3 and rng.random() < 0.35)):
            out[stack.pop()] = "("
            out[i] = ")"
        elif left > len(stack) + 4 and rng.random() < 0.25:
            stack.append(i)
    return "".join(out)


def rna_pairs(n_pairs: int, lo: int, hi: int, seed: int,
              identity: float = 0.7):
    """``n_pairs`` RNA PairRecords of lo..hi nt: B is A with each base
    kept with probability ``identity`` (else substituted) and a few
    single-base indels; structures are independent random dot-brackets."""
    from ..parallel.driver import PairRecord

    rng = random.Random(seed)
    out = []
    for k in range(n_pairs):
        la = rng.randint(lo, hi)
        a = [rng.choice("ACGU") for _ in range(la)]
        b = [c if rng.random() < identity else rng.choice("ACGU")
             for c in a]
        for _ in range(rng.randint(0, 4)):
            pos = rng.randrange(len(b))
            if rng.random() < 0.5 and len(b) > lo:
                del b[pos]
            elif len(b) < hi:
                b.insert(pos, rng.choice("ACGU"))
        out.append(PairRecord(
            id=f"r{k}", seqA="".join(a), seqB="".join(b),
            strA=random_dotbracket(rng, len(a)),
            strB=random_dotbracket(rng, len(b)),
        ))
    return out
