"""DNA-Polymerase-1 pipeline — the script counterpart of the reference's
``Notebooks/bialign.ipynb`` case study: CFSSP file input, full 928x933
affine alignment with the README CLI flags, timing, and plot output.

Run: python examples/dnapol_pipeline.py [engine] [out.svg]
(engine defaults to auto; minutes on a CPU, about 0.1 s of fill and walk
on one H100 — PERF.md.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

from bialign_tpu import BiAligner
from bialign_tpu.data import example_path
from bialign_tpu.io.cfssp import read_molecule_from_file
from bialign_tpu.utils.profiling import band_cells

engine = sys.argv[1] if len(sys.argv) > 1 else "auto"

seqA, strA = read_molecule_from_file(
    example_path("DNAPolymerase1_Escherichia.cfssp"), "Protein"
)
seqB, strB = read_molecule_from_file(
    example_path("DNAPolymerase1_Xanthomonas.cfssp"), "Protein"
)

t0 = time.perf_counter()
ba = BiAligner(
    seqA, seqB, strA, strB, engine=engine,
    type="Protein", shift_cost=-150, structure_weight=800,
    simmatrix="BLOSUM62", gap_opening_cost=-150, gap_cost=-50, max_shift=1,
)
score = ba.optimize()
dt = time.perf_counter() - t0
cells = band_cells(len(seqA), len(seqB), 1)
print(f"SCORE: {score}  (fill {dt:.2f}s, {cells / dt / 1e6:.1f}M 4D-cells/s)")
assert score == 761500

full = ba.decode_trace_full()
for line in ba.decode_trace():
    print(line[:100])

if len(sys.argv) > 2:
    from bialign_tpu.render.plot import plot_alignment

    plot_alignment(full, 120, outname=sys.argv[2])
    print("wrote", sys.argv[2])
