"""Build and execute Notebooks/figures.ipynb (counterpart of the
reference Notebooks/figures.ipynb: the manuscript figures — introductory
toy example plus the DNA-Polymerase-1 pair at max_shift 0/1/2, each
rendered with the alignment plotter and written as SVG).  Run from the
repo root."""

import nbformat as nbf
from nbclient import NotebookClient

nb = nbf.v4.new_notebook()
cells = []


def md(src):
    cells.append(nbf.v4.new_markdown_cell(src))


def code(src):
    cells.append(nbf.v4.new_code_cell(src))


md("""# Affine protein bi-alignment — manuscript figures

Counterpart of the reference `Notebooks/figures.ipynb` (figures for
*"Bi-Alignments with Affine Gap Costs"*): the introductory toy-protein
example and the DNA-Polymerase-1 pair at `max_shift` 0, 1, 2, each
rendered with `bialign_tpu.render.plot.plot_alignment` (helix/sheet
glyphs, boxed shift columns, red/blue incongruence rails) and saved as
SVG under `Notebooks/Figs/`.

The reference fills the DNA-Pol-1 band in 26.2 s / 626.7 s / 2201.0 s at
max_shift 0/1/2 (its `bialign.ipynb` cell 5); here every fill runs on the
wavefront engine (the platform's choice of CUDA kernel or XLA scan).""")

code("""import os

# honor a JAX_PLATFORMS override (e.g. cpu) before any backend init
from bialign_tpu.utils.jaxconfig import ensure_compile_cache
ensure_compile_cache()

import time

from bialign_tpu import BiAligner
from bialign_tpu.render.plot import plot_alignment, breaklines
from bialign_tpu.io.cfssp import read_molecule_from_file
from bialign_tpu.data import example_path

figuresdir = os.path.join(
    "Notebooks" if os.path.isdir("Notebooks") else ".", "Figs")
os.makedirs(figuresdir, exist_ok=True)""")

md("""## Introductory example

The manuscript's toy protein pair (reference figures.ipynb cell 3):
affine gaps, shift cost −210, structure weight 800, BLOSUM62.""")

code("""args = dict(type="Protein", gap_cost=-50, gap_opening_cost=-200,
            shift_cost=-210, structure_weight=800, max_shift=1,
            simmatrix="BLOSUM62", nameA="A", nameB="B")

seqA = "RAKLPLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYARFR"
strA = "CHHHHHHHHHHHHHCCCCTCEEEEEEECCTCEEEEEEEECCC"
seqB = "KAKLPLKEKKLTRTANYHPGIRYIMTGYSAKRIYSSTYAYFR"
strB = "HHHHHHHHHHHHCCCCCCTCEEEEEEECCCCCEEEEEEEECC"

ba = BiAligner(seqA, seqB, strA, strB, **args)
print("SCORE:", ba.optimize())
intro_lines = list(ba.decode_trace_full())
for name, line in intro_lines[:6]:
    print(f"{name:14} {line}")""")

code("""plot_alignment(intro_lines, 60,
               outname=os.path.join(figuresdir, "intro-example.svg"))""")

md("""## DNA Polymerase 1 (E. coli vs Xanthomonas, 928 × 933 aa)

The manuscript's main case study (reference figures.ipynb cells 5-9):
the full CFSSP pair at `max_shift` 0, 1, 2 with the same parameters.""")

code("""seqA, strA = read_molecule_from_file(
    example_path("DNAPolymerase1_Escherichia.cfssp"), "Protein")
seqB, strB = read_molecule_from_file(
    example_path("DNAPolymerase1_Xanthomonas.cfssp"), "Protein")
args.update(nameA="Ecoli", nameB="Xanthomonas")

stored_alilines = {}
for ms in range(3):
    args["max_shift"] = ms
    bialigner = BiAligner(seqA, seqB, strA, strB, **args)
    t0 = time.perf_counter()
    score = bialigner.optimize()
    dt = time.perf_counter() - t0
    stored_alilines[f"max_shift {ms}"] = list(
        bialigner.decode_trace_full())
    ref_s = {0: 26.2, 1: 626.7, 2: 2201.0}[ms]
    print(f"max_shift {ms}: SCORE {score}  fill+score {dt:.2f} s "
          f"(reference Cython: {ref_s} s)")""")

md("""### Blockwise text rendering

`breaklines` splits the alignment into 80-column blocks (reference
figures.ipynb cell 8).""")

code("""alilines = stored_alilines["max_shift 2"]
aliblocks = breaklines(alilines, 80)
for i, (name, aliline) in enumerate(aliblocks[0]):
    print(f"{i:2} {name:18} {aliline}")""")

md("""### Figure SVGs

One figure per `max_shift`, matching the reference's
`dnapoly1-ms{s}-sc-210-sw800.svg` outputs (shift boxes appear at the
columns where the two alignment copies disagree; incongruence rails
count the net shift).""")

code("""for s in range(3):
    alilines = stored_alilines[f"max_shift {s}"]
    plot_alignment(
        alilines, 80,
        outname=os.path.join(figuresdir,
                             f"dnapoly1-ms{s}-sc-210-sw800.svg"))""")

nb["cells"] = cells
nb["metadata"]["kernelspec"] = {
    "name": "python3", "display_name": "Python 3", "language": "python",
}

client = NotebookClient(nb, timeout=3600)
client.execute()

nbf.write(nb, "Notebooks/figures.ipynb")
print("wrote Notebooks/figures.ipynb")
