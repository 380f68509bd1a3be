"""Build and execute Notebooks/case_studies.ipynb (counterpart of the
reference Notebooks/bialign.ipynb: large-pair timings, DSSP/STRIDE
parsing, plotting case studies).  Run from the repo root."""

import nbformat as nbf
from nbclient import NotebookClient

nb = nbf.v4.new_notebook()
cells = []


def md(src):
    cells.append(nbf.v4.new_markdown_cell(src))


def code(src):
    cells.append(nbf.v4.new_code_cell(src))


md("""# bialign-tpu case studies

Counterpart of the reference `Notebooks/bialign.ipynb`: the DNA-Polymerase-1
pair at scale, engine timing comparisons, DSSP/STRIDE structure input, the
linear-memory band mode, and alignment plotting.""")

code("""import time

import numpy as np

from bialign_tpu import BiAligner, read_dssp, read_stride
from bialign_tpu.io.cfssp import read_molecule_from_file

from bialign_tpu.data import example_path
seqA, strA = read_molecule_from_file(
    example_path("DNAPolymerase1_Escherichia.cfssp"), "Protein")
seqB, strB = read_molecule_from_file(
    example_path("DNAPolymerase1_Xanthomonas.cfssp"), "Protein")
print(len(seqA), len(seqB))""")

md("""## DNA-Polymerase-1, full pair (928 x 933)

The reference Cython engine fills this band in **626.7 s** at max_shift 1
(its `bialign.ipynb` cell 5).  The wavefront engine (auto = the platform's
choice, see `bialign_tpu.backend`) fills and walks it in about 0.11 s on
one H100 (PERF.md); end-to-end below also includes table building and the
14-line decode.""")

code("""params = dict(type="Protein", structure_weight=800, simmatrix="BLOSUM62",
              gap_opening_cost=-150, gap_cost=-50, shift_cost=-150,
              max_shift=1)

t0 = time.perf_counter()
ba = BiAligner(seqA, seqB, strA, strB, **params)
score = ba.optimize()
lines = list(ba.decode_trace())
t1 = time.perf_counter()
print("SCORE:", score, " (reference: 761500)")
print(f"end-to-end: {t1-t0:.2f} s (reference fill alone: 626.7 s)")
for line in lines[:2]:
    print(line[:90])""")

md("""## Engine timing comparison (150 x 150 prefix)

Same problem on each engine; `numpy` is the cell-by-cell oracle the
reference's own speed class belongs to.""")

code("""pa, pb = seqA[:150], seqB[:150]
sa, sb = strA[:150], strB[:150]
rows = []
for engine in ["numpy", "native", "xla"]:
    ba = BiAligner(pa, pb, sa, sb, engine=engine, **params)
    t0 = time.perf_counter()
    s = ba.optimize()
    dt = time.perf_counter() - t0
    rows.append((engine, s, dt))
    print(f"{engine:8} SCORE {s}   fill {dt:8.3f} s")
assert len({r[1] for r in rows}) == 1  # identical scores""")

md("""## Linear-memory (checkpointed) band mode

`lowmem=True` stores only O(sqrt(D)) scan checkpoints and rematerializes
band blocks during traceback — bit-identical output, ~14x less device
memory on the full pair.  It runs on the checkpointed XLA scan.""")

code("""ba_ref = BiAligner(pa, pb, sa, sb, engine="xla", **params)
ba_low = BiAligner(pa, pb, sa, sb, engine="xla", lowmem=True, **params)
print("scores:", ba_ref.optimize(), ba_low.optimize())
assert list(ba_ref.decode_trace()) == list(ba_low.decode_trace())
print("decoded alignments identical (full band + checkpointed fill)")""")

md("""## DSSP / STRIDE input

The reference parses DSSP/STRIDE only in notebook cells; here they are
package modules (`bialign_tpu.io.structure_files`).  Synthetic STRIDE
content for two short chains:""")

code("""def stride_records(seq, ss, chain, start=1):
    end = start + len(seq) - 1
    pad = " " * (50 - 10 - len(seq))
    return [f"CHN  /tmp/x.pdb {chain}",
            f"SEQ  {start:<4} {seq}{pad}{end}",
            f"STR       {ss}{pad}"]

text = "\\n".join(stride_records("RAKLPLKEKKLTATAN", "CHHHHHHHHHHHHHCC", "A")
                 + stride_records("KAKLPLKEKKLTRTAN", "HHHHHHHHHHHHCCCC", "B"))
molA = read_stride(text, chain="A")
molB = read_stride(text, chain="B")
print(molA)
print(molB)

ba = BiAligner(molA["seq"], molB["seq"], molA["str"], molB["str"],
               **params)
print("SCORE:", ba.optimize())
for line in ba.decode_trace():
    print(line)""")

md("""## Batched pair scoring

Corpora of pairs score through `parallel.batch.score_batch`:
length-bucketed, padded, and filled in one dispatch per bucket (the
CUDA wavefront kernel, one thread block per pair, on a GPU; the vmapped
XLA scan on a CPU).  With a `jax.sharding.Mesh` the batch axis shards
over the `data` axis; one long pair can instead shard its wavefront
over devices
(`parallel.seqsplit`, `ppermute` halo exchange, full traceback
support).""")

code("""from bialign_tpu.models.molecule import preprocess_molecule
from bialign_tpu.scoring.tables import build_score_tables
from bialign_tpu.parallel.batch import score_batch

molA = preprocess_molecule(pa[:60], sa[:60], is_rna=False)
molB = preprocess_molecule(pb[:60], sb[:60], is_rna=False)
mu1, mu2 = build_score_tables(molA, molB, params, is_rna=False)
tables = [(mu1, mu2)] * 32
t0 = time.perf_counter()
scores = score_batch(tables, params["max_shift"],
                     (params["gap_opening_cost"], params["gap_cost"],
                      params["shift_cost"]), affine=True)
dt = time.perf_counter() - t0
print(f"32 pairs in {dt:.2f} s ({32/dt:.0f} pairs/s on this backend)")
print("scores identical:", len(set(scores.tolist())) == 1)""")

md("""## Batched ALIGNMENTS (not just scores)

`parallel.batch.align_batch` runs the fill **and** the traceback batched
on device (one fused dispatch per bucket chunk: band-emitting batched
fill + vmapped traceback walk), returning per-pair traces bit-exact
with `BiAligner.traceback()`.  `StreamingAligner(..., alignments=True)` spools
the compact trace codes alongside each score.""")

code("""from bialign_tpu.parallel.batch import align_batch

scores, traces, complete = align_batch(
    tables, params["max_shift"],
    (params["gap_opening_cost"], params["gap_cost"],
     params["shift_cost"]), affine=True)
ba_one = BiAligner(pa[:60], pb[:60], sa[:60], sb[:60], **params)
ba_one.optimize()
print("scores match:", int(scores[0]) == ba_one.optimize())
print("trace bit-exact vs BiAligner:",
      [tuple(c) for c in traces[0]] == [tuple(c) for c in ba_one.traceback()],
      " all complete:", all(complete))""")

md("""## Steady-state serving: cached device buckets

`PreparedBatch` packs and transfers a corpus once; `scores()` then runs
only the fills, with no bucket rebuild and no transfer.""")

code("""from bialign_tpu.parallel.batch import PreparedBatch

prep = PreparedBatch(tables, params["max_shift"],
                     (params["gap_opening_cost"], params["gap_cost"],
                      params["shift_cost"]), affine=True)
t0 = time.perf_counter()
s2 = prep.scores()
dt = time.perf_counter() - t0
print(f"cached scoring: {len(tables)} pairs in {dt*1e3:.1f} ms "
      f"({len(tables)/dt:.0f} pairs/s on this backend)")
print("matches one-shot path:", (s2 == scores).all())""")

md("""## Serving: persistent compile cache

Corpus fills compile once per *length bucket* (not per exact pair), and
the persistent JAX compilation cache keeps compiled programs across
processes: in `JAX_COMPILATION_CACHE_DIR` when it is set, else in
`.jax_cache/` inside the checkout.
""")

md("""## Plotting

`plot_alignment` draws the four-way alignment with secondary-structure
glyphs, shift boxes and incongruence bars (reference
`bialignment_nonpyx.py:144-367`).""")

code("""import matplotlib
matplotlib.use("Agg")
from bialign_tpu import plot_alignment

ba = BiAligner(pa[:80], pb[:80], sa[:80], sb[:80], **params)
ba.optimize()
alilines = ba.decode_trace_full()
fig = plot_alignment(alilines, 40, outname="Notebooks/dnapol_prefix80.svg")
print("wrote Notebooks/dnapol_prefix80.svg")""")

nb["cells"] = cells
nb["metadata"]["kernelspec"] = {
    "name": "python3", "display_name": "Python 3", "language": "python",
}

client = NotebookClient(nb, timeout=1800, kernel_name="python3")
client.execute()
nbf.write(nb, "Notebooks/case_studies.ipynb")
print("wrote Notebooks/case_studies.ipynb")
