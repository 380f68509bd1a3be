"""Benchmark of the main paths on one NVIDIA GPU, CUDA kernel against XLA.

    python bench.py [--runs 5] [--only dnapol,batch,rna,lowmem,stream]

Every row is one JSON line with the median, min and max wall time of
``--runs`` warm runs (each ends in a host transfer of its result, so the
device work is complete), the engine, and the device it ran on: JAX's
platform, ``device_kind`` and device count, and the card's name and power
limit from ``nvidia-smi``.  The script exits non-zero without a GPU; a
time taken anywhere else says nothing about the card.

Rows:

* ``dnapol_fill_s`` / ``dnapol_walk_s`` / ``dnapol_fill_walk_s``: the
  DNA-Polymerase-1 pair (928 x 933 aa, README flags) through
  ``BiAligner.optimize()`` and ``traceback()``, affine at max_shift 0, 1
  and 2 and non-affine at 2, on the XLA scan and on the CUDA kernel;
* ``batch64_scores_s`` / ``batch64_alignments_s``: 64 windows of 128-512
  aa of the same pair through the codes path in 128-residue buckets
  (device table build, fill, and for alignments the device walk), on
  both engines;
* ``rna_batch64_scores_s`` / ``rna_batch64_alignments_s``: 64 random
  RNA pairs of 60-240 nt at the reference defaults (non-affine,
  max_shift 2) from host-built tables, on both engines;
* ``dnapol_lowmem_fill_walk_s``: the README pair with ``lowmem=True``;
* ``stream_scores_s`` / ``stream_alignments_s``: the same 64 windows
  through ``StreamingAligner`` (host encode, spool off), engine "auto".

Engines alternate within each run, so both see the same card state.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

README_FLAGS = dict(type="Protein", shift_cost=-150, structure_weight=800,
                    simmatrix="BLOSUM62", gap_opening_cost=-150,
                    gap_cost=-50)
CORPUS = dict(n_pairs=64, lo=128, hi=512, seed=5)
RNA_CORPUS = dict(n_pairs=64, lo=60, hi=240, seed=7)


def device_info() -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py: needs a GPU, JAX platform is "
                 f"{devs[0].platform!r}")
    card, limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].split(", ")
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "card": card, "power_limit": limit}


def row(dev, metric, engine, times, **extra):
    out = {"metric": metric, "engine": engine, "unit": "s",
           "value": statistics.median(times), "min": min(times),
           "max": max(times), "runs": len(times), **extra, **dev}
    print(json.dumps(out), flush=True)


def measure(fns: dict, runs: int) -> dict:
    """Warm each callable once, then time ``runs`` rounds, taking the
    engines in turn within each round."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(runs):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[k].append(time.perf_counter() - t0)
    return times


def bench_dnapol(dev, runs):
    from bialign_tpu import BiAligner
    from bialign_tpu.data.corpora import dnapol_pair

    seqA, strA, seqB, strB = dnapol_pair()
    for S, affine in [(0, True), (1, True), (2, True), (2, False)]:
        params = dict(README_FLAGS, max_shift=S)
        if not affine:
            params["gap_opening_cost"] = 0
        shape = f"ms{S}_{'affine' if affine else 'nonaffine'}"
        split = {}

        def run(engine):
            ba = BiAligner(seqA, seqB, strA, strB, engine=engine, **params)
            t0 = time.perf_counter()
            score = ba.optimize()
            t1 = time.perf_counter()
            ba.traceback()
            t2 = time.perf_counter()
            split.setdefault(engine, []).append((t1 - t0, t2 - t1))
            return score

        scores = {e: run(e) for e in ("xla", "cuda")}
        assert scores["xla"] == scores["cuda"], scores
        split.clear()
        times = measure({e: (lambda e=e: run(e)) for e in scores}, runs)
        for engine, t in times.items():
            fills = [f for f, _ in split[engine][1:]]
            walks = [w for _, w in split[engine][1:]]
            row(dev, "dnapol_fill_s", engine, fills, shape=shape)
            row(dev, "dnapol_walk_s", engine, walks, shape=shape)
            row(dev, "dnapol_fill_walk_s", engine, t, shape=shape,
                score=scores[engine])


def bench_batch(dev, runs):
    import jax

    from bialign_tpu.data.corpora import dnapol_windows
    from bialign_tpu.parallel import batch as pbatch
    from bialign_tpu.scoring.tables import _sim_lut

    recs = dnapol_windows(**CORPUS)
    pairs = [pbatch.encode_pair(r.seqA, r.seqB, r.strA, r.strB)
             for r in recs]
    lut = jax.device_put(_sim_lut("BLOSUM62")[0])
    ptuple = (-150, -50, -150)
    for kind, dispatch in [("scores", pbatch.dispatch_score_batch_codes),
                           ("alignments", pbatch.dispatch_align_batch_codes)]:
        def run(engine):
            return dispatch(pairs, 1, ptuple, affine=True, lut=lut,
                            structure_weight=800, bucket_quantum=128,
                            engine=engine).get()

        got = {e: run(e) for e in ("xla", "cuda")}
        if kind == "scores":
            assert (got["xla"] == got["cuda"]).all()
        else:
            assert (got["xla"][0] == got["cuda"][0]).all()
            assert got["xla"][1] == got["cuda"][1]
        times = measure({e: (lambda e=e: run(e)) for e in got}, runs)
        for engine, t in times.items():
            row(dev, f"batch64_{kind}_s", engine, t, pairs=len(pairs))


def bench_rna(dev, runs):
    from bialign_tpu.data.corpora import rna_pairs
    from bialign_tpu.models.molecule import preprocess_molecule
    from bialign_tpu.parallel import batch as pbatch
    from bialign_tpu.scoring.tables import build_score_tables

    params = dict(type="RNA", structure_weight=400, gap_cost=-200,
                  shift_cost=-250)
    tables = [
        build_score_tables(preprocess_molecule(r.seqA, r.strA, is_rna=True),
                           preprocess_molecule(r.seqB, r.strB, is_rna=True),
                           params, is_rna=True)
        for r in rna_pairs(**RNA_CORPUS)
    ]
    for kind, fn in [("scores", pbatch.score_batch),
                     ("alignments", pbatch.align_batch)]:
        def run(engine):
            return fn(tables, 2, (-200, -250), affine=False, engine=engine)

        got = {e: run(e) for e in ("xla", "cuda")}
        if kind == "scores":
            assert (got["xla"] == got["cuda"]).all()
        else:
            assert (got["xla"][0] == got["cuda"][0]).all()
            assert got["xla"][1] == got["cuda"][1]
        times = measure({e: (lambda e=e: run(e)) for e in got}, runs)
        for engine, t in times.items():
            row(dev, f"rna_batch64_{kind}_s", engine, t, pairs=len(tables),
                shape="ms2_nonaffine")


def bench_lowmem(dev, runs):
    from bialign_tpu import BiAligner
    from bialign_tpu.data.corpora import dnapol_pair

    seqA, strA, seqB, strB = dnapol_pair()

    def run():
        ba = BiAligner(seqA, seqB, strA, strB, engine="auto", lowmem=True,
                       max_shift=1, **README_FLAGS)
        ba.optimize()
        ba.traceback()

    times = measure({"xla": run}, runs)
    row(dev, "dnapol_lowmem_fill_walk_s", "xla", times["xla"],
        shape="ms1_affine")


def bench_stream(dev, runs):
    from bialign_tpu.data.corpora import dnapol_windows
    from bialign_tpu.parallel.driver import StreamingAligner

    recs = dnapol_windows(**CORPUS)
    for alignments in (False, True):
        def run():
            sa = StreamingAligner(dict(README_FLAGS, max_shift=1),
                                  chunk_pairs=len(recs),
                                  alignments=alignments)
            assert sum(1 for _ in sa.run(iter(recs))) == len(recs)

        kind = "alignments" if alignments else "scores"
        times = measure({"auto": run}, runs)
        row(dev, f"stream_{kind}_s", "auto", times["auto"],
            pairs=len(recs))


BENCHES = {"dnapol": bench_dnapol, "batch": bench_batch, "rna": bench_rna,
           "lowmem": bench_lowmem, "stream": bench_stream}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--only", default=",".join(BENCHES))
    args = ap.parse_args(argv)
    dev = device_info()
    from bialign_tpu.utils.jaxconfig import ensure_compile_cache

    ensure_compile_cache()
    for name in args.only.split(","):
        BENCHES[name](dev, args.runs)


if __name__ == "__main__":
    main()
