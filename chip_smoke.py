"""End-to-end smoke check of bialign on one NVIDIA GPU (or four).

    python chip_smoke.py             # one card: every main path
    python chip_smoke.py --chips 4   # four cards: the sharded paths only

One process.  Phase 0 probes the device and exits non-zero, printing no
result, unless JAX's default device is a GPU.  The one-card phases run
the main paths through their normal entry points and check each against
its golden output or its reference, bit for bit:

  a. the README toy RNA and toy protein, CLI and BiAligner;
  b. DNA-Polymerase-1 928 x 933 at the README CLI flags (SCORE 761500 and
     the six md5 row anchors) and at the CLI defaults (against the host
     C++ engine);
  c. the same affine pair with lowmem=True (XLA checkpoint scan);
  d. a StreamingAligner protein corpus (64 windows of 128-512 aa, codes
     path), scores and alignments, against the host C++ engine;
  e. a StreamingAligner RNA corpus at the reference defaults (non-affine,
     max_shift 2, host tables), against the host C++ engine;
  k. the CUDA wavefront kernel against the XLA scan at DNA-Pol widths.

Each path prints its cold time (compile included), warm time, the
compiled fill step's memory analysis and the device's peak bytes in use.
With ``--chips 4`` only the four-card paths run: the (d)/(e) corpora over
a 4-card ("data",) mesh against one card, and the DNA-Pol pair split over
a 4-card ("sp",) mesh against 761500 and the md5 anchors.  The last line
is one JSON object: {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def probe(n_chips: int):
    """Phase 0: the device, or exit non-zero."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        sys.exit(2)
    if len(devs) < n_chips:
        print(f"chip_smoke: need {n_chips} GPUs, have {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    import jaxlib

    print(f"device: {devs[0].device_kind} x {len(devs)}")
    print(f"nvidia-smi: {_nvidia_smi()}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return devs


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke: {what}")
    print(f"  ok: {what}")


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def pair_step(ba):
    """The jitted lone-pair fill a BiAligner ran, with its arguments."""
    from bialign_tpu.ops import cuda_dp, xla_dp

    affine = ba._affine
    ptuple = ((ba.beta, ba.gamma, ba.delta) if affine
              else (ba.gamma, ba.delta))
    fn = cuda_dp._fill_one if ba._engine == "cuda" else xla_dp._band_device
    return fn, (ba.mu1.astype("int32"), ba.mu2.astype("int32"),
                ba.max_shift, ptuple, affine)


def check_engine(ba, name):
    from bialign_tpu import backend

    want = backend.pair_engine(ba.max_shift)
    check(ba._engine == want, f"{name}: auto engine is {want}")


def report(name, cold, warm, step=None):
    """One line per path: times, the compiled step's memory analysis
    and the device's peak bytes in use so far."""
    import jax

    mem = "n/a"
    if step is not None:
        fn, args = step
        ma = fn.lower(*args).compile().memory_analysis()
        if ma is not None:
            mem = (f"args {ma.argument_size_in_bytes} out "
                   f"{ma.output_size_in_bytes} temp {ma.temp_size_in_bytes}")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"[{name}] cold {cold:.3f} s, warm {warm:.3f} s; fill step "
          f"memory: {mem}; peak_bytes_in_use {peak}")


# -- one card -----------------------------------------------------------------

def phase_toys():
    """(a) README toys through BiAligner and the CLI."""
    import golden as G

    from bialign_tpu import BiAligner
    from bialign_tpu.cli import main as cli_main

    cases = [
        ("toy_rna_affine", G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS,
         G.TOY_RNA_AFFINE_SCORE, G.TOY_RNA_AFFINE_DEFAULT_OUT),
        ("toy_rna_nonaffine", G.TOY_RNA, G.TOY_RNA_NONAFFINE_PARAMS,
         G.TOY_RNA_NONAFFINE_SCORE, G.TOY_RNA_NONAFFINE_DEFAULT_OUT),
        ("toy_protein_sorted", G.TOY_PROTEIN, G.TOY_PROTEIN_PARAMS,
         G.TOY_PROTEIN_SCORE, G.TOY_PROTEIN_SORTED_OUT),
    ]
    for name, mol, params, score, lines in cases:
        def run():
            ba = BiAligner(mol["seqA"], mol["seqB"], mol.get("strA"),
                           mol.get("strB"), engine="auto", **params)
            return ba, ba.optimize(), list(ba.decode_trace())

        (ba, s, out), cold = timed(run)
        (_, s2, out2), warm = timed(run)
        check_engine(ba, name)
        check(s == s2 == score and out == out2 == lines,
              f"{name}: SCORE {s} and golden lines")
        report(name, cold, warm, pair_step(ba))

    argv = [G.TOY_RNA["seqA"], G.TOY_RNA["seqB"], "--strA",
            G.TOY_RNA["strA"], "--strB", G.TOY_RNA["strB"],
            "--structure_weight", "400", "--gap_opening_cost", "-200",
            "--gap_cost", "-50", "--max_shift", "1", "--shift_cost", "-150"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    got = buf.getvalue().splitlines()
    want = ["SCORE: 6800", ""] + G.TOY_RNA_AFFINE_DEFAULT_OUT
    check(got[-len(want):] == want, "CLI toy RNA: SCORE 6800 + golden")
    argv = [G.TOY_PROTEIN["seqA"], G.TOY_PROTEIN["seqB"], "--strA",
            G.TOY_PROTEIN["strA"], "--strB", G.TOY_PROTEIN["strB"],
            "--type", "Protein", "--shift_cost", "-150",
            "--structure_weight", "800", "--simmatrix", "BLOSUM62",
            "--gap_opening_cost", "-150", "--gap_cost", "-50",
            "--max_shift", "1", "--outmode", "sorted"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    got = buf.getvalue().splitlines()
    want = ["SCORE: 48500", ""] + G.TOY_PROTEIN_SORTED_OUT
    check(got[-len(want):] == want, "CLI toy protein: SCORE 48500 + golden")


FULL_MD5 = {
    "A": "4f49c3ed126e81d65bc13e6b963384fd",
    "B": "cf1a0953be5d5fffa9eb8a63e03aed51",
    "A ss": "755f0f228092a86aaf2458b7962b6c7b",
    "B ss": "89a56b820328ee1e1ed80c4f10370c49",
    "A shifts": "d5c459dce9c5e48d2eca62e1851e053a",
    "B shifts": "57bc03db8fe01bdfa4fdc169078679de",
}
README_FLAGS = dict(type="Protein", shift_cost=-150, structure_weight=800,
                    simmatrix="BLOSUM62", gap_opening_cost=-150,
                    gap_cost=-50, max_shift=1)


def _md5s(lines):
    return {ln[:16].rstrip(): hashlib.md5(ln[16:].encode()).hexdigest()
            for ln in lines}


def _dnapol_run(**extra):
    from bialign_tpu import BiAligner
    from bialign_tpu.data.corpora import dnapol_pair

    seqA, strA, seqB, strB = dnapol_pair()

    def run():
        ba = BiAligner(seqA, seqB, strA, strB, **extra)
        return ba, ba.optimize(), list(ba.decode_trace())

    return timed(run), timed(run)


def phase_dnapol():
    """(b) DNA-Pol at the README CLI flags and at the CLI defaults."""
    ((ba, s, lines), cold), ((_, s2, lines2), warm) = _dnapol_run(
        engine="auto", **README_FLAGS)
    check_engine(ba, "dnapol ms1 affine")
    check(s == s2 == 761500, f"dnapol ms1 affine: SCORE {s}")
    check(_md5s(lines) == _md5s(lines2) == FULL_MD5,
          "dnapol ms1 affine: six md5 row anchors")
    report("dnapol_ms1_affine", cold, warm, pair_step(ba))

    defaults = dict(type="Protein", simmatrix="BLOSUM62")
    ((ba, s, lines), cold), (_, warm) = _dnapol_run(engine="auto",
                                                    **defaults)
    check_engine(ba, "dnapol ms2 non-affine")
    (_, ns_, nlines), t_native = timed(lambda: _native_lone(defaults))
    check(s == ns_ and lines == nlines,
          f"dnapol CLI defaults (non-affine ms2): SCORE {s} == native")
    report("dnapol_ms2_nonaffine", cold, warm, pair_step(ba))
    print(f"  native engine, same pair: {t_native:.3f} s")


def _native_lone(params):
    from bialign_tpu import BiAligner
    from bialign_tpu.data.corpora import dnapol_pair

    seqA, strA, seqB, strB = dnapol_pair()
    ba = BiAligner(seqA, seqB, strA, strB, engine="native", **params)
    return ba, ba.optimize(), list(ba.decode_trace())


def phase_lowmem():
    """(c) the README pair with lowmem=True."""
    from bialign_tpu.ops import checkpoint_dp

    ((ba, s, lines), cold), ((_, s2, _), warm) = _dnapol_run(
        engine="auto", lowmem=True, **README_FLAGS)
    check(s == s2 == 761500 and _md5s(lines) == FULL_MD5,
          "dnapol lowmem: SCORE 761500 + md5 anchors")
    cb = ba._H
    report("dnapol_ms1_lowmem", cold, warm, (
        checkpoint_dp._affine_ckpt_scan,
        (cb.db, cb.mu1b, cb.mu2b, cb.n, cb.m, 1, (-150, -50, -150))))


PROTEIN_CORPUS = dict(n_pairs=64, lo=128, hi=512, seed=5)
RNA_CORPUS = dict(n_pairs=64, lo=60, hi=240, seed=7)
PROTEIN_PARAMS = README_FLAGS
RNA_PARAMS = dict(type="RNA")    # reference defaults: non-affine, ms2


def _stream(records, params, mesh=None, alignments=True):
    from bialign_tpu.parallel.driver import StreamingAligner

    sa = StreamingAligner(params, mesh=mesh, chunk_pairs=len(records),
                          alignments=alignments)
    out = {r[0]: r[1:] for r in sa.run(iter(records))}
    return sa, out


def _native_corpus(records, params):
    from bialign_tpu import BiAligner

    want = {}
    for r in records:
        ba = BiAligner(r.seqA, r.seqB, r.strA, r.strB, engine="native",
                       **params)
        want[r.id] = (ba.optimize(), ba.traceback())
    return want


def _corpus_phase(name, records, params, codes):
    want = _native_corpus(records, params)
    for alignments in (False, True):
        (sa, got), cold = timed(lambda: _stream(records, params,
                                                alignments=alignments))
        (_, got2), warm = timed(lambda: _stream(records, params,
                                                alignments=alignments))
        check((sa._codes_lut is not None) == codes,
              f"{name}: codes path {'on' if codes else 'off'}")
        if alignments:
            ok = all(got[k] == got2[k] == (want[k][0], want[k][1])
                     for k in want)
        else:
            ok = all(got[k] == got2[k] == (want[k][0],) for k in want)
        kind = "alignments" if alignments else "scores"
        check(ok and len(got) == len(want),
              f"{name} {kind}: {len(got)} pairs == native engine")
        report(f"{name}_{kind}", cold, warm, _corpus_step(sa, records))


def _corpus_step(sa, records):
    """The compiled fill step of the corpus's largest bucket."""
    from bialign_tpu import backend
    from bialign_tpu.parallel import batch as pbatch

    engine = backend.batch_engine("auto", sa.max_shift)
    if sa._codes_lut is not None:
        packed = pbatch._code_buckets([sa._encode(r) for r in records],
                                      sa.bucket_quantum)
        _, *arrays = packed[max(packed)]
        fn = pbatch._compiled(True, sa.alignments, None, (
            sa.max_shift, sa.ptuple, sa._sw, sa.affine, engine))
        return fn, [sa._codes_lut, *arrays]
    buckets = pbatch.make_buckets([sa._tables(r) for r in records],
                                  sa.bucket_quantum)
    b = buckets[max(buckets)]
    fn = pbatch._compiled(False, sa.alignments, None, (
        sa.max_shift, sa.ptuple, sa.affine, engine))
    return fn, list(pbatch._pack(b, 0, len(b.indices), None))


def phase_corpora():
    """(d) protein corpus on the codes path, (e) RNA corpus."""
    from bialign_tpu.data.corpora import dnapol_windows, rna_pairs

    _corpus_phase("protein_corpus", dnapol_windows(**PROTEIN_CORPUS),
                  PROTEIN_PARAMS, codes=True)
    _corpus_phase("rna_corpus", rna_pairs(**RNA_CORPUS), RNA_PARAMS,
                  codes=False)


def phase_kernel():
    """(k) the CUDA kernel's band against the XLA scan at DNA-Pol widths,
    cell for cell on every live row, and its score against the anchors."""
    import jax
    import jax.numpy as jnp

    from bialign_tpu import BiAligner
    from bialign_tpu.data.corpora import dnapol_pair
    from bialign_tpu.ops import cuda_dp, xla_dp

    seqA, strA, seqB, strB = dnapol_pair()
    n, m = len(seqA), len(seqB)
    d_ = jnp.arange(n + m + 1)[:, None]
    i_ = jnp.arange(n + 1)[None, :]
    live = (d_ - i_ >= 0) & (d_ - i_ <= m)          # [D, P]

    @jax.jit
    def same(a, b):
        # a, b: [D, Q, P, W, W] affine or [D, P, W, W]
        mask = (live[:, None, :, None, None] if a.ndim == 5
                else live[:, :, None, None])
        return jnp.all(jnp.where(mask, a == b, True))

    for S, affine in [(0, True), (1, True), (2, True), (2, False)]:
        params = dict(README_FLAGS, max_shift=S)
        if not affine:
            params["gap_opening_cost"] = 0
        ba = BiAligner(seqA, seqB, strA, strB, engine="native", **params)
        ptuple = ((ba.beta, ba.gamma, ba.delta) if affine
                  else (ba.gamma, ba.delta))
        kb = cuda_dp.fill_device(ba.mu1, ba.mu2, S, ptuple, affine)
        fill = (xla_dp.fill_affine_device if affine
                else xla_dp.fill_nonaffine_device)
        xb = fill(ba.mu1, ba.mu2, S, *ptuple)
        ok = bool(same(kb.ys, xb.ys))
        score = kb.final_score()
        tag = f"kernel ms{S} {'affine' if affine else 'non-affine'}"
        check(ok and score == xb.final_score(),
              f"{tag}: band == XLA scan on every live cell, SCORE {score}")
        if S == 1 and affine:
            check(score == 761500, f"{tag}: SCORE 761500")
        del kb, xb


# -- four cards ---------------------------------------------------------------

def phase_four_chips(devs):
    """The corpora over a 4-card data mesh against one card, and the
    DNA-Pol pair split over a 4-card sp mesh against the anchors."""
    import numpy as np
    from jax.sharding import Mesh

    from bialign_tpu import BiAligner
    from bialign_tpu.data.corpora import dnapol_pair, dnapol_windows, \
        rna_pairs

    mesh = Mesh(np.asarray(devs[:4]), ("data",))
    for name, records, params in [
        ("protein_corpus", dnapol_windows(**PROTEIN_CORPUS), PROTEIN_PARAMS),
        ("rna_corpus", rna_pairs(**RNA_CORPUS), RNA_PARAMS),
    ]:
        for alignments in (False, True):
            (_, one), t1 = timed(lambda: _stream(records, params,
                                                 alignments=alignments))
            (_, four), cold = timed(lambda: _stream(
                records, params, mesh=mesh, alignments=alignments))
            (_, four2), warm = timed(lambda: _stream(
                records, params, mesh=mesh, alignments=alignments))
            kind = "alignments" if alignments else "scores"
            check(one == four == four2,
                  f"{name} {kind}: 4-card data mesh == one card "
                  f"({len(one)} pairs)")
            report(f"{name}_{kind}_4cards", cold, warm)
            print(f"  one card (incl. compile): {t1:.3f} s")

    seqA, strA, seqB, strB = dnapol_pair()
    sp = Mesh(np.asarray(devs[:4]), ("sp",))

    def run():
        ba = BiAligner(seqA, seqB, strA, strB, engine="auto",
                       seqsplit_mesh=sp, **README_FLAGS)
        return ba.optimize(), list(ba.decode_trace())

    (s, lines), cold = timed(run)
    (s2, _), warm = timed(run)
    check(s == s2 == 761500 and _md5s(lines) == FULL_MD5,
          "dnapol seqsplit over 4 cards: SCORE 761500 + md5 anchors")
    report("dnapol_seqsplit_4cards", cold, warm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    devs = probe(args.chips)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from bialign_tpu import cuda
    from bialign_tpu.utils.jaxconfig import DEFAULT_CACHE_DIR, \
        ensure_compile_cache

    ensure_compile_cache()
    print("compile cache: "
          f"{os.environ.get('JAX_COMPILATION_CACHE_DIR') or DEFAULT_CACHE_DIR}")
    t0 = time.perf_counter()
    cuda.build()
    print(f"CUDA kernel build (set-up): {time.perf_counter() - t0:.3f} s")

    if args.chips == 4:
        phase_four_chips(devs)
    else:
        phase_toys()
        phase_dnapol()
        phase_lowmem()
        phase_corpora()
        phase_kernel()

    import jax

    d = jax.devices()[0]
    print(f"nvidia-smi: {_nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
