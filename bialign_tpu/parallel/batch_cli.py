"""Corpus batch runner: score (or fully align) a TSV of pairs.

The reference CLI is one pair per process (/root/reference/src/
bialign.py); corpora need a driver.  This front-end streams a TSV
through :class:`bialign_tpu.parallel.driver.StreamingAligner`:
length-bucketed batched fills on the device, optional batched
tracebacks, fsync'd JSONL spooling with resume, and multi-host stream
sharding via ``jax.distributed``.

Input format: one pair per line, tab-separated::

    id <TAB> seqA <TAB> seqB [<TAB> strA <TAB> strB]

Structures are required for --type Protein (as in the reference) and
predicted via the ViennaRNA path for RNA when omitted.

Usage::

    python -m bialign_tpu.parallel.batch_cli pairs.tsv \
        --spool results.jsonl --type Protein --simmatrix BLOSUM62 \
        --structure_weight 800 --gap_opening_cost -150 --gap_cost -50 \
        --shift_cost -150 --max_shift 1 --alignments
"""

from __future__ import annotations

import argparse
import json
import sys


def _iter_pairs(path):
    from .driver import PairRecord

    with open(path) as fh:
        for ln_no, line in enumerate(fh, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) not in (3, 5):
                raise SystemExit(
                    f"{path}:{ln_no}: expected 3 or 5 tab-separated "
                    f"fields (id seqA seqB [strA strB]), got {len(parts)}"
                )
            strA = parts[3] if len(parts) == 5 else None
            strB = parts[4] if len(parts) == 5 else None
            yield PairRecord(id=parts[0], seqA=parts[1], seqB=parts[2],
                             strA=strA, strB=strB)


def add_batch_parameters(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("pairs_tsv", help="TSV of pairs: id seqA seqB "
                        "[strA strB]")
    parser.add_argument("--spool", default=None,
                        help="JSONL results spool (enables resume)")
    parser.add_argument("--alignments", action="store_true",
                        help="batched tracebacks too: each emitted JSON "
                        "record carries the packed trace codes (decode "
                        "via bialign_tpu.parallel.driver.trace_from_codes"
                        " + render.decode)")
    parser.add_argument("--render", action="store_true",
                        help="with --alignments: also print each pair's "
                        "decoded alignment lines (reference outmode "
                        "rendering) after its JSON record")
    parser.add_argument("--outmode", default="default",
                        help="outmode for --render (reference modes, "
                        "prefix-completed)")
    parser.add_argument("--chunk_pairs", type=int, default=256)
    parser.add_argument("--bucket_quantum", type=int, default=64)
    parser.add_argument("--distributed", action="store_true",
                        help="initialize jax.distributed and shard the "
                        "stream across processes")
    parser.add_argument("--coordinator", default=None,
                        help="with --distributed: coordinator address "
                        "host:port (default: cluster auto-detection)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--local_device", type=int, default=None,
                        help="with --distributed: the one card of this "
                        "host this process drives; give each process of "
                        "a shared host its own")
    # scoring parameters (reference names, bialign.py:25-96)
    parser.add_argument("--type", default="RNA")
    parser.add_argument("--sequence_match_similarity", type=int,
                        default=100)
    parser.add_argument("--sequence_mismatch_similarity", type=int,
                        default=0)
    parser.add_argument("--structure_weight", type=int, default=400)
    parser.add_argument("--gap_opening_cost", type=int, default=0)
    parser.add_argument("--gap_cost", type=int, default=-200)
    parser.add_argument("--shift_cost", type=int, default=-250)
    parser.add_argument("--max_shift", type=int, default=2)
    parser.add_argument("--simmatrix", default=None)


def _render_one(rec, trace, ns) -> None:
    """Decode one spooled trace to the reference's alignment lines
    (render.decode, same rows/outmodes as the single-pair CLI)."""
    from ..models.molecule import preprocess_molecule
    from ..render import decode as rd

    is_rna = ns.type == "RNA"
    molA = preprocess_molecule(rec.seqA, rec.strA, is_rna=is_rna)
    molB = preprocess_molecule(rec.seqB, rec.strB, is_rna=is_rna)
    full = rd.decode_trace_full(trace, molA, molB, nameA=rec.id + ".A",
                                nameB=rec.id + ".B", is_rna=is_rna)
    for line in rd.decode_trace(full, outmode=ns.outmode):
        print(line)


def main(argv=None) -> int:
    from ..utils.jaxconfig import ensure_compile_cache

    ensure_compile_cache()

    parser = argparse.ArgumentParser(
        description="Batch bi-alignment of a pair corpus."
    )
    add_batch_parameters(parser)
    ns = parser.parse_args(argv)

    from .driver import StreamingAligner, init_distributed, trace_to_codes

    pidx, pcount = (0, 1)
    if ns.distributed:
        pidx, pcount = init_distributed(
            ns.coordinator, ns.num_processes, ns.process_id,
            None if ns.local_device is None else [ns.local_device],
        )

    params = {
        k: getattr(ns, k)
        for k in (
            "type", "sequence_match_similarity",
            "sequence_mismatch_similarity", "structure_weight",
            "gap_opening_cost", "gap_cost", "shift_cost", "max_shift",
            "simmatrix",
        )
    }
    spool = ns.spool
    if spool and pcount > 1:
        spool = f"{spool}.shard{pidx}"
    sa = StreamingAligner(
        params, spool_path=spool, chunk_pairs=ns.chunk_pairs,
        bucket_quantum=ns.bucket_quantum, process_index=pidx,
        process_count=pcount, alignments=ns.alignments,
    )
    if ns.render and not ns.alignments:
        parser.error("--render requires --alignments")
    # records needed for rendering are retained only between dispatch
    # and harvest (~2 chunks, the driver's double-buffer depth) — NOT
    # the whole corpus; records the spool already covers are skipped at
    # insert like the driver does, so a resumed run stays bounded too
    pending: dict = {}

    def tracked(records):
        for r in records:
            if ns.render and not (sa.spool is not None
                                  and sa.spool.is_done(r.id)):
                pending[r.id] = r
            yield r

    n_done = 0
    for result in sa.run(tracked(_iter_pairs(ns.pairs_tsv))):
        if ns.alignments:
            pid, score, trace = result
            rec = {"id": pid, "score": score,
                   "trace": trace_to_codes(trace)}
        else:
            pid, score = result
            rec = {"id": pid, "score": score}
        print(json.dumps(rec))
        if ns.render:
            rrec = pending.pop(pid, None)
            if rrec is None:
                # duplicate pair id: the trace/record pairing is
                # ambiguous — refuse to render misleading lines
                print(f"# {pid}: duplicate id, not rendering",
                      file=sys.stderr)
            else:
                _render_one(rrec, trace, ns)
        n_done += 1
    print(f"# {n_done} pairs done (process {pidx}/{pcount})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
