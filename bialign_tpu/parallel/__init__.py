"""Scaling subsystems: batched data parallelism, the streaming driver,
and sequence-split (context-parallel) single-pair sharding.

The reference is single-process, single-threaded (SURVEY.md §2.4); this
package is the scale-out layer.
"""

from .batch import (
    PendingAlignments,
    PendingScores,
    PreparedBatch,
    align_batch,
    dispatch_align_batch,
    dispatch_align_batch_codes,
    dispatch_score_batch,
    dispatch_score_batch_codes,
    encode_pair,
    make_buckets,
    match_mismatch_lut,
    score_batch,
)
from .driver import (
    PairRecord,
    ResultSpool,
    StreamingAligner,
    init_distributed,
    merge_spools,
    trace_from_codes,
    trace_to_codes,
)
from .seqsplit import fill_seqsplit, score_seqsplit

__all__ = [
    "PairRecord",
    "PendingAlignments",
    "PendingScores",
    "PreparedBatch",
    "align_batch",
    "ResultSpool",
    "StreamingAligner",
    "dispatch_align_batch",
    "dispatch_align_batch_codes",
    "dispatch_score_batch",
    "dispatch_score_batch_codes",
    "encode_pair",
    "fill_seqsplit",
    "init_distributed",
    "make_buckets",
    "match_mismatch_lut",
    "merge_spools",
    "score_batch",
    "score_seqsplit",
    "trace_from_codes",
    "trace_to_codes",
]
