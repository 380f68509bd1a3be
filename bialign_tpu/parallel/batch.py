"""Batched, sharded bi-alignment: scores and alignments for corpora.

The reference is single-pair, single-threaded (SURVEY.md §2.4: no
parallelism of any kind).  This module provides the scaling axis: data
parallelism over independent pairs.

Pipeline:
  1. pairs are bucketed by padded length (multiples of ``bucket_quantum``)
     so one compilation serves a whole bucket;
  2. per bucket, the dense score tables are zero-padded to the bucket shape
     and stacked ``[B, N+1, M+1]`` (int16 on the wire when the values fit),
     or, on the codes path, only O(n) code vectors travel and the tables
     are built on the device (:func:`~bialign_tpu.ops.device_tables.
     mu_planes_from_codes`);
  3. one jitted dispatch per bucket (or chunk) fills every pair on the
     device: the CUDA wavefront kernel with one block per pair
     (:mod:`bialign_tpu.ops.cuda_dp`), or the XLA scan vmapped over the
     batch with its diagonal tables built on the device.  Per-pair true
     lengths ride along as data, so padding never changes a score
     (tests/test_batch.py);
  4. alignments walk the filled bands on the device
     (:mod:`bialign_tpu.ops.device_traceback`), so only O(n+m) trace
     codes per pair come back to the host;
  5. with a :class:`jax.sharding.Mesh`, the batch axis is sharded over the
     ``"data"`` axis under ``shard_map``: each device fills and walks its
     own pairs, and only scores and trace codes are gathered.

``engine`` is "auto" (the platform's choice, :mod:`bialign_tpu.backend`),
"xla" or "cuda".
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import backend
from ..ops import cuda_dp, xla_dp
from ..ops import device_traceback as dtb
from ..ops.cases import N_STATES, NonAffineTables
from ..ops.device_tables import diag_tables, mu_planes_from_codes, \
    narrow_if_fits


def quantize(x: int, q: int) -> int:
    return ((max(x, 1) + q - 1) // q) * q


@dataclass
class Bucket:
    """One padded shape bucket of pairs awaiting scoring."""

    N: int
    M: int
    indices: list = field(default_factory=list)   # position in user order
    mu1: list = field(default_factory=list)
    mu2: list = field(default_factory=list)
    n: list = field(default_factory=list)
    m: list = field(default_factory=list)


def make_buckets(tables, bucket_quantum: int = 64):
    """Group (mu1, mu2) pairs into padded-shape buckets of raw tables.

    ``tables``: iterable of (mu1, mu2) arrays of shape (n+1, m+1).
    Returns a dict keyed by (N, M); :func:`stack_padded` pads a bucket's
    tables to ``[B, N+1, M+1]`` in one write.  Zero padding is only read
    by cells outside the genuine region (i > n or j > m), which never
    feed genuine cells, so it cannot change a score."""
    buckets: dict = {}
    for idx, (mu1, mu2) in enumerate(tables):
        n = mu1.shape[0] - 1
        m = mu1.shape[1] - 1
        N = quantize(n, bucket_quantum)
        M = quantize(m, bucket_quantum)
        b = buckets.setdefault((N, M), Bucket(N, M))
        b.mu1.append(np.asarray(mu1))
        b.mu2.append(np.asarray(mu2))
        b.indices.append(idx)
        b.n.append(n)
        b.m.append(m)
    return buckets


def stack_padded(raws, N: int, M: int, pad_count: int = 0) -> np.ndarray:
    """Stack raw (n+1, m+1) tables into one [B, N+1, M+1] int32 array
    (+ ``pad_count`` repeats of the last table for batch-axis padding).
    When every table has the same shape this is one stack and one block
    write, with no per-pair loop."""
    raws = list(raws) + [raws[-1]] * pad_count
    shapes = {a.shape for a in raws}
    out = np.zeros((len(raws), N + 1, M + 1), dtype=np.int32)
    if len(shapes) == 1:
        (n1, m1), = shapes
        out[:, :n1, :m1] = np.stack(raws)
        return out
    for i, a in enumerate(raws):
        out[i, : a.shape[0], : a.shape[1]] = a
    return out


def _batch_pad(B: int, mesh) -> int:
    """Rows to add so the batch splits evenly over the mesh's data axis."""
    if mesh is None:
        return 0
    ds = mesh.shape["data"]
    return (-B) % ds


def _pack(b: Bucket, lo: int, hi: int, mesh):
    """Host arrays of bucket rows [lo, hi): stacked tables (narrowed when
    they fit) and true lengths, batch-padded for the mesh."""
    pad = _batch_pad(hi - lo, mesh)
    sl = slice(lo, hi)
    ns = b.n[sl] + [b.n[sl][-1]] * pad
    ms = b.m[sl] + [b.m[sl][-1]] * pad
    return (narrow_if_fits(stack_padded(b.mu1[sl], b.N, b.M, pad)),
            narrow_if_fits(stack_padded(b.mu2[sl], b.N, b.M, pad)),
            np.asarray(ns, dtype=np.int32), np.asarray(ms, dtype=np.int32))


# -- traced bodies --------------------------------------------------------------

def _scores_planes(mu1p, mu2p, ns, ms, max_shift, params, affine, engine):
    """Scores ``[B]`` of a bucket from its dense tables ``[B, P, M]``."""
    if engine == "cuda":
        return cuda_dp.fill(mu1p, mu2p, ns, ms, max_shift, params, affine,
                            False)[0]
    _, Pn, M = mu1p.shape
    D = Pn + M - 1
    mu1d, mu2d = jax.vmap(
        lambda a, b: diag_tables(a, b, max_shift, D))(mu1p, mu2p)
    fn = (xla_dp.affine_score_traced if affine
          else xla_dp.nonaffine_score_traced)
    return jax.vmap(functools.partial(fn, max_shift=max_shift,
                                      params=params))(mu1d, mu2d, ns, ms)


def _band_planes(mu1p, mu2p, ns, ms, max_shift, params, affine, engine):
    """Bands ``[B, D, (Q,) P, W, W]`` of a bucket (XLA band layout)."""
    if engine == "cuda":
        return cuda_dp.fill(mu1p, mu2p, ns, ms, max_shift, params, affine,
                            True)[1]
    _, Pn, M = mu1p.shape
    scan = xla_dp.affine_scan if affine else xla_dp.nonaffine_scan

    def one(a, b):
        mu1d, mu2d = diag_tables(a, b, max_shift, Pn + M - 1)
        return scan(mu1d, mu2d, Pn - 1, M - 1, max_shift, params)[1]

    return jax.vmap(one)(mu1p, mu2p)


def _fill_walk_planes(mu1p, mu2p, ns, ms, max_shift, params, affine,
                      engine):
    """Band fill + vmapped device walk.  Returns (codes, steps, done,
    scores) affine, (codes, steps, scores) non-affine."""
    m1 = mu1p.astype(jnp.int32)
    m2 = mu2p.astype(jnp.int32)
    ys = _band_planes(m1, m2, ns, ms, max_shift, params, affine, engine)
    if affine:
        const = jnp.asarray(dtb._affine_const(*params))
        return dtb._affine_walk_batch(ys, m1, m2, const, max_shift, ns, ms)
    const = jnp.asarray(NonAffineTables(*params).const)
    codes, steps = dtb._nonaffine_walk_batch(ys, m1, m2, const, max_shift,
                                             ns, ms)
    S = max_shift
    scores = ys[jnp.arange(ys.shape[0]), ns + ms, ns, S, S]
    return codes, steps, scores


def _tables_body(align):
    body = _fill_walk_planes if align else _scores_planes

    def fn(mu1p, mu2p, ns, ms, max_shift, params, affine, engine):
        return body(mu1p.astype(jnp.int32), mu2p.astype(jnp.int32), ns, ms,
                    max_shift, params, affine, engine)

    return fn


def _codes_body(align):
    body = _fill_walk_planes if align else _scores_planes

    def fn(lut, ca, cb, sa, sb, ns, ms, max_shift, params, sw, affine,
           engine):
        mu1p, mu2p = mu_planes_from_codes(lut, ca, cb, sa, sb, ns, ms, sw)
        return body(mu1p, mu2p, ns, ms, max_shift, params, affine, engine)

    return fn


@functools.lru_cache(maxsize=None)
def _compiled(codes: bool, align: bool, mesh, static: tuple):
    """One jitted dispatch per (input kind, output kind, mesh, static
    settings), cached so it is built once, not per chunk.  With a mesh
    the body runs under ``shard_map``: the LUT (codes path) replicated,
    every other argument sharded on its batch axis over ``"data"``."""
    body = _codes_body(align) if codes else _tables_body(align)
    n_rep = 1 if codes else 0
    n_arr = 7 if codes else 4

    def fn(*args):
        return body(*args, *static)

    if mesh is None:
        return jax.jit(fn)
    specs = (P(None, None),) * n_rep + (P("data"),) * (n_arr - n_rep)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=specs, out_specs=P("data"),
        # the CUDA kernel's FFI results carry no varying-mesh-axes typing
        check_vma=False,
    ))


def _put(mesh, arrays, lut=None):
    """Device placement: shard batch-axis arrays over "data", replicate
    the LUT (plain transfers without a mesh)."""
    if mesh is None:
        out = [jnp.asarray(a) for a in arrays]
        return out if lut is None else [jnp.asarray(lut)] + out
    out = [jax.device_put(jnp.asarray(a), NamedSharding(
        mesh, P("data", *([None] * (np.ndim(a) - 1))))) for a in arrays]
    if lut is None:
        return out
    return [jax.device_put(jnp.asarray(lut),
                           NamedSharding(mesh, P(None, None)))] + out


def _require_int32_safe(tables, params, affine: bool):
    """Entry-level int32-overflow guard for the batched engines.

    The batched engines compute in int32 with a -2^30 sentinel;
    :class:`bialign_tpu.BiAligner` certifies this per pair
    (ops/cases.check_int32_safe) and falls back to an int64 XLA scan,
    but the batch paths have no int64 twin — so an unsafe pair must
    fail loudly, not silently wrap.  Checked on the ORIGINAL tables
    before any int32 cast (the bucket-padding cast would wrap first and
    hide the magnitude), per-pair form of ops/cases.int32_value_bound.
    """
    if affine:
        beta, gamma, delta = params
    else:
        beta = 0
        gamma, delta = params
    for idx, (mu1, mu2) in enumerate(tables):
        amax = max(int(np.abs(mu1).max(initial=0)),
                   int(np.abs(mu2).max(initial=0)))
        n = mu1.shape[0] - 1
        m = mu1.shape[1] - 1
        per_col = (2 * abs(int(gamma)) + 2 * abs(int(beta))
                   + 2 * abs(int(delta)) + 2 * amax)
        bound = 2 * (n + m + 2) * per_col
        if not ((-(1 << 30)) - bound > np.iinfo(np.int32).min
                + (1 << 20)):
            raise ValueError(
                "scoring parameters/tables exceed the certified int32 "
                f"range for pair {idx} (value drift bound {bound}); the "
                "batched engines have no int64 path — score these pairs "
                "individually via BiAligner (engine='xla'), which falls "
                "back to the overflow-safe int64 scan"
            )


class PendingScores:
    """Dispatched-but-unharvested batched scores.

    JAX dispatch is asynchronous: the fills are already running (or
    queued) on the device when this object is returned, so the caller
    can overlap host work — preprocessing and packing the NEXT chunk —
    with device compute.  :meth:`get` blocks on the transfers and
    assembles the scores in input order (the streaming driver's
    double-buffering rides on this).
    """

    def __init__(self, n_pairs: int, parts):
        self._n = n_pairs
        self._parts = parts          # [(indices, device_scores)]

    @property
    def n_dispatches(self) -> int:
        """Fill dispatches issued (one per length bucket)."""
        return len(self._parts)

    def get(self) -> np.ndarray:
        out = np.zeros(self._n, dtype=np.int64)
        # one device_get for all buckets: one synchronisation, not one
        # per bucket
        fetched = jax.device_get([dev for _, dev in self._parts])
        for (indices, _), scores in zip(self._parts, fetched):
            scores = np.asarray(scores)
            for pos, idx in enumerate(indices):
                out[idx] = scores[pos]
        return out


def dispatch_score_batch(tables, max_shift: int, params, *, affine: bool,
                         mesh: Mesh | None = None,
                         bucket_quantum: int = 64,
                         engine: str = "auto") -> PendingScores:
    """Pack and LAUNCH every bucket's fill without blocking.

    Same arguments/semantics as :func:`score_batch`; returns a
    :class:`PendingScores` instead of the assembled array.
    """
    tables = list(tables)
    _require_int32_safe(tables, params, affine)
    engine = backend.batch_engine(engine, max_shift)
    static = (max_shift, tuple(params), affine, engine)
    fn = _compiled(False, False, mesh, static)
    parts = []
    for b in make_buckets(tables, bucket_quantum).values():
        dev = fn(*_put(mesh, _pack(b, 0, len(b.indices), mesh)))
        parts.append((b.indices, dev))
    return PendingScores(len(tables), parts)


def score_batch(tables, max_shift: int, params, *, affine: bool,
                mesh: Mesh | None = None, bucket_quantum: int | None = None,
                engine: str = "auto"):
    """Score a batch of pairs; returns int scores in input order.

    ``params``: (beta, gamma, delta) for affine, (gamma, delta) otherwise.
    With ``mesh``, every bucket's batch axis is sharded over mesh axis
    "data" (the batch is padded to a multiple of the axis size).

    ``tables`` may also be a :class:`PreparedBatch` (device-resident
    buckets built once): scoring then skips the bucket rebuild and the
    host->device transfer entirely (steady-state serving path).
    """
    if isinstance(tables, PreparedBatch):
        tables.check_compatible(max_shift, params, affine, mesh,
                                engine=engine,
                                bucket_quantum=bucket_quantum)
        return tables.scores()

    if bucket_quantum is None:
        bucket_quantum = 64
    return dispatch_score_batch(
        tables, max_shift, params, affine=affine, mesh=mesh,
        bucket_quantum=bucket_quantum, engine=engine,
    ).get()


# -- batched alignments (corpus-scale traceback) ------------------------------
#
# The reference produces a FULL alignment per invocation
# (reference bialignment.pyx:513-586).  This path batches the
# traceback too: one fused dispatch per bucket-chunk fills the bands and
# walks them on the device, so the host receives only per-pair trace
# codes (O(n+m) ints each), not bands.

class PendingAlignments:
    """Dispatched-but-unharvested fused fill+walk chunks (the alignments
    twin of :class:`PendingScores`); :meth:`get` blocks, decodes the
    walk codes on host and assembles (scores, traces, complete)."""

    def __init__(self, n_pairs: int, parts):
        self._n = n_pairs
        self._parts = parts          # [(indices, affine, device_tuple)]

    @property
    def n_dispatches(self) -> int:
        """Fused fill+walk dispatches issued (one per bucket-chunk)."""
        return len(self._parts)

    def get(self):
        scores = np.zeros(self._n, dtype=np.int64)
        traces: list = [None] * self._n
        complete = [True] * self._n
        # one synchronisation for all chunks (see PendingScores.get)
        fetched = jax.device_get([dev for _, _, dev in self._parts])
        for (idxs, affine, _), got in zip(self._parts, fetched):
            if affine:
                codes, steps, done, scs = got
            else:
                codes, steps, scs = got
                done = None
            for pos, idx in enumerate(idxs):
                traces[idx] = dtb.decode_walk_codes(codes[pos],
                                                    int(steps[pos]))
                scores[idx] = int(scs[pos])
                if done is not None:
                    complete[idx] = int(done[pos]) == 1
        return scores, traces, complete


def _auto_chunk(N: int, M: int, max_shift: int, affine: bool,
                budget: int = 4 << 30) -> int:
    """Pairs per fused fill+walk dispatch, sized so one chunk's bands
    ``[B, N+M+1, Q, N+1, W, W]`` int32 stay under ``budget`` bytes of
    device memory; within that, larger chunks mean fewer dispatches."""
    W2 = (2 * max_shift + 1) ** 2
    q = N_STATES if affine else 1
    per_pair = (N + M + 1) * q * (N + 1) * W2 * 4
    return max(1, min(1024, budget // max(per_pair, 1)))


def dispatch_align_batch(tables, max_shift: int, params, *, affine: bool,
                         mesh: Mesh | None = None, bucket_quantum: int = 64,
                         chunk: int | None = None,
                         engine: str = "auto") -> PendingAlignments:
    """Pack and LAUNCH every bucket-chunk's fused fill+walk without
    blocking (same arguments as :func:`align_batch`); chunks queue on
    the device in dispatch order, so peak band memory stays one chunk's
    worth while the caller overlaps host packing of the next batch.
    ``chunk=None`` sizes chunks per bucket from the band-memory budget
    (:func:`_auto_chunk`)."""
    tables = list(tables)
    _require_int32_safe(tables, params, affine)
    engine = backend.batch_engine(engine, max_shift)
    fn = _compiled(False, True, mesh, (max_shift, tuple(params), affine,
                                       engine))
    parts = []
    for b in make_buckets(tables, bucket_quantum).values():
        bchunk = (_auto_chunk(b.N, b.M, max_shift, affine)
                  if chunk is None else chunk)
        for lo in range(0, len(b.indices), bchunk):
            hi = min(lo + bchunk, len(b.indices))
            dev = fn(*_put(mesh, _pack(b, lo, hi, mesh)))
            parts.append((b.indices[lo:hi], affine, dev))
    return PendingAlignments(len(tables), parts)


def align_batch(tables, max_shift: int, params, *, affine: bool,
                mesh: Mesh | None = None, bucket_quantum: int = 64,
                chunk: int | None = None, engine: str = "auto"):
    """Traces + scores for a batch of pairs, in input order.

    Returns ``(scores, traces, complete)``: int64 scores, per-pair
    forward trace lists (same (a, b, c, d) tuples as
    :meth:`bialign_tpu.BiAligner.traceback`, bit-exact including the
    reference's co-optimal tie-breaking — tests/test_batch.py), and
    per-pair completeness flags (False = the reference's
    incomplete-traceback warning case; non-affine walks always
    complete).

    ``chunk`` caps pairs per fused dispatch: the band for a chunk is
    materialized in device memory (B * D * Q * W^2 * (N+1) int32), so
    chunking bounds peak memory while the fill and walk still amortize
    dispatches.

    With ``mesh``, each chunk's batch axis is sharded over mesh axis
    "data" (chunk is padded to a multiple of the axis size): fills and
    walks run device-local.
    """
    return dispatch_align_batch(
        tables, max_shift, params, affine=affine, mesh=mesh,
        bucket_quantum=bucket_quantum, chunk=chunk, engine=engine,
    ).get()


# -- codes-input serving path (device-side table build) -----------------------
#
# The tables-input paths ship O(n*m) ints per pair to the device, and
# build them on the host first; the raw inputs are O(n) bytes.  The
# streaming driver therefore ships per-pair CODE vectors plus one
# device-resident 256x256 LUT, and the mu tables are built on the device
# (ops/device_tables.mu_planes_from_codes).  Protein scoring only — RNA
# mu2 keeps host float64 (scoring/tables.py).

def encode_pair(seqA: str, seqB: str, strA: str, strB: str):
    """1-based uint8 code vectors (index 0 unused = 0) for the
    device-LUT scoring path."""
    def enc(s):
        a = np.zeros(len(s) + 1, dtype=np.uint8)
        a[1:] = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
        return a

    return enc(seqA), enc(seqB), enc(strA), enc(strB)


def match_mismatch_lut(match: int, mismatch: int) -> np.ndarray:
    """256x256 LUT equivalent of the match/mismatch mu1 (tables.py
    sequence_similarity_table without a simmatrix)."""
    lut = np.full((256, 256), int(mismatch), dtype=np.int32)
    np.fill_diagonal(lut, int(match))
    return lut


def _require_int32_safe_codes(lut, sw, buckets, params, affine):
    """Codes-path twin of :func:`_require_int32_safe`: the mu magnitude
    bound comes from the LUT and structure weight instead of per-pair
    tables.  Additionally requires |LUT| < 2^24: the device LUT
    application is an exact one-hot f32 contraction ONLY while every
    entry is f32-representable (the int32 drift cert alone would admit
    larger values for very short pairs)."""
    amax = max(int(np.abs(np.asarray(lut)).max()), abs(int(sw)))
    if int(np.abs(np.asarray(lut)).max()) >= (1 << 24):
        raise ValueError(
            "similarity-matrix values must stay below 2^24 for the "
            "codes path's exact f32 LUT contraction; use the tables "
            "path (score_batch) for larger scores"
        )
    if affine:
        beta, gamma, delta = params
    else:
        beta = 0
        gamma, delta = params
    per_col = (2 * abs(int(gamma)) + 2 * abs(int(beta))
               + 2 * abs(int(delta)) + 2 * amax)
    worst = max(N + M for (N, M) in buckets)
    bound = 2 * (worst + 2) * per_col
    if not ((-(1 << 30)) - bound > np.iinfo(np.int32).min + (1 << 20)):
        raise ValueError(
            "scoring parameters/LUT exceed the certified int32 range "
            f"(value drift bound {bound}); score these pairs "
            "individually via BiAligner (engine='xla')"
        )


def _code_buckets(pairs, bucket_quantum: int, mesh=None):
    """Bucket (ca, cb, sa, sb) code-vector pairs by quantized shape into
    ``[B, N+1]`` / ``[B, M+1]`` uint8 arrays (the dense table shape the
    fills take), the batch padded to a multiple of the mesh's data
    axis."""
    buckets: dict = {}
    for idx, (ca, cb, sa, sb) in enumerate(pairs):
        n = len(ca) - 1
        m = len(cb) - 1
        N = quantize(n, bucket_quantum)
        M = quantize(m, bucket_quantum)
        b = buckets.setdefault((N, M), Bucket(N, M))
        b.indices.append(idx)
        b.mu1.append((ca, sa))      # reuse Bucket fields for codes
        b.mu2.append((cb, sb))
        b.n.append(n)
        b.m.append(m)

    packed = {}
    for (N, M), b in buckets.items():
        B = len(b.indices)
        Bp = B + _batch_pad(B, mesh)
        ca = np.zeros((Bp, N + 1), dtype=np.uint8)
        sa = np.zeros((Bp, N + 1), dtype=np.uint8)
        cb = np.zeros((Bp, M + 1), dtype=np.uint8)
        sb = np.zeros((Bp, M + 1), dtype=np.uint8)
        for pos in range(Bp):
            a_, s_ = b.mu1[min(pos, B - 1)]
            c_, t_ = b.mu2[min(pos, B - 1)]
            ca[pos, : len(a_)] = a_
            sa[pos, : len(s_)] = s_
            cb[pos, : len(c_)] = c_
            sb[pos, : len(t_)] = t_
        ns = np.asarray(b.n + [b.n[-1]] * (Bp - B), dtype=np.int32)
        ms = np.asarray(b.m + [b.m[-1]] * (Bp - B), dtype=np.int32)
        packed[(N, M)] = (b.indices, ca, cb, sa, sb, ns, ms)
    return packed


def dispatch_score_batch_codes(pairs, max_shift: int, params, *,
                               affine: bool, lut, structure_weight: int,
                               mesh: Mesh | None = None,
                               bucket_quantum: int = 64,
                               engine: str = "auto") -> PendingScores:
    """Launch batched scoring from code vectors (see module section
    doc).  ``pairs``: list of :func:`encode_pair` tuples; ``lut``: a
    [256, 256] int32 device (or host) array — pass the SAME array
    object across chunks so JAX reuses its device copy.  With ``mesh``,
    each bucket's batch axis is sharded over mesh axis "data"."""
    pairs = list(pairs)
    packed = _code_buckets(pairs, bucket_quantum, mesh)
    _require_int32_safe_codes(lut, structure_weight, packed, params,
                              affine)
    engine = backend.batch_engine(engine, max_shift)
    fn = _compiled(True, False, mesh, (max_shift, tuple(params),
                                       int(structure_weight), affine,
                                       engine))
    parts = []
    for indices, *arrays in packed.values():
        parts.append((indices, fn(*_put(mesh, arrays, lut))))
    return PendingScores(len(pairs), parts)


def dispatch_align_batch_codes(pairs, max_shift: int, params, *,
                               affine: bool, lut, structure_weight: int,
                               mesh: Mesh | None = None,
                               bucket_quantum: int = 64,
                               chunk: int | None = None,
                               engine: str = "auto") -> PendingAlignments:
    """Codes-input twin of :func:`dispatch_align_batch`."""
    pairs = list(pairs)
    packed = _code_buckets(pairs, bucket_quantum, mesh)
    _require_int32_safe_codes(lut, structure_weight, packed, params,
                              affine)
    engine = backend.batch_engine(engine, max_shift)
    fn = _compiled(True, True, mesh, (max_shift, tuple(params),
                                      int(structure_weight), affine,
                                      engine))
    parts = []
    for (N, M), (indices, *arrays) in packed.items():
        bchunk = (_auto_chunk(N, M, max_shift, affine)
                  if chunk is None else chunk)
        bchunk += _batch_pad(bchunk, mesh)
        for lo in range(0, len(indices), bchunk):
            idxs = indices[lo:lo + bchunk]
            # the tail chunk rides the bucket's mesh padding
            hi = min(lo + len(idxs) + _batch_pad(len(idxs), mesh),
                     arrays[0].shape[0])
            dev = fn(*_put(mesh, [a[lo:hi] for a in arrays], lut))
            parts.append((idxs, affine, dev))
    return PendingAlignments(len(pairs), parts)


# -- prepared (cached) device buckets -----------------------------------------

class PreparedBatch:
    """Device-resident buckets built once, scored many times.

    ``score_batch`` rebuilds buckets and re-transfers every table per
    call — right for one-shot streams, wasteful for steady-state serving
    where the same corpus (or the same shapes) is scored repeatedly.
    ``PreparedBatch`` does the host-side packing and the host->device
    transfer once; :meth:`scores` then runs only the fills.

    Accepted by :func:`score_batch` in place of ``tables``.
    """

    def __init__(self, tables, max_shift: int, params, *, affine: bool,
                 mesh: Mesh | None = None, bucket_quantum: int = 64,
                 engine: str = "auto"):
        tables = list(tables)
        _require_int32_safe(tables, params, affine)
        self.max_shift = max_shift
        self.params = tuple(params)
        self.affine = affine
        self.mesh = mesh
        self.bucket_quantum = bucket_quantum
        self.engine = backend.batch_engine(engine, max_shift)
        self.n_pairs = len(tables)
        self._buckets = [
            (b.indices, _put(mesh, _pack(b, 0, len(b.indices), mesh)))
            for b in make_buckets(tables, bucket_quantum).values()
        ]

    def check_compatible(self, max_shift: int, params, affine: bool,
                         mesh, *, engine: str = "auto",
                         bucket_quantum: int | None = None) -> None:
        """Fail loudly if a score_batch call's arguments differ from
        what this batch was prepared with — the prepared device arrays
        bake in those choices, so silently returning stale-parameter
        scores would be wrong results, not a cache hit.  The same
        strictness applies to an explicit ``engine`` or
        ``bucket_quantum`` that differs from the one the batch was
        built with."""
        got = (max_shift, tuple(params), affine, mesh)
        have = (self.max_shift, self.params, self.affine, self.mesh)
        if got != have:
            raise ValueError(
                "PreparedBatch was built with (max_shift, params, "
                f"affine, mesh)={have} but score_batch was called with "
                f"{got}; rebuild the PreparedBatch for the new settings"
            )
        if engine != "auto" and engine != self.engine:
            raise ValueError(
                f"engine={engine!r} conflicts with a PreparedBatch built "
                f"for engine {self.engine!r}; rebuild it or pass the raw "
                "tables to score_batch"
            )
        if bucket_quantum is not None and \
                bucket_quantum != self.bucket_quantum:
            raise ValueError(
                f"bucket_quantum={bucket_quantum} conflicts with the "
                f"PreparedBatch (built with {self.bucket_quantum}); "
                "rebuild it to re-bucket"
            )

    def scores(self) -> np.ndarray:
        """Score every pair; returns int64 scores in the original input
        order.  Only fill dispatches — no bucket rebuild, no transfer."""
        fn = _compiled(False, False, self.mesh,
                       (self.max_shift, self.params, self.affine,
                        self.engine))
        return PendingScores(self.n_pairs, [
            (indices, fn(*dev)) for indices, dev in self._buckets
        ]).get()
