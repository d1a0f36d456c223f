"""Multi-chip scale-out of overlap verification.

Design (SURVEY §2f / §5): reads are replicated across chips (the packed
unit matrices are small relative to the candidate stream), candidate tasks
are sharded data-parallel along the mesh's "data" axis, and per-task
verification results ride back sharded; reductions (edge counts, histogram
stats) use psum. This mirrors the reference's only real
parallelism — OpenMP over overlap chunks (src/EdgeCalculator.cpp:395-423) —
lifted to a device mesh.

No NCCL/MPI translation: collectives are XLA's, laid out by shardings.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np


def make_mesh(n_devices: Optional[int] = None, axis: str = "data"):
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


@functools.lru_cache(maxsize=1)
def default_mesh():
    """The process-global data-parallel mesh over every visible device
    (across hosts when jax.distributed is initialized)."""
    return make_mesh()


def device_count() -> int:
    import jax

    return len(jax.devices())


# --------------------------------------------------------------------------
# Production sharded verification: the segment ABI of ops/score.py (comb
# int16 matrix + (rows, posa, bolen) subtask stream) shard_map-ed over the
# mesh's data axis. Each device runs the segment body on its slice, the
# packed matrix is replicated, results ride back sharded. This replaces the
# reference's OpenMP-over-overlap-chunks hot loop
# (src/EdgeCalculator.cpp:395-423).
# --------------------------------------------------------------------------

# Subtasks per device per scan step. Each step gathers a (SCAN_STEP, window)
# int16 tile per side and its f32 temporaries, so the step bounds the
# device memory of the scan body. On one NVIDIA H100 80GB HBM3 (400 W
# limit), 4M read-scale tasks through a one-device mesh took 0.61 s at
# 8192, 0.41 s at 32768, 0.44 s at 131072 and 0.40 s at 262144: 32768 is
# as fast as the largest step with an eighth of its temporaries.
SCAN_STEP = 32768

# Layout of the largest sharded_score_tasks input stream since the list was
# last cleared: one entry per device shard, {"device", "shape", "subtasks"}
# (subtasks = non-padding entries).
STREAM_SHARDS: list = []


@functools.lru_cache(maxsize=8)
def _sharded_scan_fn(mismatch_thresh: float, axis: str = "data",
                     packed_stream: bool = False):
    """One-dispatch sharded scorer over a (n_chunks, n_dev*SCAN_STEP)
    subtask stream: dim 1 is sharded across the mesh, and each device
    lax.scans the segment body over its (n_chunks, SCAN_STEP) slice on
    device, so the stream costs one transfer per input column, one
    dispatch and one fetch (reference anchor: the OpenMP chunk loop,
    src/EdgeCalculator.cpp:395-423).

    packed_stream: the host ships TWO int32 columns — rowa<<16|rowb and
    posa<<16|bolen — unpacked on device before the scan, halving the
    host->device bytes of the dominant transfer direction (legal whenever
    the packed matrix has <=65536 rows and width <=32768; the caller
    falls back to the 4-column ABI otherwise)."""
    import jax
    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    from ..ops.score import xla_segment_body

    kern = xla_segment_body(mismatch_thresh)

    def _scan(comb, ra, rb, pa, bl):
        import jax as _jax

        def step(_, xs):
            ra_c, rb_c, pa_c, bl_c = xs
            return 0, kern(comb, ra_c, rb_c, pa_c, bl_c)

        return _jax.lax.scan(step, 0, (ra, rb, pa, bl))[1]

    def body(comb, *cols):
        import jax as _jax
        import jax.numpy as jnp

        if packed_stream:
            ab, pm = cols
            ra = (ab >> 16) & 0xFFFF
            rb = ab & 0xFFFF
            pa = (pm >> 16) & 0xFFFF
            bl = pm & 0xFFFF
        else:
            ra, rb, pa, bl = cols
        sl, cn, mm, rj = _scan(comb, ra, rb, pa, bl)
        # Pack the 4 per-subtask outputs into ONE int32 array so the host
        # pays a single device->host fetch instead of four.
        # plane0 = f32 sum_log bit-exact via bitcast; plane1 = bitfield
        # (counted<<12 | mismatches<<1 | rejected>0) — counted/mism <= the
        # 1023 cap of the kernel's segment length field, and downstream
        # only ever tests rejected>0 (ops/score.py:reduce_segments_to_tasks).
        plane0 = _jax.lax.bitcast_convert_type(sl.astype(jnp.float32),
                                               jnp.int32)
        rj1 = jnp.minimum(rj, 1).astype(jnp.int32)
        plane1 = (cn.astype(jnp.int32) << 12) | (mm.astype(jnp.int32) << 1) | rj1
        return jnp.stack([plane0, plane1])

    n_cols = 2 if packed_stream else 4

    def build_uncached(mesh):
        specs = P(None, None, axis)
        in_specs = (P(),) + (P(None, axis),) * n_cols
        try:
            smapped = shard_map(
                body, mesh=mesh,
                in_specs=in_specs,
                out_specs=specs,
                check_vma=False,
            )
        except TypeError:
            smapped = shard_map(
                body, mesh=mesh,
                in_specs=in_specs,
                out_specs=specs,
                check_rep=False,
            )
        return jax.jit(smapped)

    # Cache the jitted shard_map per mesh: rebuilding it per call would
    # retrace and lower on every production dispatch.
    return functools.lru_cache(maxsize=8)(build_uncached)


def sharded_score_tasks(
    codes: np.ndarray,
    quals: np.ndarray,
    unit_lens_by_row: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    pos: np.ndarray,
    mismatch_thresh: float = 0.0,
    min_read_len: int = 0,
    mesh=None,
):
    """Mesh-sharded scoring with the score_tasks_* contract (TaskScores of
    host numpy arrays). The production multi-chip verification path: used
    by ops/verify.py whenever more than one device is visible.

    Multi-host safe: when the mesh spans processes (jax.distributed), the
    replicated packed matrix and the sharded subtask stream are built as
    global jax.Arrays via make_array_from_callback (every host holds the
    full host-side stream — the overlap planner is replicated host code),
    and outputs are fetched shard-by-addressable-shard and allgathered
    across processes. No row-count cap (row ids are full int32)."""
    from ..ops.score import (pack_combined, reduce_segments_to_tasks,
                             score_tasks_numpy, segment_tasks, task_lengths)

    from ..utils.jaxcache import enable_compile_cache

    b = len(row_a)
    if b == 0:
        return score_tasks_numpy(codes, quals, unit_lens_by_row, row_a, row_b, pos)
    enable_compile_cache()
    if mesh is None:
        mesh = default_mesh()
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))

    combined = pack_combined(codes, quals)
    len_a, len_b, pos64, L = task_lengths(unit_lens_by_row, row_a, row_b, pos)
    s_rowa, s_rowb, s_posa, s_bolen, bounds = segment_tasks(
        row_a.astype(np.int64), row_b.astype(np.int64), pos64, L)
    n_sub = len(s_rowa)
    # Shape the whole stream as (n_chunks, n_dev*SCAN_STEP): dim 1 shards
    # across the mesh and each device scans its rows on device — one
    # transfer per input column, one dispatch, one fetch. n_chunks is padded
    # to the next power of two so compile cache entries stay bounded as
    # stream sizes vary.
    step = n_dev * SCAN_STEP
    n_chunks = max((n_sub + step - 1) // step, 1)
    n_chunks = 1 << (n_chunks - 1).bit_length()
    total = n_chunks * step
    # Packed 2-column stream (8B/subtask over the link instead of 16B)
    # whenever row ids and posa/bolen statically fit 16 bits each; the
    # 4-column ABI remains for giant matrices (no row cap overall).
    packed_ok = combined.shape[0] <= 65536 and combined.shape[1] <= 32768
    if packed_ok:
        ab = ((s_rowa.astype(np.uint32) << 16)
              | s_rowb.astype(np.uint32)).view(np.int32)
        pm = ((s_posa.astype(np.uint32) << 16)
              | s_bolen.astype(np.uint32)).view(np.int32)
        host_cols = (ab, pm)
    else:
        host_cols = (s_rowa, s_rowb, s_posa, s_bolen)
    fn = _sharded_scan_fn(float(mismatch_thresh),
                          packed_stream=packed_ok)(mesh)
    comb_d = _make_global(mesh, combined, replicated=True)
    # Subtask i goes to device i % n_dev, so every device gets an equal
    # share of the real subtasks and the padding is spread over all of them.
    ins = []
    for c in host_cols:
        arr = c
        if total - n_sub:
            arr = np.concatenate([arr, np.zeros(total - n_sub, np.int32)])
        arr = arr.reshape(n_chunks, SCAN_STEP, n_dev).transpose(0, 2, 1)
        ins.append(_make_global(mesh, arr.reshape(n_chunks, step), spec_dim=1))
    _record_layout(ins[0], n_sub, n_dev)
    outs = fn(comb_d, *ins)
    # ONE fetch: (2, n_chunks, step) int32; plane0 = bit-cast f32 sum_log,
    # plane1 = counted<<12 | mism<<1 | rejected (see _sharded_scan_fn.body)
    packed_out = _fetch_global(outs, mesh, spec_dim=2)
    packed_out = packed_out.reshape(2, n_chunks, n_dev, SCAN_STEP)
    packed_out = packed_out.transpose(0, 1, 3, 2).reshape(2, -1)
    p0 = np.ascontiguousarray(packed_out[0]).view(np.float32)[:n_sub]
    p1 = packed_out[1][:n_sub]
    fetched = [p0, p1 >> 12, (p1 >> 1) & 0x7FF, p1 & 1]
    return reduce_segments_to_tasks(fetched, bounds, pos64, len_a, len_b,
                                    int(min_read_len))


def _record_layout(arr, n_sub: int, n_dev: int) -> None:
    """Fill STREAM_SHARDS from a (n_chunks, n_dev*SCAN_STEP) stream column
    if it is the largest seen: which device holds which columns, and how
    many real subtasks that is (column d*SCAN_STEP + j of chunk c holds
    subtask (c*SCAN_STEP + j)*n_dev + d)."""
    if sum(s["subtasks"] for s in STREAM_SHARDS) > n_sub:
        return
    n_chunks, step = arr.shape
    col = np.arange(step)
    flat = ((np.arange(n_chunks)[:, None] * SCAN_STEP + col % SCAN_STEP)
            * n_dev + col // SCAN_STEP)
    STREAM_SHARDS.clear()
    for shard in arr.addressable_shards:
        STREAM_SHARDS.append({
            "device": shard.device, "shape": tuple(shard.data.shape),
            "subtasks": int(np.sum(flat[:, shard.index[1]] < n_sub))})


def _make_global(mesh, host_arr: np.ndarray, replicated: bool = False,
                 spec_dim: int = 0):
    """Build a global jax.Array over `mesh` from a host array every process
    holds in full. Single-process: a plain device_put with the sharding.
    Multi-host: make_array_from_callback slices each addressable shard out
    of the full host copy — the documented-safe construction (the classic
    pitfall is feeding a process-local jnp.asarray to a global-mesh jit).
    `spec_dim` picks which dimension the mesh axis shards (0 for flat
    streams, 1 for the (n_chunks, n_dev*SCAN_STEP) scan layout)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = mesh.axis_names[0]
    if replicated:
        spec = P()
    elif spec_dim == 0:
        spec = P(axis)
    else:
        spec = P(*([None] * spec_dim + [axis]))
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(host_arr, sharding)
    return jax.make_array_from_callback(
        host_arr.shape, sharding, lambda idx: host_arr[idx])


def _fetch_global(arr, mesh, spec_dim: int = 0) -> np.ndarray:
    """Fetch a mesh-axis-sharded global output to a full host numpy array
    on every process. Single-process arrays are fully addressable;
    multi-host, each process reassembles its addressable shards and
    allgathers the rest over DCN (graph phases downstream are replicated
    host code that needs the complete verified stream, SURVEY §5
    distributed-backend note). `spec_dim` names the sharded dimension;
    with a 1-D device mesh built from jax.devices() the device order is
    process-major, so per-process blocks concatenate in process order
    along that dimension."""
    import jax

    if jax.process_count() == 1:
        return np.asarray(arr)
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    spec = P(axis) if spec_dim == 0 else P(*([None] * spec_dim + [axis]))
    local = multihost_utils.global_array_to_host_local_array(arr, mesh, spec)
    gathered = multihost_utils.process_allgather(np.asarray(local))
    # gathered: (n_proc, *local_shape); stitch along the sharded dim
    return np.concatenate(list(gathered), axis=spec_dim)


@functools.lru_cache(maxsize=8)
def sharded_score_fn(width: int, mismatch_thresh: float, min_read_len: int, axis: str = "data"):
    """Build a pjit-ed scorer: tasks sharded over the mesh axis, packed
    read matrices replicated. Returns fn(mesh, codes, quals, lens, row_a,
    row_b, pos) -> (score, mism_rate, counted, mismatches, n_edges_psum)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..core.reads import N_CODE

    LOG10_OVER_10 = float(np.log(10.0) / 10.0)

    def kernel(codes, quals, lens_by_row, row_a, row_b, pos):
        a = codes[row_a]
        b = codes[row_b]
        qa = quals[row_a]
        qb = quals[row_b]
        pos_i = pos.astype(jnp.int32)
        len_a = lens_by_row[row_a].astype(jnp.int32)
        len_b = lens_by_row[row_b].astype(jnp.int32)
        col = jax.lax.broadcasted_iota(jnp.int32, (1, width), 1)
        idx = jnp.minimum(pos_i[:, None] + col, width - 1)
        a_shift = jnp.take_along_axis(a, idx, axis=1)
        qa_shift = jnp.take_along_axis(qa, idx, axis=1)
        L = jnp.minimum(len_a - pos_i, len_b)
        valid = col < L[:, None]
        either_n = (a_shift >= N_CODE) | (b >= N_CODE)
        counted_mask = valid & jnp.logical_not(either_n)
        p1 = jnp.exp(qa_shift.astype(jnp.float32) * (-LOG10_OVER_10))
        p2 = jnp.exp(qb.astype(jnp.float32) * (-LOG10_OVER_10))
        match = a_shift == b
        p_match = (1.0 - p1) * (1.0 - p2) + (p1 * p2) * (1.0 / 3.0)
        p_mis = (p1 * (1.0 - p2) + p2 * (1.0 - p1)) * (1.0 / 3.0) + (2.0 / 9.0) * (p1 * p2)
        p = jnp.where(match, p_match, p_mis)
        rejected = jnp.any(counted_mask & (p < mismatch_thresh), axis=1)
        sum_log = jnp.sum(jnp.where(counted_mask, jnp.log(p), 0.0), axis=1)
        counted = jnp.sum(counted_mask, axis=1).astype(jnp.int32)
        mismatches = jnp.sum(counted_mask & jnp.logical_not(match), axis=1).astype(jnp.int32)
        degenerate = (pos_i >= len_a) | (len_a < min_read_len) | (len_b < min_read_len) | (counted == 0)
        ok = jnp.logical_not(degenerate) & jnp.logical_not(rejected)
        denom = jnp.maximum(counted, 1).astype(jnp.float32)
        score = jnp.where(ok, jnp.exp(sum_log / denom), 0.0)
        mism_rate = jnp.where(ok, mismatches.astype(jnp.float32) / denom, 1.0)
        return score, mism_rate, counted, mismatches

    def build(mesh):
        repl = NamedSharding(mesh, P())
        shard0 = NamedSharding(mesh, P(axis))
        return jax.jit(
            kernel,
            in_shardings=(repl, repl, repl, shard0, shard0, shard0),
            out_shardings=(shard0, shard0, shard0, shard0),
        )

    return functools.lru_cache(maxsize=8)(build)


@functools.lru_cache(maxsize=8)
def sharded_pipeline_fn(R: int, W: int, k: int, expand: int,
                        edge_threshold: float, min_overlap_len: int,
                        axis: str = "data"):
    """The full sharded assembly step: device k-mer join (candidate
    generation) + phred-aware verification + edge-count reduction, SPMD
    over the mesh's data axis.

    Sharding layout: the k-mer TABLE (sorted hashes over all reads) and the
    packed read/qual matrices are replicated; the QUERY k-mer rows are
    sharded, so each chip joins its slice of reads against the full table,
    verifies its candidate diagonals locally, and the accepted-edge count
    is a psum. This is the production mapping of SURVEY §2f: per-chunk
    OpenMP data parallelism lifted to a device mesh, with XLA collectives
    instead of the filesystem."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..core.reads import N_CODE

    NK = W - k + 1
    LOG10_OVER_10 = float(np.log(10.0) / 10.0)

    def kmer_hashes(codes):
        h = jnp.zeros(codes[:, :NK].shape, jnp.int32)
        bad = jnp.zeros(codes[:, :NK].shape, jnp.bool_)
        for j in range(k):
            c = codes[:, j:j + NK].astype(jnp.int32)
            h = h * 4 + jnp.where(c < N_CODE, c, 0)
            bad = bad | (c >= N_CODE)
        return jnp.where(bad, -1, h)

    def step(q_codes, codes, quals, lens, tkey, t_rid, t_pos):
        # q_codes: the same read matrix, sharded by row — the query side.
        # codes/quals/lens: replicated gather targets (any candidate's
        # partner row may live on another chip's query slice).
        qh = kmer_hashes(q_codes)  # (R, NK), sharded by row
        rows = jax.lax.broadcasted_iota(jnp.int32, (R, NK), 0)
        poss = jax.lax.broadcasted_iota(jnp.int32, (R, NK), 1)
        left = jnp.searchsorted(tkey, qh.reshape(-1), side="left").astype(jnp.int32)
        count = (jnp.searchsorted(tkey, qh.reshape(-1), side="right").astype(jnp.int32)
                 - left)
        ok_q = (qh.reshape(-1) >= 0)
        q_rid = rows.reshape(-1)
        q_pos = poss.reshape(-1)
        scores = []
        n_edges = jnp.int32(0)
        for d in range(expand):
            t_idx = jnp.minimum(left + d, tkey.shape[0] - 1)
            valid = ok_q & (d < count)
            rid_b = t_rid[t_idx]
            valid &= rid_b != q_rid
            shift = q_pos - t_pos[t_idx]
            valid &= shift >= 0  # canonical half; mirrored pair covers rest
            # verify the diagonal: score codes[q_rid, shift:] vs codes[rid_b, :]
            col = jax.lax.broadcasted_iota(jnp.int32, (valid.shape[0], W), 1)
            idx = jnp.minimum(shift[:, None] + col, W - 1)
            a = jnp.take_along_axis(codes[q_rid], idx, axis=1)
            qa = jnp.take_along_axis(quals[q_rid], idx, axis=1)
            b = codes[rid_b]
            qb = quals[rid_b]
            L = jnp.minimum(lens[q_rid] - shift, lens[rid_b])
            cm = (col < L[:, None]) & (a < N_CODE) & (b < N_CODE)
            p1 = jnp.exp(qa.astype(jnp.float32) * (-LOG10_OVER_10))
            p2 = jnp.exp(qb.astype(jnp.float32) * (-LOG10_OVER_10))
            match = a == b
            p_match = (1.0 - p1) * (1.0 - p2) + (p1 * p2) * (1.0 / 3.0)
            p_mis = ((p1 * (1.0 - p2) + p2 * (1.0 - p1)) * (1.0 / 3.0)
                     + (2.0 / 9.0) * (p1 * p2))
            p = jnp.where(match, p_match, p_mis)
            sum_log = jnp.sum(jnp.where(cm, jnp.log(p), 0.0), axis=1)
            counted = jnp.sum(cm, axis=1)
            ok = valid & (counted >= min_overlap_len)
            score = jnp.where(ok, jnp.exp(sum_log / jnp.maximum(counted, 1)), 0.0)
            scores.append(score)
            n_edges += jnp.sum((score > edge_threshold).astype(jnp.int32))
        return jnp.stack(scores, axis=1), n_edges

    def build(mesh):
        repl = NamedSharding(mesh, P())
        shard0 = NamedSharding(mesh, P(axis))
        return jax.jit(
            step,
            in_shardings=(shard0, repl, repl, repl, repl, repl, repl),
            out_shardings=(shard0, repl),
        )

    return build


def sharded_assembly_step(mesh, codes: np.ndarray, quals: np.ndarray,
                          lens: np.ndarray, k: int = 13, expand: int = 8,
                          edge_threshold: float = 0.97,
                          min_overlap_len: int = 30):
    """DEMO wrapper (the dryrun's join+verify smoke): sorted k-mer table on
    host, then the sharded join+verify step on the mesh. Returns
    (per-candidate-slot score matrix, accepted candidate-SLOT count). The
    count is per (query k-mer, expand slot) above threshold — a pair
    sharing S seed k-mers on one diagonal is counted up to S times and only
    forward-strand joins are made — so it is NOT a deduplicated edge count.
    The production path is sharded_score_tasks + ops/verify.py, which
    dedups via the overlap planner."""
    import jax.numpy as jnp

    R, W = codes.shape
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    pad_rows = (-R) % n_dev
    if pad_rows:
        from ..core.reads import PAD_CODE

        codes = np.concatenate([codes, np.full((pad_rows, W), PAD_CODE, codes.dtype)])
        quals = np.concatenate([quals, np.zeros((pad_rows, W), quals.dtype)])
        lens = np.concatenate([lens, np.zeros(pad_rows, lens.dtype)])
    Rp = R + pad_rows

    # host-side sorted table (hash, rid, pos) over forward k-mers
    from ..ops.kmer import _kmer_hashes

    NK = W - k + 1
    hs, rids, poss = [], [], []
    for r in range(Rp):
        h = _kmer_hashes(codes[r], k)[:NK]
        hs.append(h)
        rids.append(np.full(len(h), r, np.int32))
        poss.append(np.arange(len(h), dtype=np.int32))
    h = np.concatenate(hs)
    rid = np.concatenate(rids)
    pos = np.concatenate(poss)
    h32 = np.where(h >= 0, h, np.int64(2**31 - 1)).astype(np.int32)
    order = np.argsort(h32, kind="stable")

    fn = sharded_pipeline_fn(Rp, W, k, expand, float(edge_threshold),
                             int(min_overlap_len))(mesh)
    scores, n_edges = fn(
        jnp.asarray(codes), jnp.asarray(codes),
        jnp.asarray(quals.astype(np.int8)),
        jnp.asarray(lens.astype(np.int32)),
        jnp.asarray(h32[order]), jnp.asarray(rid[order]), jnp.asarray(pos[order]))
    return np.asarray(scores)[:R * NK], int(n_edges)


def sharded_verify(
    mesh,
    codes: np.ndarray,
    quals: np.ndarray,
    lens_by_row: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    pos: np.ndarray,
    mismatch_thresh: float = 0.0,
    min_read_len: int = 0,
):
    """Run sharded verification over a mesh; pads the task list to a
    multiple of the mesh size and strips the padding on return."""
    import jax.numpy as jnp

    n = len(row_a)
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    pad = (-n) % max(n_dev, 1)
    if pad:
        row_a = np.concatenate([row_a, np.zeros(pad, row_a.dtype)])
        row_b = np.concatenate([row_b, np.zeros(pad, row_b.dtype)])
        pos = np.concatenate([pos, np.zeros(pad, pos.dtype)])
    fn = sharded_score_fn(codes.shape[1], float(mismatch_thresh), int(min_read_len))(mesh)
    out = fn(
        jnp.asarray(codes), jnp.asarray(quals),
        jnp.asarray(lens_by_row.astype(np.int32)),
        jnp.asarray(row_a.astype(np.int32)), jnp.asarray(row_b.astype(np.int32)),
        jnp.asarray(pos.astype(np.int32)),
    )
    return tuple(np.asarray(o)[:n] for o in out)
