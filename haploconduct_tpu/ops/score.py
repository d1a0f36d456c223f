"""Pairwise quality-aware overlap scoring — the assembler's hot loop.

Math (reference src/EdgeCalculator.cpp:26-139): for an aligned pair of
sequence windows, each position contributes the probability that both bases
were sequenced from the same haplotype, derived from the two phred error
probabilities p1, p2:

    match:     p = (1-p1)(1-p2) + p1*p2/3
    mismatch:  p = (p1*(1-p2) + p2*(1-p1))/3 + (2/9)*p1*p2
    either N:  position skipped entirely

If any counted position has p < `mismatch_thresh` the overlap is rejected
outright. Otherwise score = exp(mean log p) over counted positions and
mismatch_rate = #mismatches / #counted.

A *task* is (row_a, row_b, pos): score row_a[pos:] against row_b[0:], with
rows taken from a PackedUnits matrix (orientation pre-resolved by row
index). Degenerate cases (pos >= len_a, read shorter than min_read_len,
zero counted positions) score 0 with mismatch_rate 1.0, exactly as the
reference's early returns leave it (src/EdgeCalculator.cpp:74-84, 129-131).

Two backends:
- numpy (float64): the oracle; bit-matches C++ double evaluation up to
  summation order.
- jax (float32 on device): the throughput path; callers re-check any result
  within `RECHECK_MARGIN` of a decision threshold on the oracle, so f32
  rounding can never flip an edge decision.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from ..core.reads import N_CODE, PAD_CODE

RECHECK_MARGIN = 2e-3  # |score - threshold| below this -> redo in f64


class TaskScores(NamedTuple):
    """Raw per-task scoring results (arrays of shape (B,))."""

    score: np.ndarray  # exp(mean log p), 0 for rejected/degenerate
    mismatch_rate: np.ndarray  # mismatches / counted, 1.0 for degenerate
    sum_log: np.ndarray
    counted: np.ndarray
    mismatches: np.ndarray
    rejected: np.ndarray  # hard per-position reject (p < mismatch_thresh)


@functools.lru_cache(maxsize=4)
def _phred_lut(dtype_name: str) -> np.ndarray:
    """Per-phred error probability, tabulated once (quals are uint8, so
    256 entries cover every input; each entry is the same elementwise
    expression the direct computation would evaluate -> bit-identical)."""
    q = np.arange(256, dtype=np.dtype(dtype_name))
    return np.power(10.0, -q / 10.0).astype(np.dtype(dtype_name))


def phred_probs(quals: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Phred (integer, ASCII-33 already removed) -> error probability."""
    if quals.dtype == np.uint8:
        return _phred_lut(np.dtype(dtype).name)[quals]
    return np.power(10.0, -quals.astype(dtype) / 10.0).astype(dtype)


@functools.lru_cache(maxsize=1)
def _pair_luts():
    """(p, log p) keyed by (q1, q2, match) — the same-haplotype probability
    algebra of EdgeCalculator.cpp:26-63 tabulated over all 256x256 phred
    pairs. Entries are computed with the identical elementwise float64
    expressions as the direct path, so gathered results are bit-identical;
    this removes the per-position pow/log transcendentals (the 10x-scale
    profile's top two hotspots)."""
    p1 = _phred_lut("float64")[:, None]
    p2 = _phred_lut("float64")[None, :]
    p_match = (1.0 - p1) * (1.0 - p2) + (p1 * p2) / 3.0
    p_mis = (p1 * (1.0 - p2) + p2 * (1.0 - p1)) / 3.0 + (2.0 / 9.0) * p1 * p2
    return (p_match.ravel(), p_mis.ravel(),
            np.log(p_match).ravel(), np.log(p_mis).ravel())


# --------------------------------------------------------------------------
# NumPy oracle (float64)
# --------------------------------------------------------------------------

def score_tasks_numpy(
    codes: np.ndarray,
    quals: np.ndarray,
    unit_lens_by_row: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    pos: np.ndarray,
    mismatch_thresh: float = 0.0,
    min_read_len: int = 0,
) -> TaskScores:
    """Vectorized float64 scoring over B tasks on padded (rows, W) matrices."""
    B = len(row_a)
    W = codes.shape[1]
    if B == 0:
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return TaskScores(z, z, z, zi, zi, np.zeros(0, dtype=bool))
    pos = np.asarray(pos, dtype=np.int64)
    len_a = unit_lens_by_row[row_a].astype(np.int64)
    len_b = unit_lens_by_row[row_b].astype(np.int64)

    a = codes[row_a]
    b = codes[row_b]
    qa = quals[row_a]
    qb = quals[row_b]
    col = np.arange(W, dtype=np.int64)[None, :]
    idx = np.minimum(pos[:, None] + col, W - 1)
    a_shift = np.take_along_axis(a, idx, axis=1)
    qa_shift = np.take_along_axis(qa, idx, axis=1)

    L = np.minimum(len_a - pos, len_b)
    valid = col < L[:, None]
    either_n = (a_shift >= N_CODE) | (b >= N_CODE)  # N or PAD
    counted_mask = valid & ~either_n

    match = a_shift == b
    # (q1, q2) -> probability via the tabulated pair algebra (bit-identical
    # to computing pow/log per position; see _pair_luts)
    lut_match, lut_mis, lut_logm, lut_logx = _pair_luts()
    pair_idx = (qa_shift.astype(np.int32) << 8) | qb
    log_p = np.where(match, lut_logm[pair_idx], lut_logx[pair_idx])

    if mismatch_thresh > 0.0:
        p = np.where(match, lut_match[pair_idx], lut_mis[pair_idx])
        rejected = np.any(counted_mask & (p < mismatch_thresh), axis=1)
    else:
        rejected = np.zeros(B, dtype=bool)
    sum_log = np.sum(np.where(counted_mask, log_p, 0.0), axis=1)
    counted = np.sum(counted_mask, axis=1).astype(np.int64)
    mismatches = np.sum(counted_mask & ~match, axis=1).astype(np.int64)

    degenerate = (pos >= len_a) | (len_a < min_read_len) | (len_b < min_read_len) | (counted == 0)
    ok = ~degenerate & ~rejected
    with np.errstate(divide="ignore", invalid="ignore"):
        score = np.where(ok, np.exp(sum_log / np.maximum(counted, 1)), 0.0)
        mism_rate = np.where(ok, mismatches / np.maximum(counted, 1), 1.0)
    return TaskScores(score, mism_rate, sum_log, counted, mismatches, rejected)


# --------------------------------------------------------------------------
# Native host backend (C++ OpenMP, float64)
# --------------------------------------------------------------------------

def score_tasks_native(
    codes: np.ndarray,
    quals: np.ndarray,
    unit_lens_by_row: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    pos: np.ndarray,
    mismatch_thresh: float = 0.0,
    min_read_len: int = 0,
) -> "TaskScores | None":
    """C++ OpenMP host engine (native/baseline_score.cpp:score_tasks_exact).

    One fused pass per task instead of numpy's ~10 full-matrix passes —
    ~20x the oracle's host throughput. Per-position probabilities come from
    the same _pair_luts() tables as the oracle, so only the serial (vs
    pairwise) summation order differs; callers run the RECHECK_MARGIN f64
    re-scoring (ops/verify.py) so edge decisions are bit-identical to the
    oracle. Returns None when the extension cannot be built.
    """
    from ..native import load_baseline_ext

    ext = load_baseline_ext()
    if ext is None or not hasattr(ext._m, "score_tasks_exact"):
        return None
    B = len(row_a)
    if B == 0:
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return TaskScores(z, z, z, zi, zi, np.zeros(0, dtype=bool))
    out = ext.score_tasks_exact(
        codes, quals, unit_lens_by_row, row_a, row_b, pos,
        mismatch_thresh, min_read_len, _pair_luts())
    return TaskScores(*out)


# --------------------------------------------------------------------------
# JAX device backend (float32)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _get_jax():
    import jax
    import jax.numpy as jnp

    from ..utils.jaxcache import enable_compile_cache

    enable_compile_cache()
    return jax, jnp


# --------------------------------------------------------------------------
# Segment ABI shared by every device path
# --------------------------------------------------------------------------
#
# Every task (row_a, row_b, pos) is decomposed on the host into SEG-lane
# subtasks: subtask k compares a[pos + k*SEG:] against b[k*SEG:] over
# min(SEG, L - k*SEG) lanes, and the per-subtask integers and f32 log sums
# are added back per task in f64 (reduce_segments_to_tasks). So f32
# accumulation never runs over more than SEG lanes, however long the
# contigs grow; RECHECK_MARGIN is pinned on that width (tests/test_score.py).
# The reference accumulates in C++ double (src/EdgeCalculator.cpp:26-139).

SEG = 512  # compare lanes per subtask


def pack_combined(codes: np.ndarray, quals: np.ndarray) -> np.ndarray:
    """Combine (R, W) packed unit matrices into one (R, W) int16 matrix of
    code | qual<<3 words (9 bits used), so a window is one gather per side.
    The width stays the longest unit's: device bodies clamp their indices to
    the row and mask lanes past each subtask's length."""
    return codes.astype(np.int16) | (quals.astype(np.int16) << 3)


def segment_tasks(row_a, row_b, pos, L):
    """Decompose tasks into SEG-lane subtasks.

    Returns (s_rowa, s_rowb, s_posa, s_bolen, task_bounds): s_posa is the
    A-side window start pos + k*SEG, s_bolen packs (k << 10) | seg_len, and
    task_bounds are np.add.reduceat boundaries mapping subtask outputs back
    to tasks. Row ids stay full int32, so the stream addresses packed
    matrices of any height. Degenerate tasks (L <= 0) get one zero-length
    subtask so every task produces exactly one reduction slot.
    """
    L = np.maximum(L, 0)
    nseg = np.maximum((L + SEG - 1) // SEG, 1).astype(np.int64)
    total = int(nseg.sum())
    task_of = np.repeat(np.arange(len(L), dtype=np.int64), nseg)
    bounds = np.concatenate([[0], np.cumsum(nseg)[:-1]])
    k = np.arange(total, dtype=np.int64) - np.repeat(bounds, nseg)
    bo = k * SEG
    seg_len = np.minimum(L[task_of] - bo, SEG)
    s_rowa = row_a[task_of].astype(np.int32)
    s_rowb = row_b[task_of].astype(np.int32)
    s_posa = (pos[task_of].astype(np.int64) + bo).astype(np.int32)
    s_bolen = ((k << 10) | seg_len).astype(np.int32)
    return s_rowa, s_rowb, s_posa, s_bolen, bounds


def task_lengths(unit_lens_by_row, row_a, row_b, pos):
    """(len_a, len_b, pos64, L): per-task row lengths and compared length
    (0 for pos >= len_a), as the segmenter and the reduction need them."""
    lens = unit_lens_by_row.astype(np.int64)
    len_a = lens[row_a]
    len_b = lens[row_b]
    pos64 = np.asarray(pos, dtype=np.int64)
    L = np.minimum(len_a - pos64, len_b)
    L = np.where(pos64 >= len_a, 0, L)
    return len_a, len_b, pos64, L


def xla_segment_body(mismatch_thresh: float):
    """Per-subtask scorer: (comb int16 matrix, rowa, rowb, posa, bolen) ->
    per-subtask (sum_log f32, counted i32, mismatches i32, rejected i32).
    Shared by the single-device path (score_tasks_jax) and the mesh path
    (parallel/mesh.py). The window is min(SEG, row width) lanes: a subtask
    never compares more lanes than the longest unit has."""
    jax, jnp = _get_jax()

    LOG10_OVER_10 = float(np.log(10.0) / 10.0)

    def body(comb, row_a, row_b, posa, bolen):
        rw = comb.shape[1]
        win = min(SEG, rw)
        bo = ((bolen >> 10) << 9).astype(jnp.int32)
        lt = (bolen & 1023).astype(jnp.int32)
        col = jax.lax.broadcasted_iota(jnp.int32, (1, win), 1)
        a_idx = jnp.minimum(posa[:, None] + col, rw - 1)
        b_idx = jnp.minimum(bo[:, None] + col, rw - 1)
        a_w = jnp.take_along_axis(comb[row_a], a_idx, axis=1).astype(jnp.int32)
        b_w = jnp.take_along_axis(comb[row_b], b_idx, axis=1).astype(jnp.int32)
        a = a_w & 7
        qa = a_w >> 3
        b = b_w & 7
        qb = b_w >> 3
        valid = col < lt[:, None]
        either_n = (a >= N_CODE) | (b >= N_CODE)
        cm = valid & jnp.logical_not(either_n)
        p1 = jnp.exp(qa.astype(jnp.float32) * (-LOG10_OVER_10))
        p2 = jnp.exp(qb.astype(jnp.float32) * (-LOG10_OVER_10))
        match = a == b
        p_match = (1.0 - p1) * (1.0 - p2) + (p1 * p2) * (1.0 / 3.0)
        p_mis = (p1 * (1.0 - p2) + p2 * (1.0 - p1)) * (1.0 / 3.0) + (2.0 / 9.0) * (p1 * p2)
        p = jnp.where(match, p_match, p_mis)
        rejected = jnp.sum((cm & (p < mismatch_thresh)).astype(jnp.int32), axis=1)
        sum_log = jnp.sum(jnp.where(cm, jnp.log(p), 0.0), axis=1)
        counted = jnp.sum(cm.astype(jnp.int32), axis=1)
        mism = jnp.sum((cm & jnp.logical_not(match)).astype(jnp.int32), axis=1)
        return sum_log, counted, mism, rejected

    return body


def reduce_segments_to_tasks(
    sub_cols,
    bounds: np.ndarray,
    pos64: np.ndarray,
    len_a: np.ndarray,
    len_b: np.ndarray,
    min_read_len: int,
) -> TaskScores:
    """Sum per-subtask (sum_log, counted, mism, rejected) host columns back
    to per-task TaskScores — the shared tail of every segmented backend."""
    sub_sumlog = np.asarray(sub_cols[0]).astype(np.float64)
    sub_counted = np.asarray(sub_cols[1]).astype(np.int64)
    sub_mism = np.asarray(sub_cols[2]).astype(np.int64)
    sub_rej = np.asarray(sub_cols[3]).astype(np.int64)
    sum_log = np.add.reduceat(sub_sumlog, bounds)
    counted = np.add.reduceat(sub_counted, bounds)
    mism = np.add.reduceat(sub_mism, bounds)
    rejected = np.add.reduceat(sub_rej, bounds) > 0

    degenerate = ((pos64 >= len_a) | (len_a < min_read_len)
                  | (len_b < min_read_len) | (counted == 0))
    ok = ~degenerate & ~rejected
    with np.errstate(divide="ignore", invalid="ignore"):
        score = np.where(ok, np.exp(sum_log / np.maximum(counted, 1)), 0.0)
        mism_rate = np.where(ok, mism / np.maximum(counted, 1), 1.0)
    return TaskScores(score, mism_rate, sum_log, counted, mism, rejected)


@functools.lru_cache(maxsize=16)
def _jit_segment_body(mismatch_thresh: float):
    jax, _ = _get_jax()
    return jax.jit(xla_segment_body(mismatch_thresh))


def score_tasks_jax(
    codes: np.ndarray,
    quals: np.ndarray,
    unit_lens_by_row: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    pos: np.ndarray,
    mismatch_thresh: float = 0.0,
    min_read_len: int = 0,
    batch_size: int = 1 << 16,
) -> TaskScores:
    """Device scoring via the segmented XLA formulation (any task width,
    f32 accumulation bounded to SEG lanes); returns numpy arrays."""
    _, jnp = _get_jax()
    B = len(row_a)
    if B == 0:
        return score_tasks_numpy(codes, quals, unit_lens_by_row, row_a, row_b, pos)
    combined = pack_combined(codes, quals)
    len_a, len_b, pos64, L = task_lengths(unit_lens_by_row, row_a, row_b, pos)
    s_rowa, s_rowb, s_posa, s_bolen, bounds = segment_tasks(
        np.asarray(row_a, np.int64), np.asarray(row_b, np.int64), pos64, L)
    n_sub = len(s_rowa)

    fn = _jit_segment_body(float(mismatch_thresh))
    comb_d = jnp.asarray(combined)
    dev_outs = []
    ns = []
    for start in range(0, n_sub, batch_size):
        end = min(start + batch_size, n_sub)
        n = end - start
        pad = (-n) % min(batch_size, 4096)
        cols_in = [s_rowa[start:end], s_rowb[start:end],
                   s_posa[start:end], s_bolen[start:end]]
        if pad:
            cols_in = [np.concatenate([c, np.zeros(pad, np.int32)])
                       for c in cols_in]
        dev_outs.append(fn(comb_d, *(jnp.asarray(c) for c in cols_in)))
        ns.append(n)
    sub_cols = [
        np.concatenate([np.asarray(d[j])[:n] for d, n in zip(dev_outs, ns)])
        if len(dev_outs) > 1 else np.asarray(dev_outs[0][j])[:ns[0]]
        for j in range(4)
    ]
    return reduce_segments_to_tasks(sub_cols, bounds, pos64, len_a, len_b,
                                    int(min_read_len))
