"""Multi-chip production path: sharded verification over the 8-device
virtual CPU mesh (conftest.py) must agree with the single-device f64
oracle, and whole stages must produce byte-identical contigs."""

import numpy as np
import pytest

from haploconduct_tpu.core.reads import ReadStore
from haploconduct_tpu.ops.score import score_tasks_numpy
from haploconduct_tpu.parallel.mesh import device_count, sharded_score_tasks
from haploconduct_tpu.utils.config import Settings

from test_score import build_random_store, random_overlaps


def test_mesh_has_devices():
    assert device_count() >= 8  # conftest forces the virtual CPU mesh


def test_sharded_score_tasks_matches_oracle_exactly():
    """Integer outputs (counted, mismatches, rejected) are exact; sum_log
    is f32 vs f64. Includes multi-segment tasks (units longer than SEG)."""
    rng = np.random.default_rng(7)
    R, W = 96, 1400  # > SEG=512 so tasks decompose into multiple segments
    codes = np.full((R, W), 5, np.int8)
    quals = np.zeros((R, W), np.uint8)
    lens = rng.integers(200, W + 1, R).astype(np.int64)
    for i in range(R):
        codes[i, :lens[i]] = rng.integers(0, 4, lens[i])
        quals[i, :lens[i]] = rng.integers(2, 41, lens[i])
    B = 512
    row_a = rng.integers(0, R, B).astype(np.int64)
    row_b = rng.integers(0, R, B).astype(np.int64)
    pos = np.array([rng.integers(0, max(1, lens[a] - 50)) for a in row_a], np.int64)

    for thresh in (0.0, 0.3):
        ts = sharded_score_tasks(codes, quals, lens, row_a, row_b, pos,
                                 mismatch_thresh=thresh)
        to = score_tasks_numpy(codes, quals, lens, row_a, row_b, pos,
                               mismatch_thresh=thresh)
        np.testing.assert_array_equal(ts.counted, to.counted)
        np.testing.assert_array_equal(ts.mismatches, to.mismatches)
        np.testing.assert_array_equal(ts.rejected, to.rejected)
        np.testing.assert_allclose(ts.sum_log, to.sum_log, rtol=1e-4, atol=1e-3)


def test_sharded_score_tasks_beyond_row_cap():
    """Packed matrices taller than 65,536 rows must stay on the fast path
    (the reference's own envelope is 500-1000x coverage per patch,
    savage/README.md:313-319 — far above 32k reads). Row ids travel as full
    int32, so the mesh path must agree exactly with the f64 oracle on
    integer outputs at R > 2^16."""
    from haploconduct_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(17)
    R, W = (1 << 16) + 512, 64
    codes = rng.integers(0, 4, (R, W)).astype(np.int8)
    quals = rng.integers(2, 41, (R, W)).astype(np.uint8)
    lens = rng.integers(40, W + 1, R).astype(np.int64)
    B = 4096
    # force tasks onto rows above the old 16-bit cap
    row_a = rng.integers(R - 4096, R, B).astype(np.int64)
    row_b = rng.integers(0, R, B).astype(np.int64)
    pos = rng.integers(0, 30, B).astype(np.int64)

    mesh = make_mesh(2)  # small mesh: the replicated matrix is ~100MB/device
    ts = sharded_score_tasks(codes, quals, lens, row_a, row_b, pos, mesh=mesh)
    to = score_tasks_numpy(codes, quals, lens, row_a, row_b, pos)
    np.testing.assert_array_equal(ts.counted, to.counted)
    np.testing.assert_array_equal(ts.mismatches, to.mismatches)
    np.testing.assert_array_equal(ts.rejected, to.rejected)
    np.testing.assert_allclose(ts.sum_log, to.sum_log, rtol=1e-4, atol=1e-3)


def test_verify_overlaps_routes_through_mesh():
    from haploconduct_tpu.ops.verify import BACKEND_COUNTS, verify_overlaps

    rng = np.random.default_rng(8)
    store, _ = build_random_store(rng, n_single=10, n_paired=6)
    packed = store.pack()
    ov = random_overlaps(rng, store, 120)
    before = BACKEND_COUNTS["mesh"]
    r32 = verify_overlaps(store, packed, ov,
                          Settings(edge_threshold=0.5, ov_threshold=0.2,
                                   backend="jax", exact=True))
    assert BACKEND_COUNTS["mesh"] > before, "multi-device must use the mesh"
    r64 = verify_overlaps(store, packed, ov,
                          Settings(edge_threshold=0.5, ov_threshold=0.2,
                                   backend="numpy"))
    assert len(r32.edges) == len(r64.edges)
    np.testing.assert_array_equal(r32.nonedge_mask, r64.nonedge_mask)
    np.testing.assert_array_equal(r32.scored["mismatch_rate"],
                                  r64.scored["mismatch_rate"])


def test_full_stage_mesh_vs_oracle_byte_identical():
    """run_stage on the 8-device mesh == the single-device f64 oracle run,
    contig for contig, byte for byte."""
    from haploconduct_tpu.assemble.stages import StageParams, run_stage
    from haploconduct_tpu.io.sfo import sfo_to_overlaps
    from haploconduct_tpu.ops.kmer import find_overlap_candidates
    from haploconduct_tpu.utils.simulate import (
        mutate_sequence, random_genome, simulate_reads)

    rng = np.random.default_rng(5)
    genome = random_genome(rng, 3000)
    mut = mutate_sequence(genome, rng, sub_rate=0.01)
    haps = [genome, mut[0] if isinstance(mut, tuple) else mut]
    seqs, quals = simulate_reads(haps, coverage=25, read_len=150, rng=rng,
                                 error_rate=0.003)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    sseqs = [store.unit_codes(u) for u in range(store.n_units)]
    sfo = find_overlap_candidates(sseqs, min_overlap_len=90, k=20, error_rate=0.01)
    ov = sfo_to_overlaps(sfo, len(store), 0)

    results = {}
    for backend in ("numpy", "jax"):
        params = StageParams(stage="a", min_overlap_len=90, edge_threshold=0.97,
                             original_readcount=len(store), backend=backend)
        res = run_stage(params, store, ov)
        results[backend] = sorted(
            res.store.seq_str(i) for i in range(len(res.store)))
    assert results["numpy"] == results["jax"]
    assert len(results["numpy"]) > 0
