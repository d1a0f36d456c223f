import numpy as np
import pytest

from haploconduct_tpu.core.reads import ReadStore
from haploconduct_tpu.io.overlaps import empty_overlaps
from haploconduct_tpu.ops.score import score_tasks_jax, score_tasks_numpy
from haploconduct_tpu.ops.verify import plan_tasks, verify_overlaps
from haploconduct_tpu.utils.config import Settings

from reference_model import SimpleRead, compute_overlap, overlap_score

BASES = "ACGT"
QUALS = "".join(chr(33 + q) for q in range(2, 42))


def random_seq(rng, n, n_rate=0.02):
    chars = [BASES[rng.integers(4)] if rng.random() > n_rate else "N" for _ in range(n)]
    return "".join(chars)


def random_phred(rng, n):
    return "".join(QUALS[rng.integers(len(QUALS))] for _ in range(n))


def build_random_store(rng, n_single=12, n_paired=8, lmin=40, lmax=90):
    store = ReadStore()
    reads = []
    for i in range(n_single):
        n = int(rng.integers(lmin, lmax))
        seq, ph = random_seq(rng, n), random_phred(rng, n)
        store.add_single(i, seq, ph)
        reads.append(SimpleRead((seq,), (ph,)))
    store.readcount_single = n_single
    for i in range(n_paired):
        n1 = int(rng.integers(lmin, lmax))
        n2 = int(rng.integers(lmin, lmax))
        s1, p1 = random_seq(rng, n1), random_phred(rng, n1)
        s2, p2 = random_seq(rng, n2), random_phred(rng, n2)
        store.add_paired(n_single + i, s1, p1, s2, p2)
        reads.append(SimpleRead((s1, s2), (p1, p2)))
    return store, reads


def random_overlaps(rng, store, n_ov=200):
    n = len(store)
    ov = empty_overlaps(n_ov)
    for k in range(n_ov):
        i, j = rng.choice(n, size=2, replace=False)
        pa, pb = store.is_paired[i], store.is_paired[j]
        ov[k]["id1"], ov[k]["id2"] = store.ids[i], store.ids[j]
        ov[k]["pos1"] = int(rng.integers(0, 60))
        ov[k]["pos2"] = int(rng.integers(0, 60)) if (pa or pb) else 0
        ov[k]["ord"] = [b"1", b"2"][rng.integers(2)] if (pa and pb) else b"-"
        ov[k]["ori1"] = [b"+", b"-"][rng.integers(2)]
        ov[k]["ori2"] = [b"+", b"-"][rng.integers(2)]
        ov[k]["perc1"] = int(rng.integers(0, 101))
        ov[k]["perc2"] = int(rng.integers(0, 101)) if (pa or pb) else 0
        ov[k]["len1"] = int(rng.integers(1, 90))
        ov[k]["len2"] = int(rng.integers(1, 90)) if (pa or pb) else 0
        ov[k]["type1"] = b"p" if pa else b"s"
        ov[k]["type2"] = b"p" if pb else b"s"
    return ov


def test_oracle_matches_scalar_model():
    rng = np.random.default_rng(0)
    store, reads = build_random_store(rng)
    packed = store.pack()
    ov = random_overlaps(rng, store, 300)
    plan, meta = plan_tasks(store, packed, ov)
    lens_by_row = np.concatenate([packed.lens, packed.lens])
    ts = score_tasks_numpy(
        packed.codes, packed.quals, lens_by_row,
        plan.row_first, plan.row_second, plan.pos,
    )
    s = Settings(edge_threshold=0.97)
    from haploconduct_tpu.ops.verify import combine_scores

    edges = combine_scores(ov, plan, meta, ts, s)
    for k in range(len(ov)):
        i = store.id_to_index[int(ov[k]["id1"])]
        j = store.id_to_index[int(ov[k]["id2"])]
        score, mm, pos3, pos4 = compute_overlap(
            reads[i], reads[j], int(ov[k]["pos1"]), int(ov[k]["pos2"]),
            ov[k]["ord"].decode(), ov[k]["ori1"] == b"+", ov[k]["ori2"] == b"+",
            edge_threshold=0.97,
        )
        assert edges["score"][k] == pytest.approx(score, abs=1e-12), k
        assert edges["mismatch_rate"][k] == pytest.approx(mm, abs=1e-12), k
        assert edges["pos3"][k] == pos3, k
        assert edges["pos4"][k] == pos4, k


def test_jax_matches_oracle():
    rng = np.random.default_rng(1)
    store, _ = build_random_store(rng, n_single=20, n_paired=10)
    packed = store.pack()
    ov = random_overlaps(rng, store, 400)
    plan, _ = plan_tasks(store, packed, ov)
    lens_by_row = np.concatenate([packed.lens, packed.lens])
    args = (packed.codes, packed.quals, lens_by_row, plan.row_first, plan.row_second, plan.pos)
    ts64 = score_tasks_numpy(*args)
    ts32 = score_tasks_jax(*args, batch_size=128)
    np.testing.assert_array_equal(ts64.counted, ts32.counted)
    np.testing.assert_array_equal(ts64.mismatches, ts32.mismatches)
    np.testing.assert_array_equal(ts64.rejected, ts32.rejected)
    np.testing.assert_allclose(ts32.score, ts64.score, atol=2e-4)


def test_hard_mismatch_reject():
    store = ReadStore()
    store.add_single(0, "AAAA", "IIII")
    store.add_single(1, "AAAT", "IIII")
    packed = store.pack()
    lens = np.concatenate([packed.lens, packed.lens])
    # q=40 both: mismatch prob ~ 6.7e-5 < 0.5 -> reject whole overlap
    ts = score_tasks_numpy(
        packed.codes, packed.quals, lens,
        np.array([0]), np.array([1]), np.array([0]), mismatch_thresh=0.5,
    )
    assert ts.score[0] == 0.0
    assert ts.mismatch_rate[0] == 1.0
    assert ts.rejected[0]


def test_degenerate_pos_and_minlen():
    store = ReadStore()
    store.add_single(0, "ACGTACGT", "IIIIIIII")
    store.add_single(1, "ACGTACGT", "IIIIIIII")
    packed = store.pack()
    lens = np.concatenate([packed.lens, packed.lens])
    ts = score_tasks_numpy(
        packed.codes, packed.quals, lens,
        np.array([0, 0]), np.array([1, 1]), np.array([8, 0]), min_read_len=9,
    )
    # pos >= len -> 0; min_read_len unmet -> 0
    assert np.all(ts.score == 0.0)
    assert np.all(ts.mismatch_rate == 1.0)


def test_all_n_overlap_scores_zero():
    store = ReadStore()
    store.add_single(0, "NNNN", "IIII")
    store.add_single(1, "ACGT", "IIII")
    packed = store.pack()
    lens = np.concatenate([packed.lens, packed.lens])
    ts = score_tasks_numpy(
        packed.codes, packed.quals, lens, np.array([0]), np.array([1]), np.array([0])
    )
    assert ts.score[0] == 0.0 and ts.counted[0] == 0


def test_perfect_overlap_scalar():
    # sanity against hand math: identical bases at q=40
    score, mm = overlap_score("AAAA", "AAAA", "IIII", "IIII", 0)
    q = 10 ** (-40 / 10)
    expected = (1 - q) * (1 - q) + q * q / 3
    assert score == pytest.approx(expected, rel=1e-12)
    assert mm == 0.0


def test_verify_overlaps_end_to_end():
    rng = np.random.default_rng(3)
    store, reads = build_random_store(rng, n_single=10, n_paired=6)
    packed = store.pack()
    ov = random_overlaps(rng, store, 150)
    s = Settings(edge_threshold=0.5, ov_threshold=0.2, backend="numpy")
    res = verify_overlaps(store, packed, ov, s)
    assert res.n_tasks >= len(ov)
    assert len(res.scored) == len(ov)
    # every accepted edge must beat a threshold
    ok = (res.edges["score"] > s.edge_threshold) | (res.edges["mismatch_rate"] <= s.merge_contigs)
    assert np.all(ok)


def test_verify_backends_agree():
    rng = np.random.default_rng(4)
    store, _ = build_random_store(rng, n_single=10, n_paired=6)
    packed = store.pack()
    ov = random_overlaps(rng, store, 150)
    s64 = Settings(edge_threshold=0.5, ov_threshold=0.2, backend="numpy")
    s32 = Settings(edge_threshold=0.5, ov_threshold=0.2, backend="jax", exact=True)
    r64 = verify_overlaps(store, packed, ov, s64)
    r32 = verify_overlaps(store, packed, ov, s32)
    assert len(r64.edges) == len(r32.edges)
    np.testing.assert_array_equal(r64.nonedge_mask, r32.nonedge_mask)
    np.testing.assert_array_equal(r64.edges["v1"], r32.edges["v1"])
    np.testing.assert_array_equal(r64.edges["v2"], r32.edges["v2"])


def test_unattainable_threshold_skips_recheck():
    """POLYTE merge iterations run edge_threshold=1.0; scores are < 1.0 by
    construction so NOTHING near that threshold needs f64 re-scoring (it
    used to re-run the oracle on nearly every high-quality task), and the
    decisions must still match the oracle exactly."""
    from haploconduct_tpu.ops.verify import RECHECK_STATS

    rng = np.random.default_rng(11)
    store, _ = build_random_store(rng, n_single=14, n_paired=6)
    packed = store.pack()
    ov = random_overlaps(rng, store, 200)
    s64 = Settings(edge_threshold=1.0, ov_threshold=0.0, merge_contigs=0.02,
                   backend="numpy")
    r64 = verify_overlaps(store, packed, ov, s64)
    for backend in ("native", "jax"):
        sdev = s64.derive(backend=backend)
        rdev = verify_overlaps(store, packed, ov, sdev)
        assert RECHECK_STATS["tasks"] == 0
        assert RECHECK_STATS["overlaps"] == 0
        np.testing.assert_array_equal(r64.nonedge_mask, rdev.nonedge_mask)
        np.testing.assert_array_equal(r64.edges["v1"], rdev.edges["v1"])
        np.testing.assert_array_equal(r64.edges["v2"], rdev.edges["v2"])


def test_native_matches_oracle():
    """C++ host engine (score_tasks_exact): exact integers, ulp-close scores,
    and identical verify_overlaps edge decisions vs the f64 oracle."""
    from haploconduct_tpu.ops.score import score_tasks_native

    rng = np.random.default_rng(7)
    store, _ = build_random_store(rng, n_single=20, n_paired=10)
    packed = store.pack()
    ov = random_overlaps(rng, store, 400)
    plan, _ = plan_tasks(store, packed, ov)
    lens_by_row = np.concatenate([packed.lens, packed.lens])
    args = (packed.codes, packed.quals, lens_by_row,
            plan.row_first, plan.row_second, plan.pos)
    for kw in (dict(), dict(mismatch_thresh=0.3, min_read_len=45)):
        ts64 = score_tasks_numpy(*args, **kw)
        tsn = score_tasks_native(*args, **kw)
        if tsn is None:
            pytest.skip("native extension unavailable")
        np.testing.assert_array_equal(ts64.counted, tsn.counted)
        np.testing.assert_array_equal(ts64.mismatches, tsn.mismatches)
        np.testing.assert_array_equal(ts64.rejected, tsn.rejected)
        np.testing.assert_array_equal(ts64.mismatch_rate, tsn.mismatch_rate)
        # serial vs pairwise summation: last-ulp only
        np.testing.assert_allclose(tsn.score, ts64.score, rtol=1e-13)

    s64 = Settings(edge_threshold=0.5, ov_threshold=0.2, backend="numpy")
    snat = Settings(edge_threshold=0.5, ov_threshold=0.2, backend="native")
    r64 = verify_overlaps(store, packed, ov, s64)
    rn = verify_overlaps(store, packed, ov, snat)
    assert len(r64.edges) == len(rn.edges)
    np.testing.assert_array_equal(r64.nonedge_mask, rn.nonedge_mask)
    np.testing.assert_array_equal(r64.edges["v1"], rn.edges["v1"])
    np.testing.assert_array_equal(r64.edges["v2"], rn.edges["v2"])


def test_combined_pe_score_recheck_near_threshold():
    """The f64 recheck must also cover *combined* PE scores: two tasks each
    far from the thresholds can average (0.5*(s1+s2)) to within f32 error of
    ov_threshold; the decision must still be exact (reference compares in
    C++ double, src/EdgeCalculator.cpp:254-379)."""
    from haploconduct_tpu.io.overlaps import make_overlaps
    from haploconduct_tpu.ops.verify import RECHECK_STATS
    from haploconduct_tpu.ops.score import RECHECK_MARGIN

    L, pos, ovlen = 60, 20, 40
    base = ("ACGTTGCAACGGATCCTAGGATCCGGTTAACCGGATATCG" * 2)[:L]
    x1 = base
    y1 = base[pos:] + base[:pos]          # perfect 40bp overlap at shift 20
    y2_mis = list(base[pos:] + base[:pos])
    y2_mis[5] = "A" if y2_mis[5] != "A" else "C"  # one mismatch on trail end
    y2 = "".join(y2_mis)
    q = "I" * L
    store = ReadStore()
    store.add_paired(0, x1, q, base, q)
    store.add_paired(1, y1, q, y2, q)
    packed = store.pack()
    ov = make_overlaps(
        id1=np.array([0]), id2=np.array([1]),
        pos1=np.array([pos]), pos2=np.array([pos]),
        len1=np.array([ovlen]), len2=np.array([ovlen]),
        perc1=np.array([100 * ovlen // L]), perc2=np.array([100 * ovlen // L]),
    )
    ov["type1"] = b"p"
    ov["type2"] = b"p"
    ov["ord"] = b"1"

    # oracle per-task scores -> combined mean; both tasks must be far from it
    plan, _ = plan_tasks(store, packed, ov)
    lens = np.concatenate([packed.lens, packed.lens])
    ts = score_tasks_numpy(packed.codes, packed.quals, lens,
                           plan.row_first, plan.row_second, plan.pos)
    s1, s2 = ts.score[plan.t1_of[0]], ts.score[plan.t2_of[0]]
    combined = 0.5 * (s1 + s2)
    assert abs(s1 - combined) > 2 * RECHECK_MARGIN
    assert abs(s2 - combined) > 2 * RECHECK_MARGIN

    # ov_threshold sits exactly on the combined f64 score; edge_threshold is
    # far below both tasks so both_pass holds and the mean rule applies
    for delta in (0.0, 1e-9, -1e-9, 5e-7, -5e-7):
        kw = dict(edge_threshold=0.5, ov_threshold=float(combined + delta))
        r64 = verify_overlaps(store, packed, ov, Settings(backend="numpy", **kw))
        r32 = verify_overlaps(store, packed, ov,
                              Settings(backend="jax", exact=True, **kw))
        assert RECHECK_STATS["overlaps"] >= 1  # the combined recheck fired
        np.testing.assert_array_equal(r64.nonedge_mask, r32.nonedge_mask)
        np.testing.assert_array_equal(r64.scored["score"], r32.scored["score"])


def test_mismatch_rate_exact_on_device_path():
    """mismatch_rate on the jax path must equal the f64 oracle bit-for-bit
    (recomputed from exact integer counts), so the merge_contigs comparison
    can never be flipped by f32 rounding."""
    rng = np.random.default_rng(11)
    store, _ = build_random_store(rng, n_single=10, n_paired=6)
    packed = store.pack()
    ov = random_overlaps(rng, store, 150)
    s64 = Settings(edge_threshold=0.5, ov_threshold=0.2, backend="numpy")
    s32 = Settings(edge_threshold=0.5, ov_threshold=0.2, backend="jax", exact=True)
    r64 = verify_overlaps(store, packed, ov, s64)
    r32 = verify_overlaps(store, packed, ov, s32)
    np.testing.assert_array_equal(r64.scored["mismatch_rate"],
                                  r32.scored["mismatch_rate"])


def test_jax_segmented_drift_at_kb_widths():
    """The device path decomposes every task into SEG=512-lane segments
    (shared body with the mesh path), so f32 accumulation error at
    kb-scale task widths stays within the RECHECK_MARGIN safety budget that
    the exactness machinery (ops/verify.py) assumes. Reference accumulates
    in C++ double (src/EdgeCalculator.cpp:26-139)."""
    from haploconduct_tpu.ops.score import RECHECK_MARGIN

    rng = np.random.default_rng(23)
    R, W = 64, 6200  # multi-kb contigs
    codes = np.full((R, W), 4, np.int8)
    quals = np.zeros((R, W), np.uint8)
    lens = rng.integers(4000, W + 1, R).astype(np.int64)
    for i in range(R):
        codes[i, :lens[i]] = rng.integers(0, 4, lens[i])
        quals[i, :lens[i]] = rng.integers(2, 41, lens[i])
    B = 256
    row_a = rng.integers(0, R, B).astype(np.int64)
    row_b = rng.integers(0, R, B).astype(np.int64)
    pos = np.array([rng.integers(0, max(1, lens[a] - 2000)) for a in row_a],
                   np.int64)
    tj = score_tasks_jax(codes, quals, lens, row_a, row_b, pos)
    to = score_tasks_numpy(codes, quals, lens, row_a, row_b, pos)
    np.testing.assert_array_equal(tj.counted, to.counted)
    np.testing.assert_array_equal(tj.mismatches, to.mismatches)
    drift = np.max(np.abs(tj.score - to.score))
    assert drift < RECHECK_MARGIN / 4, drift


@pytest.mark.parametrize("length,n_sub", [(0, 1), (1, 1), (512, 1), (513, 2),
                                          (1500, 3)])
def test_segment_tasks_split_and_pack(length, n_sub):
    """A task of L compared lanes becomes ceil(L/SEG) subtasks (one for a
    degenerate task); s_bolen packs (k << 10) | seg_len, s_posa advances by
    SEG, and the bounds map subtasks back to tasks."""
    from haploconduct_tpu.ops.score import SEG, segment_tasks

    row_a = np.array([3, 7], np.int64)
    row_b = np.array([5, 2], np.int64)
    pos = np.array([11, 0], np.int64)
    L = np.array([length, 40], np.int64)
    s_rowa, s_rowb, s_posa, s_bolen, bounds = segment_tasks(row_a, row_b, pos, L)
    assert len(s_rowa) == n_sub + 1
    np.testing.assert_array_equal(bounds, [0, n_sub])
    k = s_bolen[:n_sub] >> 10
    seg_len = s_bolen[:n_sub] & 1023
    np.testing.assert_array_equal(k, np.arange(n_sub))
    assert seg_len.sum() == length and np.all(seg_len <= SEG)
    np.testing.assert_array_equal(s_posa[:n_sub], 11 + SEG * np.arange(n_sub))
    assert np.all(s_rowa[:n_sub] == 3) and np.all(s_rowb[:n_sub] == 5)
    assert s_bolen[n_sub] == 40 and s_posa[n_sub] == 0


def test_pack_combined_keeps_the_unit_width():
    """One int16 word per position, code | qual << 3, and no padding beyond
    the longest unit: the device bodies clamp and mask instead."""
    from haploconduct_tpu.ops.score import pack_combined

    rng = np.random.default_rng(2)
    codes = rng.integers(0, 6, (37, 150)).astype(np.int8)
    quals = rng.integers(0, 42, (37, 150)).astype(np.uint8)
    comb = pack_combined(codes, quals)
    assert comb.shape == codes.shape and comb.dtype == np.int16
    np.testing.assert_array_equal(comb & 7, codes)
    np.testing.assert_array_equal(comb >> 3, quals)


def test_device_path_at_the_row_end():
    """Windows that end exactly at the last column of the packed matrix, and
    tasks whose pos is past the row, match the oracle without row slack."""
    rng = np.random.default_rng(5)
    R, W = 16, 150
    codes = rng.integers(0, 4, (R, W)).astype(np.int8)
    quals = rng.integers(20, 41, (R, W)).astype(np.uint8)
    lens = np.full(R, W, np.int64)
    row_a = np.arange(R, dtype=np.int64)
    row_b = (row_a + 1) % R
    pos = np.array([0, 1, 60, 148, 149, 150, 151, 200] * 2, np.int64)
    tj = score_tasks_jax(codes, quals, lens, row_a, row_b, pos)
    to = score_tasks_numpy(codes, quals, lens, row_a, row_b, pos)
    np.testing.assert_array_equal(tj.counted, to.counted)
    np.testing.assert_array_equal(tj.mismatches, to.mismatches)
    np.testing.assert_allclose(tj.score, to.score, atol=1e-5)
