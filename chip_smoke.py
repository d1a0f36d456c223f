#!/usr/bin/env python3
"""Bring-up check of HaploConduct-TPU on one NVIDIA GPU.

    python chip_smoke.py           # one card: phases a-d below
    python chip_smoke.py --four    # four cards: the stage-a patch on a mesh

Phases (each one compares the device path with the repo's own reference):
  a. the device scorer against the f64 oracle (score_tasks_numpy) at read
     scale (1M tasks, 150 bp rows) and contig scale (100k tasks over 1-10 kb
     units): integer columns equal, |score difference| <= 1e-4;
  b. the abundance EM on device against the f64 EM (hundreds of contigs,
     thousands of equivalence classes): relative error <= 1e-4;
  c. the device k-mer join against the host join on POLYTE's exact
     re-overlap shape: identical candidate sets;
  d. SAVAGE a->b->c on one seeded 667x patch (~44,400 reads) through
     run_savage with backend="auto", against backend="native"; and an
     example-scale run (~2,200 reads, -m 200) against backend="numpy".

The script needs a GPU: without one it exits non-zero before any phase. Any
failed phase exits non-zero too, and only a run in which every phase passed
prints the final JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

SCORE_TOL = 1e-4  # 20x inside RECHECK_MARGIN; f32 over <=512-lane segments
EM_TOL = 1e-4     # f32 EM over 500 iterations, on estimated counts >= 1


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# phase a: the device scorer
# --------------------------------------------------------------------------

def scorer_workload(rng, n_rows, min_len, max_len, n_tasks, genome_len,
                    error=0.002, n_rate=0.002):
    """Rows sampled from one random genome (so true diagonals score high),
    with substitutions, Ns and Illumina-like phreds (mostly 30-41, one in
    ten 2-29); half the tasks sit on a true diagonal, half at a random
    offset. Returns the score_tasks_* args."""
    from haploconduct_tpu.core.reads import N_CODE, PAD_CODE

    genome = rng.integers(0, 4, genome_len).astype(np.int8)
    lens = rng.integers(min_len, max_len + 1, n_rows)
    starts = rng.integers(0, genome_len - max_len, n_rows)
    codes = np.full((n_rows, max_len), PAD_CODE, np.int8)
    quals = np.zeros((n_rows, max_len), np.uint8)
    col = np.arange(max_len)[None, :]
    inside = col < lens[:, None]
    window = genome[np.minimum(starts[:, None] + col, genome_len - 1)]
    noise = rng.random((n_rows, max_len))
    window = np.where(noise < error, (window + rng.integers(1, 4, window.shape)) % 4,
                      window)
    window = np.where(noise > 1.0 - n_rate, N_CODE, window)
    codes[inside] = window[inside]
    phred = np.where(rng.random((n_rows, max_len)) < 0.9,
                     rng.integers(30, 42, (n_rows, max_len)),
                     rng.integers(2, 30, (n_rows, max_len))).astype(np.uint8)
    quals[inside] = phred[inside]
    row_a = rng.integers(0, n_rows, n_tasks)
    row_b = rng.integers(0, n_rows, n_tasks)
    true_pos = starts[row_b] - starts[row_a]
    rand_pos = (rng.random(n_tasks) * lens[row_a] * 0.8).astype(np.int64)
    use_true = (rng.random(n_tasks) < 0.5) & (true_pos >= 0) & (true_pos < lens[row_a])
    pos = np.where(use_true, true_pos, rand_pos)
    return codes, quals, lens.astype(np.int64), row_a, row_b, pos


def compare_scorer(args, mismatch_thresh=0.0, chunk=None):
    """Device scorer vs the f64 oracle (in task chunks) on one workload."""
    from haploconduct_tpu.ops.score import score_tasks_jax, score_tasks_numpy

    codes, quals, lens, row_a, row_b, pos = args
    t0 = time.perf_counter()
    dev = score_tasks_jax(codes, quals, lens, row_a, row_b, pos,
                          mismatch_thresh=mismatch_thresh)
    t_dev = time.perf_counter() - t0
    chunk = chunk or max(1, 20_000_000 // codes.shape[1])
    refs = [score_tasks_numpy(codes, quals, lens, row_a[i:i + chunk],
                              row_b[i:i + chunk], pos[i:i + chunk],
                              mismatch_thresh=mismatch_thresh)
            for i in range(0, len(row_a), chunk)]
    ref = [np.concatenate([getattr(r, f) for r in refs])
           for f in ("score", "counted", "mismatches", "rejected")]
    for name, a, b in zip(("counted", "mismatches", "rejected"),
                          (dev.counted, dev.mismatches, dev.rejected), ref[1:]):
        bad = int(np.sum(np.asarray(a) != np.asarray(b)))
        assert bad == 0, f"{name}: {bad} tasks differ from the oracle"
    delta = float(np.max(np.abs(dev.score - ref[0])))
    assert delta <= SCORE_TOL, f"max |score - oracle| = {delta}"
    return {"tasks": len(row_a), "max_abs_score_delta": delta,
            "device_call_s": t_dev,
            "true_overlaps_over_0.97": int(np.sum(ref[0] > 0.97))}


def phase_scorer(read_tasks=1_000_000, read_rows=88_800, contig_tasks=100_000,
                 contig_rows=2_000, contig_max=10_000, seed=0):
    rng = np.random.default_rng(seed)
    reads = scorer_workload(rng, read_rows, 150, 150, read_tasks, 10_000)
    out = {"read_scale": compare_scorer(reads),
           "read_scale_thresh": compare_scorer(reads, mismatch_thresh=0.1)}
    contigs = scorer_workload(rng, contig_rows, min(1_000, contig_max),
                              contig_max, contig_tasks, 5 * contig_max)
    out["contig_scale"] = compare_scorer(contigs)
    return out


# --------------------------------------------------------------------------
# phase b: the abundance EM
# --------------------------------------------------------------------------

def phase_em(n_contigs=400, n_classes=4_000, iters=500, seed=0):
    from haploconduct_tpu.ops.abundance import _em_device, _em_numpy

    rng = np.random.default_rng(seed)
    membership = np.zeros((n_classes, n_contigs), np.float32)
    for c in range(n_classes):
        k = int(rng.integers(1, 5))
        membership[c, rng.choice(n_contigs, k, replace=False)] = 1.0
    counts = rng.integers(1, 2_000, n_classes).astype(np.float64)
    eff_len = rng.uniform(300.0, 9_000.0, n_contigs)
    dev = _em_device(membership, counts, eff_len, iters)
    ref = _em_numpy(membership, counts, eff_len, iters)
    big = ref >= 1.0
    rel = float(np.max(np.abs(dev[big] - ref[big]) / ref[big]))
    assert rel <= EM_TOL, f"EM relative error {rel} on counts >= 1"
    return {"contigs": n_contigs, "classes": n_classes, "iters": iters,
            "max_rel_err": rel, "counts_ge_1": int(big.sum())}


# --------------------------------------------------------------------------
# phase c: the device k-mer join
# --------------------------------------------------------------------------

def phase_kmer(genome_len=20_000, coverage=15, read_len=600, seed=0):
    """POLYTE's exact re-overlap shape (bench.py --cands): device join vs
    the host join with subsample=1, as sets of SFO rows."""
    from haploconduct_tpu.core.reads import encode_seq
    from haploconduct_tpu.ops.kmer import find_overlap_candidates
    from haploconduct_tpu.ops.kmer_device import find_overlap_candidates_device
    from haploconduct_tpu.utils.simulate import random_genome, simulate_reads

    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    reads, _ = simulate_reads([genome], coverage=coverage, read_len=read_len,
                              rng=rng, error_rate=0.0)
    seqs = [encode_seq(s) for s in reads]
    host = find_overlap_candidates(seqs, min_overlap_len=50, k=20,
                                   error_rate=0.0, verify=True, subsample=1)
    dev = find_overlap_candidates_device(seqs, min_overlap_len=50,
                                         error_rate=0.0, verify=True)
    h = set(host.tolist())
    d = set(dev.tolist())
    assert h == d, (f"candidate sets differ: {len(h - d)} host-only, "
                    f"{len(d - h)} device-only")
    return {"reads": len(seqs), "candidates": len(h)}


# --------------------------------------------------------------------------
# phase d: SAVAGE end to end
# --------------------------------------------------------------------------

def _records(store):
    recs = []
    for i in range(len(store)):
        if store.is_paired[i]:
            recs.append(store.seq_str(i, 1) + "|" + store.phred_str(i, 1) + "|"
                        + store.seq_str(i, 2) + "|" + store.phred_str(i, 2))
        else:
            recs.append(store.seq_str(i, 0) + "|" + store.phred_str(i, 0))
    return sorted(recs)


def stage_records(res):
    """Sorted (seq|qual) records per stage of a SavageResult."""
    out = {"a": _records(res.combined_store)}
    for st in ("b", "c"):
        sres = getattr(res, f"stage_{st}")
        if sres is not None:
            out[st] = _records(sres.store)
    return out


def _run(store, backend, **cfg):
    from haploconduct_tpu.workflows.savage import SavageConfig, run_savage

    t0 = time.perf_counter()
    res = run_savage(store, SavageConfig(backend=backend, **cfg))
    return res, time.perf_counter() - t0


def compare_savage(store, reference_backend, **cfg):
    """run_savage with backend="auto" (which must resolve to the device)
    against `reference_backend` on the same reads. Stage a must be
    byte-identical; a difference in b or c is reported with its cause."""
    from haploconduct_tpu.ops import verify as V
    from haploconduct_tpu.ops.autoback import resolve_backend

    assert resolve_backend() == "jax", "backend=auto must pick the device"
    before = dict(V.BACKEND_COUNTS)
    res, t_dev = _run(store, "auto", **cfg)
    counts = {k: V.BACKEND_COUNTS[k] - before[k] for k in before}
    device_tasks = counts["xla"] + counts["mesh"]
    assert device_tasks > 0, f"no task reached the device scorer: {counts}"
    assert counts["numpy"] == 0 and counts["native"] == 0, counts
    ref, t_ref = _run(store, reference_backend, **cfg)
    got, want = stage_records(res), stage_records(ref)
    assert got["a"] == want["a"], "stage-a contigs differ from the reference"
    out = {"reads": len(store), "device_s": t_dev,
           f"{reference_backend}_s": t_ref, "backend_counts": counts,
           "stage_a_iterations": res.stage_a.iterations,
           "contigs": {st: len(v) for st, v in got.items()},
           "stage_a_identical": True}
    for st in ("b", "c"):
        same = got.get(st) == want.get(st)
        out[f"stage_{st}_identical"] = same
        if not same:
            out[f"stage_{st}_cause"] = diagnose_bc(store, st, cfg, want)
    return out


def diagnose_bc(store, stage, cfg, want):
    """Rerun with the f64 EM in place of the device EM. If the stage then
    matches the reference run `want`, the difference comes from the f32 EM
    at the abundance filter's TPM > 0 threshold."""
    from haploconduct_tpu.ops import abundance

    saved = abundance._em_device
    abundance._em_device = abundance._em_numpy
    try:
        redo, _ = _run(store, "auto", **cfg)
    finally:
        abundance._em_device = saved
    if stage_records(redo).get(stage) == want.get(stage):
        return ("f32 abundance EM: with the f64 EM the device run matches; "
                "the filter keeps contigs whose TPM > 0, and f32 moves "
                "contigs across that threshold")
    return "not the EM: the difference stays with the f64 EM"


def phase_savage_patch(seed=0, **sample):
    from haploconduct_tpu.utils.simulate import savage_patch_sample

    store, _ = savage_patch_sample(seed=seed, **sample)
    return compare_savage(store, "native", split_num=1)


def phase_savage_example(seed=0, **sample):
    from haploconduct_tpu.utils.simulate import savage_example_sample

    store, _ = savage_example_sample(seed=seed, **sample)
    return compare_savage(store, "numpy", split_num=1, min_overlap_len=200)


def phase_mesh_patch(n_devices=4, seed=0, **sample):
    """Stage a of the SAVAGE patch with the task stream sharded over
    `n_devices` cards (verify_overlaps takes the mesh path whenever several
    devices are visible), byte for byte against backend="native"."""
    import jax

    from haploconduct_tpu.ops import verify as V
    from haploconduct_tpu.parallel import mesh
    from haploconduct_tpu.utils.simulate import savage_patch_sample

    assert len(jax.devices()) == n_devices, jax.devices()
    store, _ = savage_patch_sample(seed=seed, **sample)
    before = V.BACKEND_COUNTS["mesh"]
    mesh.STREAM_SHARDS.clear()
    res, t_dev = _run(store, "jax", split_num=1, stage_b=False)
    assert V.BACKEND_COUNTS["mesh"] > before, "the mesh path was not taken"
    shards = list(mesh.STREAM_SHARDS)
    devices = {s["device"] for s in shards}
    assert len(devices) == n_devices, shards
    assert all(s["subtasks"] > 0 for s in shards), shards
    ref, t_ref = _run(store, "native", split_num=1, stage_b=False)
    same = _records(res.combined_store) == _records(ref.combined_store)
    assert same, "mesh stage-a contigs differ from backend=native"
    return {"reads": len(store), "mesh_s": t_dev, "native_s": t_ref,
            "mesh_tasks": V.BACKEND_COUNTS["mesh"] - before,
            "last_stream_shards": [
                {"device": f"{s['device'].platform}:{s['device'].id}",
                 "shape": s["shape"], "subtasks": s["subtasks"]}
                for s in shards],
            "stage_a_contigs": len(res.combined_store),
            "stage_a_identical": same}


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

class CompileCounter:
    """Counts XLA backend compiles and persistent-cache hits from JAX's
    monitoring events."""

    def __init__(self):
        import jax.monitoring

        self.compiles = 0
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event_seen)

    def _duration(self, name, _secs, **_kw):
        if name == "/jax/core/compile/backend_compile_duration":
            self.compiles += 1

    def _event_seen(self, name, **_kw):
        if name == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the stage-a patch sharded over 4 cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU visible (platform {devices[0].platform})",
              file=sys.stderr)
        return 2
    from haploconduct_tpu.utils.device import card_line
    from haploconduct_tpu.utils.jaxcache import enable_compile_cache

    cache = enable_compile_cache()
    import jaxlib

    counter = CompileCounter()
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"devices {[str(d) for d in devices]}")
    log(f"compile cache: {cache}")

    if args.four:
        phases = [("mesh_patch", phase_mesh_patch)]
        want = 4
    else:
        phases = [("a_scorer", phase_scorer), ("b_em", phase_em),
                  ("c_kmer", phase_kmer), ("d_savage_patch", phase_savage_patch),
                  ("d_savage_example", phase_savage_example)]
        want = 1
    if len(devices) != want:
        print(f"chip_smoke: expected {want} GPU(s), found {len(devices)}",
              file=sys.stderr)
        return 2

    from haploconduct_tpu.ops import verify as V

    for name, fn in phases:
        t0 = time.perf_counter()
        result = fn()
        log(f"phase {name}: {time.perf_counter() - t0:.3f} s "
            f"{json.dumps(result, default=str)}")
        log(f"  BACKEND_COUNTS={V.BACKEND_COUNTS} RECHECK_STATS={V.RECHECK_STATS}")
    peak = max(d.memory_stats().get("peak_bytes_in_use", 0) for d in devices)
    log(f"peak_bytes_in_use: {peak}")
    log(f"compilations: {counter.compiles} (persistent cache hits "
        f"{counter.cache_hits})")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
