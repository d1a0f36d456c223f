#!/usr/bin/env python3
"""Scorer benchmark: overlap verifications per second on the device.

Workload: the seeded example-scale sample (utils/simulate.py:
savage_example_sample) packed into unit matrices; a batch of candidate
verification tasks (row pairs + diagonal offsets) scored end to end by the
device scorer (haploconduct_tpu/ops/score.py:score_tasks_jax, host
segmenting and transfers included), i.e. the rebuild of the reference's
hot loop EdgeCalculator::overlap_score (src/EdgeCalculator.cpp:26-139).

The native C++ OpenMP scorer (haploconduct_tpu/native/baseline_score.cpp)
is timed on the same tasks on all host cores, as `vs_live`.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}
"""

import json
import os
import sys
import time

import numpy as np


def build_workload(n_tasks: int, seed: int = 0):
    from haploconduct_tpu.utils.simulate import savage_example_sample

    store, _ = savage_example_sample(seed=seed)
    packed = store.pack()
    lens = np.concatenate([packed.lens, packed.lens]).astype(np.int32)
    rng = np.random.default_rng(seed)
    n_rows = packed.codes.shape[0]
    row_a = rng.integers(0, n_rows, n_tasks).astype(np.int32)
    row_b = rng.integers(0, n_rows, n_tasks).astype(np.int32)
    # suffix-prefix diagonals: overlap lengths ~100..read length
    la = lens[row_a]
    ov = rng.integers(100, 250, n_tasks)
    pos = np.maximum(la - ov, 0).astype(np.int32)
    return packed, lens, row_a, row_b, pos


def bench_device(packed, lens, row_a, row_b, pos, repeats: int = 5):
    """Best-of-N wall time of score_tasks_jax on the task batch, after one
    warm-up call that compiles; returns verifications/s."""
    from haploconduct_tpu.ops.score import score_tasks_jax

    def run():
        return score_tasks_jax(packed.codes, packed.quals, lens,
                               row_a, row_b, pos)

    run()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return len(row_a) / best


def device_info():
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def bench_cpu(packed, lens, row_a, row_b, pos):
    from haploconduct_tpu.native import load_baseline_ext

    ext = load_baseline_ext()
    if ext is None:
        return None
    os.environ.setdefault("OMP_NUM_THREADS", str(os.cpu_count()))
    n = min(len(row_a), 200_000)
    # warmup
    ext.score_tasks(packed.codes, packed.quals, lens, row_a[:1000], row_b[:1000], pos[:1000])
    t0 = time.perf_counter()
    ext.score_tasks(packed.codes, packed.quals, lens, row_a[:n], row_b[:n], pos[:n])
    dt = time.perf_counter() - t0
    return n / dt


def bench_e2e(backend: str = "native"):
    """End-to-end stage a on the seeded example-scale sample: candidates +
    all iterations, with the per-phase breakdown from
    StageResult.phase_times."""
    from haploconduct_tpu.assemble.stages import StageParams, run_stage
    from haploconduct_tpu.utils.simulate import savage_example_sample
    from haploconduct_tpu.workflows.savage import denovo_candidates

    store, _ = savage_example_sample(seed=0)

    t0 = time.perf_counter()
    overlaps = denovo_candidates(store, 200, 50)
    t_cand = time.perf_counter() - t0

    params = StageParams(stage="a", min_overlap_len=200, edge_threshold=0.97,
                         remove_branches=True, max_tip_len=250,
                         original_readcount=len(store), backend=backend)
    t1 = time.perf_counter()
    res = run_stage(params, store, overlaps)
    t_stage = time.perf_counter() - t1

    out = {
        "metric": "example-scale stage-a wall-clock",
        "value": round(t_stage, 2),
        "unit": "s",
        "candidates_s": round(t_cand, 2),
        "total_s": round(t_cand + t_stage, 2),
        "iterations": res.iterations,
        "n_candidates": int(len(overlaps)),
        "n_contigs": len(res.store),
        "backend": backend,
        "phases": res.phase_times,
    }
    print(json.dumps(out))
    return 0


def bench_mesh(virtual: int = 0):
    """Multi-device scaling of the sharded verification path:
    verifications/s through parallel/mesh.py's sharded segment scorer at
    every power-of-two device count the backend exposes. With --virtual8
    the run forces an 8-virtual-device CPU mesh (a shape check: virtual
    devices share the host's cores)."""
    import os as _os

    if virtual:
        flags = _os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            _os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={virtual}"
            ).strip()
    import jax

    if virtual:
        jax.config.update("jax_platforms", "cpu")
    from haploconduct_tpu.parallel.mesh import make_mesh, sharded_score_tasks

    n_tasks = int(os.environ.get("BENCH_TASKS", 65536))
    packed, lens, row_a, row_b, pos = build_workload(n_tasks)

    n_avail = len(jax.devices())
    counts = [c for c in (1, 2, 4, 8, 16) if c <= n_avail]
    repeats = 8
    rates = {}
    for n_dev in counts:
        mesh = make_mesh(n_dev)

        def run_all():
            # the PRODUCTION host-synchronous path end to end: segment on
            # host, one batched transfer per column, one scanned dispatch
            # over the mesh, one fetch per output, host segment->task
            # reduction (parallel/mesh.py:sharded_score_tasks)
            return sharded_score_tasks(packed.codes, packed.quals, lens,
                                       row_a, row_b, pos, mesh=mesh)

        run_all()  # compile + warmup
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run_all()
            best = min(best, time.perf_counter() - t0)
        # min across repeats: least host interference
        rates[n_dev] = n_tasks / best

    base = rates[counts[0]]
    top = counts[-1]
    out = {
        "metric": f"mesh-sharded verifications/s @ {top} device(s)",
        "value": round(rates[top]),
        "unit": "verifications/s",
        "vs_baseline": round(rates[top] / base, 2),  # scaling vs 1 device
        "per_device_count": {str(k): round(v) for k, v in rates.items()},
        "platform": jax.devices()[0].platform,
        "host_cores": os.cpu_count(),
        "n_tasks": n_tasks,
    }
    print(json.dumps(out))
    return 0


def bench_candidates():
    """Candidate-generation throughput: the device
    sort-join (ops/kmer_device.py) vs the host k-mer engine (ops/kmer.py)
    on a POLYTE-style exact re-overlap workload (contig-scale sequences,
    error_rate=0). Reported as candidate overlaps emitted per second."""
    from haploconduct_tpu.core.reads import encode_seq
    from haploconduct_tpu.ops.kmer import find_overlap_candidates
    from haploconduct_tpu.ops.kmer_device import find_overlap_candidates_device
    from haploconduct_tpu.utils.simulate import random_genome, simulate_reads

    rng = np.random.default_rng(0)
    genome = random_genome(rng, 20000)
    seqs_s, _ = simulate_reads([genome], coverage=15, read_len=600, rng=rng,
                               error_rate=0.0)
    seqs = [encode_seq(s) for s in seqs_s]

    t0 = time.perf_counter()
    host = find_overlap_candidates(seqs, min_overlap_len=50, k=20,
                                   error_rate=0.0, verify=True, subsample=1)
    t_host = time.perf_counter() - t0

    # compile + warmup, then timed run
    find_overlap_candidates_device(seqs, min_overlap_len=50, error_rate=0.0,
                                   verify=True)
    t0 = time.perf_counter()
    dev = find_overlap_candidates_device(seqs, min_overlap_len=50,
                                         error_rate=0.0, verify=True)
    t_dev = time.perf_counter() - t0

    assert len(dev) == len(host), (len(dev), len(host))
    print(json.dumps({
        "metric": "candidate overlaps/s (device sort-join)",
        "value": round(len(dev) / t_dev),
        "unit": "candidates/s",
        "vs_baseline": round(t_host / t_dev, 2),
        "n_seqs": len(seqs),
        "n_candidates": int(len(dev)),
        "host_s": round(t_host, 3),
        "device_s": round(t_dev, 3),
    }))
    return 0


def main():
    from haploconduct_tpu.utils.jaxcache import enable_compile_cache

    enable_compile_cache()
    if "--mesh" in sys.argv:
        return bench_mesh(virtual=8 if "--virtual8" in sys.argv else 0)
    if "--cands" in sys.argv:
        return bench_candidates()
    if "--e2e" in sys.argv:
        backend = "native"  # C++ host engine; exact decisions (ops/verify.py)
        for a in sys.argv[1:]:
            if a.startswith("--backend="):
                backend = a.split("=", 1)[1]
        return bench_e2e(backend)

    n_tasks = int(os.environ.get("BENCH_TASKS", 1 << 20))
    packed, lens, row_a, row_b, pos = build_workload(n_tasks)

    from haploconduct_tpu.utils.device import card_line

    print(f"card: {card_line()}", flush=True)
    cpu_rate = bench_cpu(packed, lens, row_a, row_b, pos)
    device_rate = bench_device(packed, lens, row_a, row_b, pos)
    print(json.dumps({
        "metric": "overlap verifications/s (score_tasks_jax, end to end)",
        "value": round(device_rate),
        "unit": "verifications/s",
        "device": device_info(),
        "n_tasks": n_tasks,
        "vs_live": round(device_rate / cpu_rate, 2) if cpu_rate else None,
        "native_live": round(cpu_rate) if cpu_rate else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
