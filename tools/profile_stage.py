"""Profile a synthetic N-x-scale SAVAGE stage-a run.

Generates ~SCALE x the bundled example's read count from two synthetic
haplotypes, runs candidates + run_stage under cProfile, and prints the top
cumulative-time functions so host-phase hotspots are visible. Candidates
are cached in /tmp per scale (generation itself is profiled separately).
"""
import cProfile, pstats, sys, time, pickle, os
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import numpy as np

from haploconduct_tpu.core.reads import ReadStore
from haploconduct_tpu.utils.simulate import random_genome, mutate_sequence, simulate_reads
from haploconduct_tpu.ops.kmer import find_overlap_candidates
from haploconduct_tpu.io.sfo import sfo_to_overlaps
from haploconduct_tpu.assemble.stages import StageParams, run_stage

SCALE = int(sys.argv[1]) if len(sys.argv) > 1 else 10
BACKEND = sys.argv[2] if len(sys.argv) > 2 else "jax"
TOP = int(sys.argv[3]) if len(sys.argv) > 3 else 30

cache = f"/tmp/profile_stage_cache_{SCALE}.pkl"
if os.path.exists(cache):
    with open(cache, "rb") as f:
        seqs, quals, ov = pickle.load(f)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    print(f"{len(store)} reads (cached), {len(ov)} candidates")
else:
    rng = np.random.default_rng(0)
    genome = random_genome(rng, 10000)
    mut = mutate_sequence(genome, rng, sub_rate=0.01)
    haps = [genome, mut[0] if isinstance(mut, tuple) else mut]
    n_reads = 2200 * SCALE
    read_len = 150
    coverage = n_reads * read_len / (2 * len(genome))
    seqs, quals = simulate_reads(haps, coverage=coverage, read_len=read_len, rng=rng, error_rate=0.002)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    print(f"{len(store)} reads, coverage ~{coverage:.0f}x per hap")
    t0 = time.time()
    sseqs = [store.unit_codes(u) for u in range(store.n_units)]
    sfo = find_overlap_candidates(sseqs, min_overlap_len=90, k=20, error_rate=0.01)
    ov = sfo_to_overlaps(sfo, len(store), 0)
    print(f"candidates: {len(ov)} in {time.time()-t0:.1f}s")
    with open(cache, "wb") as f:
        pickle.dump((seqs, quals, ov), f)

params = StageParams(stage="a", min_overlap_len=90, edge_threshold=0.97,
                     original_readcount=len(store), backend=BACKEND)
prof = cProfile.Profile()
t1 = time.time()
prof.enable()
res = run_stage(params, store, ov)
prof.disable()
t2 = time.time()
print(f"stage a: {t2-t1:.1f}s, {len(res.store)} contigs, {res.iterations} iterations")
print("phases:", {k: round(v, 2) for k, v in sorted(
    res.phase_times.items(), key=lambda kv: -kv[1])})
st = pstats.Stats(prof)
st.sort_stats("cumulative").print_stats(TOP)
