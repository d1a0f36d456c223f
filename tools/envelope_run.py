"""Envelope-scale validation runs.

Two workloads at the reference's documented operating envelopes:

1. SAVAGE ultra-deep patching at the reference's REAL operating point:
   a ~10kb viral genome (HIV-scale) at 10,000x total coverage, split so
   each patch sees 500 < coverage < 1000 (savage/README.md:313-319, the
   explicit --split_num guidance; the upstream README.md:99) —
   ~660k reads total, 15 patches @ ~44k reads/patch.

2. polyte-split on a >100kb genome (README.md:99-101: "genomes larger
   than 100kb"), 15x per haplotype (polyte/README.md:77-78's optimal
   range), windowed into 10kb regions.

Usage: python tools/envelope_run.py [savage|polyte|both]
Prints one JSON line per workload. The SAVAGE reads come from
utils/simulate.py (the same generator chip_smoke.py uses for one patch).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from haploconduct_tpu.utils.simulate import (mutate_sequence, quasispecies,
                                             random_genome, reads_to_store,
                                             simulate_reads)


def quality_metrics(contigs, haplotypes, min_contig_len=0, snps=False):
    """Score an assembly against its known simulated haplotypes with the
    package's own evaluator (workflows/evaluate.py): NGA50, genome
    fraction, misassemblies, mismatch rate — the QUAST-style columns the
    reference's customized_metaquast.py would produce."""
    from haploconduct_tpu.workflows.evaluate import (
        evaluate_assembly, polymorphic_position_accuracy)

    m = evaluate_assembly(contigs, haplotypes, min_contig_len=min_contig_len)
    out = {
        "n_contigs": m.n_contigs,
        "total_bp": m.total_length,
        "largest": m.largest,
        "n50": m.n50,
        "nga50": m.nga50,
        "genome_fraction": round(m.genome_fraction, 4),
        "mismatch_rate": round(m.mismatch_rate, 6),
        "duplication_ratio": round(m.duplication_ratio, 3),
        "misassemblies": m.misassemblies,
        "unaligned_contigs": m.unaligned_contigs,
    }
    if snps:
        rec, tot = polymorphic_position_accuracy(contigs, haplotypes)
        out["snps_recovered"] = rec
        out["snps_total"] = tot
    return out


def savage_envelope(genome_len=10000, total_cov=10000, split_num=15,
                    read_len=150, n_haps=4, divergence=0.03,
                    ckpt_dir=None):
    from haploconduct_tpu.workflows.savage import SavageConfig, run_savage

    rng = np.random.default_rng(0)
    # a quasispecies-like strain mix: n_haps haplotypes each ~divergence
    # from the master (pairwise ~2*divergence), the regime of the
    # reference's HIV lab-mix benchmarks (savage/README.md:292-310)
    haps = quasispecies(rng, genome_len, n_haps, divergence)
    per_hap = total_cov / n_haps
    seqs, quals = simulate_reads(haps, coverage=per_hap,
                                 read_len=read_len, rng=rng,
                                 error_rate=0.002)
    store = reads_to_store(seqs, quals)
    cov_per_patch = total_cov / split_num
    assert 500 < cov_per_patch < 1000, cov_per_patch
    print(f"[savage] {len(store)} reads = {total_cov}x total over "
          f"{genome_len/1000:.0f}kb ({n_haps} strains), {split_num} "
          f"patches @ {cov_per_patch:.0f}x "
          f"(~{len(store)//split_num} reads/patch)",
          file=sys.stderr)

    t0 = time.time()
    cfg = SavageConfig(split_num=split_num, backend="auto",
                       min_clique_size=4, progress=True,
                       output_dir=ckpt_dir, resume=ckpt_dir is not None)
    res = run_savage(store, cfg)
    wall = time.time() - t0
    ids_c, contigs_c = res.contigs("c")
    out = {
        "metric": "savage 10000x-coverage patched end-to-end",
        "genome_len": genome_len,
        "n_reads": len(store),
        "total_coverage": total_cov,
        "split_num": split_num,
        "coverage_per_patch": cov_per_patch,
        "wall_s": round(wall, 1),
        "stage_a_contigs": len(res.combined_store) if res.combined_store else 0,
        "stage_c_contigs": len(contigs_c),
        "longest_contig": max((len(c) for c in contigs_c), default=0),
        "unit": "s",
    }
    # stage b/c wall + per-phase splits (the contig-overlap regime the
    # reference treats as distinct, savage.py:402-448)
    out["timings"] = res.timings
    for stage in ("b", "c"):
        sres = getattr(res, f"stage_{stage}")
        if sres is not None and sres.phase_times:
            out[f"stage_{stage}_phases"] = {
                k: round(v, 1) for k, v in sorted(
                    sres.phase_times.items(), key=lambda kv: -kv[1])}
    # quality vs the known simulated haplotypes
    for stage in ("a", "b", "c"):
        try:
            _, contigs = res.contigs(stage)
        except Exception:
            continue
        if contigs:
            out[f"stage_{stage}_quality"] = quality_metrics(
                contigs, haps, snps=(stage == "c"))

    # stage-c merge_contigs experiment: the reference's own knob for
    # merging contigs into master strains (savage.py:481-500, README
    # "merge contigs" advice) — rerun ONLY stage c from the in-memory
    # stage-b output at mc=0.01 and score it, so the contiguity-vs-
    # accuracy trade of the knob is on record next to the mc=0 default
    if res.stage_b is not None and len(res.stage_b.store):
        from haploconduct_tpu.assemble.stages import StageParams, run_stage
        from haploconduct_tpu.core.reads import decode_seq
        from haploconduct_tpu.workflows.savage import (_original_readcount,
                                                       contig_candidates)

        mc = 0.01
        sfo_mm_c = 1 + (0.99 - mc) / (mc + 0.01)
        t0 = time.time()
        ov_c = contig_candidates(res.stage_b.store, 100, sfo_mm_c)
        params = StageParams(
            stage="c", min_overlap_len=100, edge_threshold=0.995,
            merge_contigs=mc, remove_branches=True, min_read_len=100,
            max_tip_len=150, first_it=False,
            original_readcount=_original_readcount(res.stage_b.subreads),
            backend="auto")
        res_mc = run_stage(params, res.stage_b.store, ov_c,
                           res.stage_b.subreads)
        contigs_mc = [decode_seq(res_mc.store.unit_codes(res_mc.store.unit1[i]))
                      for i in range(len(res_mc.store))]
        out["stage_c_mc001"] = dict(
            wall_s=round(time.time() - t0, 1),
            **(quality_metrics(contigs_mc, haps, snps=True)
               if contigs_mc else {}))
    print(json.dumps(out))
    return out


def polyte_envelope(genome_len=120000, hap_cov=15, read_len=250):
    import tempfile

    from haploconduct_tpu.workflows.polyte_split import (PolyteSplitConfig,
                                                         run_polyte_split)

    rng = np.random.default_rng(1)
    genome = random_genome(rng, genome_len)
    hap2 = mutate_sequence(genome, rng, sub_rate=0.005)
    seqs, quals = simulate_reads([genome, hap2], coverage=hap_cov,
                                 read_len=read_len, rng=rng, error_rate=0.0)
    store = reads_to_store(seqs, quals)
    print(f"[polyte-split] {len(store)} reads over {genome_len/1000:.0f}kb, "
          f"{hap_cov}x per hap", file=sys.stderr)

    t0 = time.time()
    with tempfile.TemporaryDirectory() as td:
        ref_path = os.path.join(td, "ref.fasta")
        with open(ref_path, "w") as f:
            f.write(f">chr\n{genome}\n")
        cfg = PolyteSplitConfig(
            hap_cov=hap_cov, insert_size=read_len, stddev=25,
            reference=ref_path, split_size=10000, split_overlap=1000,
            backend="auto", min_overlap_len=100,
            min_overlap_len_EC=2 + read_len // 2)
        res = run_polyte_split(store, cfg)
    wall = time.time() - t0
    final = res.final.store
    lens = sorted((final.read_len(i) for i in range(len(final))),
                  reverse=True)
    out = {
        "metric": "polyte-split >100kb genome end-to-end",
        "genome_len": genome_len,
        "n_reads": len(store),
        "hap_cov": hap_cov,
        "n_regions": len(res.regions),
        "wall_s": round(wall, 1),
        "final_contigs": len(final),
        "longest_contig": lens[0] if lens else 0,
        "sum_final_bp": int(sum(lens)),
        "final_ref_candidates": res.final_ref_candidates,
        "unit": "s",
    }
    from haploconduct_tpu.core.reads import decode_seq

    contigs = [decode_seq(final.unit_codes(final.unit1[i]))
               for i in range(len(final))]
    if contigs:
        out["quality"] = quality_metrics(contigs, [genome, hap2])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    ckpt = None
    genome = None
    for a in sys.argv[2:]:
        if a.startswith("--ckpt="):
            ckpt = a.split("=", 1)[1]
        if a.startswith("--genome="):
            genome = int(a.split("=", 1)[1])
    if which in ("savage", "both"):
        savage_envelope(ckpt_dir=ckpt)
    if which in ("polyte", "both"):
        polyte_envelope(**({"genome_len": genome} if genome else {}))
