"""Synthetic-data generation: genome mutation + read simulation.

Covers the reference's scripts/random_mutations.py (substitution /
insertion / deletion mutagenesis of fasta sequences) and adds an Illumina
read simulator used by the test-suite (the reference had no read
simulator; its example data was pre-generated)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

BASES = "ACGT"


def random_genome(rng: np.random.Generator, length: int) -> str:
    return "".join(BASES[b] for b in rng.integers(0, 4, length))


def mutate_sequence(seq: str, rng: np.random.Generator,
                    sub_rate: float = 0.0, ins_rate: float = 0.0,
                    del_rate: float = 0.0) -> str:
    """Random mutagenesis (scripts/random_mutations.py semantics: counts
    are round(len * rate), positions unique-uniform)."""
    out = list(seq)
    n = len(seq)
    n_sub = int(round(n * sub_rate))
    for pos in rng.choice(n, size=min(n_sub, n), replace=False):
        cur = out[pos]
        if cur in BASES:
            alt = BASES[(BASES.index(cur) + int(rng.integers(1, 4))) % 4]
            out[pos] = alt
    n_del = int(round(n * del_rate))
    for pos in sorted(rng.choice(n, size=min(n_del, n), replace=False), reverse=True):
        if out[pos] is not None:
            out[pos] = ""
    n_ins = int(round(n * ins_rate))
    for pos in sorted(rng.choice(n, size=min(n_ins, n), replace=False), reverse=True):
        out[pos] = out[pos] + BASES[int(rng.integers(0, 4))]
    return "".join(out)


def simulate_reads(
    genomes: List[str],
    coverage: float,
    read_len: int,
    rng: np.random.Generator,
    error_rate: float = 0.002,
    qual_char: str = "I",
):
    """Uniform single-end reads over a set of haplotypes; returns
    (seqs, phreds) with per-base substitution errors at error_rate."""
    seqs: List[str] = []
    quals: List[str] = []
    for genome in genomes:
        n_reads = int(coverage * len(genome) / read_len)
        starts = rng.integers(0, max(len(genome) - read_len, 1), n_reads)
        for s in starts:
            read = list(genome[s:s + read_len])
            errs = rng.random(len(read)) < error_rate
            for i in np.flatnonzero(errs):
                read[i] = BASES[(BASES.index(read[i]) + int(rng.integers(1, 4))) % 4]
            seqs.append("".join(read))
            quals.append(qual_char * len(read))
    order = rng.permutation(len(seqs))
    return [seqs[i] for i in order], [quals[i] for i in order]


def simulate_paired_reads(
    genomes: List[str],
    coverage: float,
    read_len: int,
    insert_size: int,
    insert_std: int,
    rng: np.random.Generator,
    error_rate: float = 0.002,
    qual_char: str = "I",
):
    """Forward-forward paired reads (PEAR-style, as SAVAGE expects)."""
    p1s, p2s, quals = [], [], []
    for genome in genomes:
        n_pairs = int(coverage * len(genome) / (2 * read_len))
        for _ in range(n_pairs):
            frag = max(2 * read_len, int(rng.normal(insert_size, insert_std)))
            start = int(rng.integers(0, max(len(genome) - frag, 1)))
            r1 = genome[start:start + read_len]
            r2 = genome[start + frag - read_len:start + frag]
            if len(r1) < read_len or len(r2) < read_len:
                continue
            def err(read):
                read = list(read)
                for i in np.flatnonzero(rng.random(len(read)) < error_rate):
                    read[i] = BASES[(BASES.index(read[i]) + int(rng.integers(1, 4))) % 4]
                return "".join(read)
            p1s.append(err(r1))
            p2s.append(err(r2))
            quals.append(qual_char * read_len)
    return p1s, p2s, quals


def reads_to_store(seqs: List[str], quals: List[str],
                   pairs: Optional[Tuple[List[str], List[str], List[str]]] = None):
    """ReadStore of single-end reads (ids 0..) then pairs (p1, p2, quals)."""
    from ..core.reads import ReadStore

    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    if pairs is not None:
        for j, (s1, s2, q) in enumerate(zip(*pairs)):
            store.add_paired(len(seqs) + j, s1, q, s2, q)
    return store


def quasispecies(rng: np.random.Generator, genome_len: int, n_haps: int,
                 divergence: float) -> List[str]:
    """A master genome plus n_haps-1 strains, each `divergence` away from
    it by substitutions (pairwise about twice that)."""
    genome = random_genome(rng, genome_len)
    return [genome] + [mutate_sequence(genome, rng, sub_rate=divergence)
                       for _ in range(n_haps - 1)]


def savage_patch_sample(seed: int = 0, genome_len: int = 10000,
                        n_haps: int = 4, divergence: float = 0.03,
                        total_cov: float = 667.0, read_len: int = 150,
                        error_rate: float = 0.002):
    """One SAVAGE de novo patch at the documented 500-1000x per patch
    (savage/README.md:313-319): a viral-scale genome, a few strains a few
    percent apart, single-end Illumina reads. The defaults give ~44,400
    150 bp reads. Returns (store, haplotypes)."""
    rng = np.random.default_rng(seed)
    haps = quasispecies(rng, genome_len, n_haps, divergence)
    seqs, quals = simulate_reads(haps, coverage=total_cov / n_haps,
                                 read_len=read_len, rng=rng,
                                 error_rate=error_rate)
    return reads_to_store(seqs, quals), haps


def savage_example_sample(seed: int = 0, genome_len: int = 9700,
                          n_haps: int = 3, divergence: float = 0.03,
                          n_singles: int = 2000, n_pairs: int = 200,
                          read_len: int = 250, insert_size: int = 600,
                          error_rate: float = 0.002):
    """A sample shaped like SAVAGE's bundled example (savage/README.md:
    303-310: 2,000 single-end reads plus ~200 pairs over an HIV-sized genome,
    run with `-m 200 --split 1`). Returns (store, haplotypes)."""
    rng = np.random.default_rng(seed)
    haps = quasispecies(rng, genome_len, n_haps, divergence)
    seqs, quals = simulate_reads(
        haps, coverage=n_singles / n_haps * read_len / genome_len,
        read_len=read_len, rng=rng, error_rate=error_rate)
    pairs = simulate_paired_reads(
        haps, coverage=n_pairs / n_haps * 2 * read_len / genome_len,
        read_len=read_len, insert_size=insert_size,
        insert_std=insert_size // 10, rng=rng, error_rate=error_rate)
    return reads_to_store(seqs, quals, pairs), haps
