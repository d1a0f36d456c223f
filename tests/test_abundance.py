"""Tests for the pseudo-alignment + EM abundance estimator (the built-in
kallisto replacement, ops/abundance.py) and its freq_est / savage wiring."""

import numpy as np
import pytest

from haploconduct_tpu.core.reads import ReadStore, encode_seq, revcomp_str
from haploconduct_tpu.ops.abundance import (
    PseudoIndex, estimate_abundance, store_unit_seqs)


def _random_seq(rng, n):
    return "".join("ACGT"[b] for b in rng.integers(0, 4, n))


def _reads_from(rng, seq, n, read_len=60):
    out = []
    for _ in range(n):
        start = int(rng.integers(0, len(seq) - read_len + 1))
        r = seq[start:start + read_len]
        if rng.random() < 0.5:
            r = revcomp_str(r)
        out.append(encode_seq(r))
    return out


def test_pseudoindex_classify_unique_and_shared():
    rng = np.random.default_rng(0)
    a = _random_seq(rng, 300)
    b = _random_seq(rng, 300)
    shared = _random_seq(rng, 120)
    idx = PseudoIndex(["a", "b"], [encode_seq(a + shared), encode_seq(b + shared)], k=31)
    # read unique to contig a
    assert idx.classify(encode_seq(a[50:150])) == frozenset({0})
    # read from the shared tail is compatible with both
    assert idx.classify(encode_seq(shared[10:100])) == frozenset({0, 1})
    # read matching nothing
    assert idx.classify(encode_seq(_random_seq(rng, 100))) is None


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_em_recovers_abundance_ratio(backend):
    rng = np.random.default_rng(1)
    a = _random_seq(rng, 500)
    b = _random_seq(rng, 500)
    reads = _reads_from(rng, a, 300) + _reads_from(rng, b, 100)
    res = estimate_abundance(["a", "b"], [encode_seq(a), encode_seq(b)],
                             reads, fragment_len=60.0, backend=backend)
    assert res.n_pseudoaligned == 400
    assert res.est_counts[0] == pytest.approx(300, abs=2)
    assert res.tpm[0] / max(res.tpm[1], 1e-9) == pytest.approx(3.0, rel=0.05)
    # TPMs normalize to 1e6
    assert res.tpm.sum() == pytest.approx(1e6, rel=1e-3)


def test_em_resolves_shared_reads_by_unique_evidence():
    """Reads from a shared region are split in proportion to each contig's
    unique evidence — the core EM behavior kallisto provides."""
    rng = np.random.default_rng(2)
    shared = _random_seq(rng, 200)
    a = _random_seq(rng, 300) + shared
    b = _random_seq(rng, 300) + shared
    reads = (_reads_from(rng, a[:300], 200)      # unique to a
             + _reads_from(rng, b[:300], 50)     # unique to b
             + _reads_from(rng, shared, 100))    # ambiguous
    res = estimate_abundance(["a", "b"], [encode_seq(a), encode_seq(b)],
                             reads, fragment_len=60.0, backend="numpy")
    # ambiguous mass should split ~4:1, giving ~280 vs ~70
    assert res.est_counts[0] == pytest.approx(280, abs=15)
    assert res.est_counts[1] == pytest.approx(70, abs=15)


def test_zero_abundance_contig_gets_zero_tpm():
    rng = np.random.default_rng(3)
    a = _random_seq(rng, 400)
    ghost = _random_seq(rng, 400)
    reads = _reads_from(rng, a, 100)
    res = estimate_abundance(["a", "ghost"], [encode_seq(a), encode_seq(ghost)],
                             reads, fragment_len=60.0, backend="numpy")
    assert res.tpm[1] == pytest.approx(0.0, abs=1e-6)
    assert res.tpm[0] == pytest.approx(1e6, rel=1e-6)


def test_abundance_table_format():
    rng = np.random.default_rng(4)
    a = _random_seq(rng, 200)
    res = estimate_abundance(["c0"], [encode_seq(a)], _reads_from(rng, a, 10),
                             fragment_len=60.0, backend="numpy")
    lines = res.table().strip().split("\n")
    assert lines[0] == "target_id\tlength\teff_length\test_counts\ttpm"
    assert lines[1].split("\t")[0] == "c0"


def test_freq_est_abundance_mode():
    from haploconduct_tpu.workflows.freq_est import estimate_frequencies_abundance

    rng = np.random.default_rng(5)
    a = _random_seq(rng, 400)
    b = _random_seq(rng, 400)
    contigs = ReadStore()
    contigs.add_single(0, a, "I" * len(a))
    contigs.add_single(1, b, "I" * len(b))
    contigs.readcount_single = 2
    reads = ReadStore()
    i = 0
    for src, n in ((a, 150), (b, 50)):
        for _ in range(n):
            start = int(rng.integers(0, len(src) - 60))
            reads.add_single(i, src[start:start + 60], "I" * 60)
            i += 1
    reads.readcount_single = i
    fr = estimate_frequencies_abundance(contigs, reads, fragment_len=60.0,
                                        backend="numpy")
    assert fr.frequencies[0] == pytest.approx(0.75, abs=0.05)
    assert sum(fr.frequencies) == pytest.approx(1.0, rel=1e-6)


def test_savage_freq_filter_drops_zero_tpm_contig():
    from haploconduct_tpu.assemble.stages import StageResult
    from haploconduct_tpu.workflows.savage import _freq_filter

    rng = np.random.default_rng(6)
    a = _random_seq(rng, 400)
    ghost = _random_seq(rng, 400)
    contigs = ReadStore()
    contigs.add_single(0, a, "I" * len(a))
    contigs.add_single(7, ghost, "I" * len(ghost))
    contigs.readcount_single = 2
    reads = ReadStore()
    for i in range(50):
        start = int(rng.integers(0, len(a) - 60))
        reads.add_single(i, a[start:start + 60], "I" * 60)
    reads.readcount_single = 50
    res = StageResult(store=contigs, subreads={0: {}, 7: {}},
                      overlap_lines=[], iterations=1)
    out = _freq_filter(res, reads, fragment_len=60.0, backend="numpy")
    kept = [int(out.store.ids[i]) for i in range(len(out.store))]
    assert kept == [0]
    assert set(out.subreads) == {0}


def test_classify_all_matches_per_read():
    """The vectorized batch classifier must reproduce per-read classify()
    exactly: same classes, same counts, same aligned total."""
    import numpy as np

    from haploconduct_tpu.core.reads import encode_seq
    from haploconduct_tpu.ops.abundance import PseudoIndex
    from haploconduct_tpu.utils.simulate import (mutate_sequence,
                                                 random_genome,
                                                 simulate_reads)

    rng = np.random.default_rng(17)
    g = random_genome(rng, 3000)
    contigs = [g[:1200], g[1000:2300], g[2000:],
               mutate_sequence(g[500:1700], rng, sub_rate=0.02)]
    seqs, _ = simulate_reads([g, mutate_sequence(g, rng, sub_rate=0.03)],
                             coverage=6, read_len=100, rng=rng,
                             error_rate=0.01)
    reads = [encode_seq(s) for s in seqs]
    # include degenerate reads: shorter than k, and all-N
    reads.append(encode_seq("ACGT"))
    reads.append(np.full(60, 4, dtype=np.int8))
    index = PseudoIndex([str(i) for i in range(len(contigs))],
                        [encode_seq(c) for c in contigs], k=31)

    expected = {}
    n_exp = 0
    for rc in reads:
        cls = index.classify(rc)
        if cls:
            key = np.array(sorted(cls), dtype=np.int32).tobytes()
            expected[key] = expected.get(key, 0) + 1
            n_exp += 1
    got_counts, got_members, n_got = index.classify_all(reads, chunk=37)
    assert n_got == n_exp
    assert got_counts == expected
    for key, mem in got_members.items():
        assert key == mem.tobytes()


def test_em_products_run_at_highest_precision():
    """Both EM products reach dot_general with Precision.HIGHEST, so a GPU
    cannot run them in TF32."""
    import jax
    import jax.numpy as jnp

    from haploconduct_tpu.ops.abundance import _em_run

    M = jnp.ones((6, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(_em_run, static_argnums=4)(
        M, jnp.ones(6), jnp.ones(3), jnp.ones(3), 5)

    def dots(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for v in eqn.params.values():
                inner = getattr(v, "jaxpr", None)
                if inner is not None:
                    yield from dots(getattr(inner, "jaxpr", inner))

    found = list(dots(jaxpr.jaxpr))
    assert len(found) == 2
    hi = jax.lax.Precision.HIGHEST
    for eqn in found:
        assert eqn.params["precision"] == (hi, hi), eqn.params["precision"]
