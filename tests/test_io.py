import numpy as np
import pytest

from haploconduct_tpu.io import (
    read_fastq, write_fastq, read_fasta, write_fasta,
    read_overlaps, write_overlaps, make_overlaps, overlap_perc,
)
from haploconduct_tpu.io.sfo import SFO_DTYPE, sfo_to_overlaps
from haploconduct_tpu.io.subreads import OriginalIndex, read_subreads, write_subreads



@pytest.fixture
def example_files(tmp_path):
    """The seeded example-scale sample written as SAVAGE's input files:
    singles.fastq, paired1.fastq, paired2.fastq and the master genome."""
    from haploconduct_tpu.utils.simulate import savage_example_sample

    store, haps = savage_example_sample(seed=0)
    ns = store.readcount_single
    single = list(range(ns))
    paired = list(range(ns, len(store)))
    write_fastq(tmp_path / "singles.fastq", [str(i) for i in single],
                [store.seq_str(i, 0) for i in single],
                [store.phred_str(i, 0) for i in single])
    for end in (1, 2):
        write_fastq(tmp_path / f"paired{end}.fastq",
                    [str(i - ns) for i in paired],
                    [store.seq_str(i, end) for i in paired],
                    [store.phred_str(i, end) for i in paired])
    write_fasta(tmp_path / "ref.fasta", ["master"], [haps[0]])
    return tmp_path, store


def test_fastq_roundtrip(example_files, tmp_path):
    d, store = example_files
    ids, seqs, phreds = read_fastq(d / "singles.fastq")
    assert len(ids) == len(seqs) == len(phreds) == store.readcount_single
    assert ids[0] == "0"
    assert seqs[0] == store.seq_str(0, 0) and phreds[0] == store.phred_str(0, 0)
    assert set("".join(seqs[:50])) <= set("ACGTN")
    out = tmp_path / "roundtrip.fastq"
    write_fastq(out, ids, seqs, phreds)
    ids2, seqs2, phreds2 = read_fastq(out)
    assert ids2 == ids and seqs2 == seqs and phreds2 == phreds


def test_paired_files_align(example_files):
    d, store = example_files
    ids1, seqs1, _ = read_fastq(d / "paired1.fastq")
    ids2, seqs2, _ = read_fastq(d / "paired2.fastq")
    assert ids1 == ids2
    assert len(ids1) == len(store) - store.readcount_single > 150
    assert all(len(a) == len(b) for a, b in zip(seqs1, seqs2))


def test_fasta_roundtrip(example_files, tmp_path):
    d, _ = example_files
    ids, seqs = read_fasta(d / "ref.fasta")
    assert len(ids) == 1
    assert len(seqs[0]) > 9000
    out = tmp_path / "ref2.fasta"
    write_fasta(out, ids, seqs)
    ids2, seqs2 = read_fasta(out)
    assert ids2 == ids and seqs2 == seqs


def test_overlap_parse_serialize(tmp_path):
    lines = [
        "0\t5\t12\t0\t-\t+\t-\t80\t0\t100\t0\ts\ts\n",
        "3\t7\t4\t9\t1\t+\t+\t90\t85\t120\t110\tp\tp\n",
        "2\t9\t4\t-\t-\t+\t+\t90\t85\t120\t110\ts\ts\n",
    ]
    p = tmp_path / "overlaps.txt"
    p.write_text("".join(lines))
    ov = read_overlaps(str(p))
    assert len(ov) == 3
    assert ov["id2"][0] == 5
    assert ov["pos2"][2] == 0 and ov["len2"][2] == 0 and ov["perc2"][2] == 0
    assert list(overlap_perc(ov)) == [80, 87, 90]  # int(0.5*(90+85)) == 87

    out = tmp_path / "out.txt"
    write_overlaps(str(out), ov)
    text = out.read_text()
    assert text.splitlines()[0] == "0\t5\t12\t0\t-\t+\t-\t80\t0\t100\t0\ts\ts"
    ov2 = read_overlaps(str(out))
    assert np.array_equal(ov, ov2)


def test_overlap_validation(tmp_path):
    p = tmp_path / "bad.txt"
    # ord must be '-' for single-involved overlaps
    p.write_text("0\t5\t12\t0\t1\t+\t-\t80\t0\t100\t0\ts\ts\n")
    with pytest.raises(ValueError):
        read_overlaps(str(p))


def test_sfo_to_overlaps_ss():
    # two singles, A starts first, same orientation, no overhang on B side
    sfo = np.array(
        [(0, 1, b"N", 50, 30, 200, 200, 4)], dtype=SFO_DTYPE
    )
    ov = sfo_to_overlaps(sfo, num_singles=2, num_pairs=0)
    assert len(ov) == 1
    r = ov[0]
    assert (r["id1"], r["id2"], r["pos1"]) == (0, 1, 50)
    assert r["ori1"] == b"+" and r["ori2"] == b"+"
    assert r["len1"] == 200
    assert r["type1"] == b"s" and r["type2"] == b"s"
    # perc = round(100*200/min(250, 230))
    assert r["perc1"] == round(100 * 200 / 230)


def test_sfo_to_overlaps_flip():
    # idA > idB after mapping -> must be flipped to canonical order
    sfo = np.array(
        [(1, 0, b"N", 50, 30, 200, 200, 4)], dtype=SFO_DTYPE
    )
    ov = sfo_to_overlaps(sfo, num_singles=2, num_pairs=0)
    assert len(ov) == 1
    r = ov[0]
    # flip_N canonicalizes the sort order to (0, 1) but the emitted overlap
    # re-derives direction from the overhang signs: read 1 starts first.
    assert (r["id1"], r["id2"]) == (1, 0)
    assert r["pos1"] == 50


def test_subreads_roundtrip(tmp_path):
    sub = {
        7: {3: OriginalIndex(index1=5, len1=100),
            4: OriginalIndex(index1=-2, index2=88, is_paired=True, forward=False, len1=90, len2=95)},
        8: {1: OriginalIndex(index1=0, len1=250)},
    }
    p = tmp_path / "subreads.txt"
    write_subreads(str(p), sub)
    back = read_subreads(str(p))
    assert back[7][4].index2 == 88
    assert back[7][4].is_paired and not back[7][4].forward
    assert back[7][3].len1 == 100 and not back[7][3].is_paired
    assert back[8][1].len1 == 250


def test_clique_graph_format_converters():
    from haploconduct_tpu.io.converters import (
        edges_to_dimacs, dimacs_to_edges, complement_edges,
        edges_to_metis_graph, edges_to_snap)

    n = 5
    v1 = np.array([0, 1, 0, 2, 1, 2, 2, 3])  # both-direction listing
    v2 = np.array([1, 0, 2, 0, 2, 1, 3, 2])
    dim = edges_to_dimacs(n, v1, v2)
    assert dim.splitlines()[1] == "p edge 5 4"
    n2, w1, w2 = dimacs_to_edges(dim)
    assert n2 == n
    assert {(a, b) for a, b in zip(w1, w2)} == {(0, 1), (1, 0), (0, 2), (2, 0),
                                                (1, 2), (2, 1), (2, 3), (3, 2)}
    c1, c2 = complement_edges(n, v1, v2)
    comp = {(a, b) for a, b in zip(c1, c2)}
    assert comp == {(0, 3), (0, 4), (1, 3), (1, 4), (2, 4), (3, 4)}
    g = edges_to_metis_graph(n, v1, v2).splitlines()
    assert g[0] == "5 4" and g[1] == "2 3" and g[5] == ""  # isolated vertex 4
    assert edges_to_snap(n, np.array([0]), np.array([3])) == "0\t3\n"
