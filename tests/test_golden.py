"""Golden regression: full de novo stage a on a seeded example-scale sample
(utils/simulate.py:savage_example_sample, shaped like SAVAGE's bundled
example: 2,000 single-end reads plus ~200 pairs, `-m 200`) must keep
producing the exact contig set the f64 oracle (backend="numpy") produced
when the fixture was pinned: candidate count, iteration count, per-contig
lengths, and a SHA256 over the sorted (seq, qual) records.

Parametrized over the two host backends, "numpy" (the oracle) and "native"
(the C++ OpenMP engine whose decisions are made exact by the
RECHECK_MARGIN machinery), so both host paths are pinned to the same
output. chip_smoke.py makes the same comparison for the device path on the
card. Regenerate the fixture with `python tests/test_golden.py`.
"""

import hashlib
import json
import os

import pytest

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "stage_a_denovo_golden.json")
SAMPLE = dict(seed=0)
MIN_OVERLAP = 200
MAX_TIP = 250


def sample_and_candidates():
    from haploconduct_tpu.utils.simulate import savage_example_sample
    from haploconduct_tpu.workflows.savage import denovo_candidates

    store, _ = savage_example_sample(**SAMPLE)
    return store, denovo_candidates(store, MIN_OVERLAP, 50)


def stage_a_summary(store, overlaps, backend):
    from haploconduct_tpu.assemble.stages import StageParams, run_stage

    params = StageParams(stage="a", min_overlap_len=MIN_OVERLAP,
                         edge_threshold=0.97, remove_branches=True,
                         max_tip_len=MAX_TIP, original_readcount=len(store),
                         backend=backend)
    res = run_stage(params, store, overlaps)
    st = res.store
    lens = sorted((st.read_len(i) for i in range(len(st))), reverse=True)
    recs = []
    for i in range(len(st)):
        if st.is_paired[i]:
            recs.append(st.seq_str(i, 1) + "|" + st.phred_str(i, 1) + "|"
                        + st.seq_str(i, 2) + "|" + st.phred_str(i, 2))
        else:
            recs.append(st.seq_str(i, 0) + "|" + st.phred_str(i, 0))
    recs.sort()
    return {"n_candidates": int(len(overlaps)), "iterations": res.iterations,
            "lengths": lens, "total_bp": int(sum(lens)),
            "records_sha256": hashlib.sha256("\n".join(recs).encode()).hexdigest()}


@pytest.fixture(scope="module")
def example_inputs():
    with open(FIXTURE) as f:
        golden = json.load(f)
    store, overlaps = sample_and_candidates()
    assert len(overlaps) == golden["n_candidates"]
    return store, overlaps, golden


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_stage_a_denovo_golden(example_inputs, backend):
    store, overlaps, golden = example_inputs
    got = stage_a_summary(store, overlaps, backend)
    assert got["iterations"] == golden["iterations"]
    assert got["lengths"] == golden["lengths"]
    assert got["total_bp"] == golden["total_bp"]
    assert got["records_sha256"] == golden["records_sha256"]


if __name__ == "__main__":
    store, overlaps = sample_and_candidates()
    summary = stage_a_summary(store, overlaps, "numpy")
    summary["sample"] = {"generator": "savage_example_sample", **SAMPLE,
                         "min_overlap_len": MIN_OVERLAP, "backend": "numpy"}
    with open(FIXTURE, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"pinned {len(summary['lengths'])} contigs, "
          f"{summary['n_candidates']} candidates -> {FIXTURE}")
