"""On-card comparisons of the device paths with their host references.

Marked `gpu`: they skip without an NVIDIA GPU and run on the card with
`python -m pytest tests -m gpu`. chip_smoke.py runs the same comparisons
at full size."""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_scorer_matches_oracle_on_card():
    out = chip_smoke.phase_scorer(read_tasks=200_000, read_rows=20_000,
                                  contig_tasks=20_000, contig_rows=500)
    for key in ("read_scale", "read_scale_thresh", "contig_scale"):
        assert out[key]["max_abs_score_delta"] <= chip_smoke.SCORE_TOL


def test_em_matches_f64_on_card():
    assert chip_smoke.phase_em()["max_rel_err"] <= chip_smoke.EM_TOL


def test_kmer_join_matches_host_on_card():
    assert chip_smoke.phase_kmer()["candidates"] > 0
