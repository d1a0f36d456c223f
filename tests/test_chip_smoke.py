"""chip_smoke.py's phase functions at tiny sizes on the host: the same
comparisons the script makes on the card, so a wrong path or argument shows
here before a chip run."""

import json

import numpy as np
import pytest

import chip_smoke


@pytest.fixture
def device_backend(monkeypatch):
    """backend="auto" resolves to the device path, as it does on a card."""
    from haploconduct_tpu.ops import autoback

    monkeypatch.setattr(autoback, "_cache", {})
    monkeypatch.setenv("HC_BACKEND", "jax")


def test_phase_scorer_tiny():
    out = chip_smoke.phase_scorer(read_tasks=3000, read_rows=400,
                                  contig_tasks=150, contig_rows=40,
                                  contig_max=1300)
    for key in ("read_scale", "read_scale_thresh", "contig_scale"):
        assert out[key]["max_abs_score_delta"] <= chip_smoke.SCORE_TOL
    assert out["read_scale"]["true_overlaps_over_0.97"] > 0


def test_phase_em_tiny():
    out = chip_smoke.phase_em(n_contigs=24, n_classes=120, iters=60)
    assert out["max_rel_err"] <= chip_smoke.EM_TOL
    assert out["counts_ge_1"] > 0


def test_phase_kmer_tiny():
    out = chip_smoke.phase_kmer(genome_len=3000, coverage=6, read_len=300)
    assert out["candidates"] > 0


def test_phase_savage_example_tiny(device_backend):
    out = chip_smoke.phase_savage_example(genome_len=2500, n_singles=300,
                                          n_pairs=30)
    assert out["stage_a_identical"]
    assert out["backend_counts"]["mesh"] + out["backend_counts"]["xla"] > 0
    assert out["contigs"]["a"] > 0


def test_phase_mesh_patch_tiny():
    import jax

    out = chip_smoke.phase_mesh_patch(n_devices=len(jax.devices()),
                                      genome_len=1500, total_cov=60)
    assert out["stage_a_identical"]
    assert len(out["last_stream_shards"]) == len(jax.devices())


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
