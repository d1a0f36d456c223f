"""backend="auto" selection (ops/autoback.py): the pure decision rule
with faked probes, and end-to-end routing of verify_overlaps on this
(CPU-only test) host."""

import os

import numpy as np
import pytest

from haploconduct_tpu.ops import autoback
from haploconduct_tpu.ops import verify as V


def test_decide_cpu_platform_is_native():
    backend, info = autoback.decide("cpu", None, 0.0)
    assert backend == "native"


# the slower of two link probes and the faster of two native-engine probes
# taken on the machine with one NVIDIA H100 80GB HBM3 (16 host cores)
H100_LINK = {"h2d_Bps": 5.97e9, "d2h_Bps": 5.97e9, "lat_s": 4.25e-4}
H100_NATIVE_RATE = 2.32e6


def test_decide_gpu_host_picks_device():
    """On the measured card link the projection beats the native engine by
    more than CROSSOVER, so the rule takes the device."""
    backend, info = autoback.decide("gpu", H100_LINK,
                                    native_rate=H100_NATIVE_RATE)
    assert backend == "jax"
    assert info["projected_device_rate"] > autoback.CROSSOVER * H100_NATIVE_RATE
    assert info["projected_device_rate"] <= autoback.ONCHIP_RATE


def test_decide_slow_link_picks_native():
    # a remote device behind ~10 MB/s and ~20 ms per transfer
    probe = {"h2d_Bps": 10e6, "d2h_Bps": 40e6, "lat_s": 0.022}
    backend, info = autoback.decide("gpu", probe, native_rate=2.0e5)
    assert backend == "native"


def test_decide_no_native_engine_falls_to_device():
    backend, _ = autoback.decide("gpu", None, 0.0)
    assert backend == "jax"


def test_bytes_per_task_is_the_single_device_stream():
    """Read-scale tasks are one subtask each, and score_tasks_jax moves four
    int32 columns up and four 4-byte results down per subtask."""
    from haploconduct_tpu.ops.score import segment_tasks

    n = 1000
    L = np.full(n, 150, np.int64)
    cols = segment_tasks(np.arange(n), np.arange(n), np.zeros(n, np.int64), L)
    assert len(cols[0]) == n
    up = sum(c.itemsize for c in (cols[0][:1], cols[1][:1], cols[2][:1], cols[3][:1]))
    assert autoback.BYTES_PER_TASK == up + 4 * 4


def test_resolve_backend_raises_instead_of_falling_back(monkeypatch):
    import jax

    monkeypatch.setattr(autoback, "_cache", {})
    monkeypatch.delenv("HC_BACKEND", raising=False)

    def broken():
        raise RuntimeError("no backend")

    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError):
        autoback.resolve_backend()
    assert "backend" not in autoback._cache


def test_resolve_backend_cpu_skips_the_native_probe(monkeypatch):
    monkeypatch.setattr(autoback, "_cache", {})
    monkeypatch.delenv("HC_BACKEND", raising=False)

    def not_called():
        raise AssertionError("probe_native_rate must not run on a CPU host")

    monkeypatch.setattr(autoback, "probe_native_rate", not_called)
    assert autoback.resolve_backend() == "native"


def test_resolve_backend_env_override(monkeypatch):
    monkeypatch.setattr(autoback, "_cache", {})
    monkeypatch.setenv("HC_BACKEND", "numpy")
    assert autoback.resolve_backend() == "numpy"


def test_auto_routes_verify_to_native_on_this_host(monkeypatch):
    """Settings(backend='auto') must reach the native engine on a CPU-only
    deployment, with decisions identical to the f64 oracle."""
    from haploconduct_tpu.core.reads import ReadStore
    from haploconduct_tpu.utils.config import Settings
    from haploconduct_tpu.utils.simulate import random_genome, simulate_reads
    from haploconduct_tpu.ops.kmer import find_overlap_candidates
    from haploconduct_tpu.io.sfo import sfo_to_overlaps

    monkeypatch.setattr(autoback, "_cache", {})
    monkeypatch.delenv("HC_BACKEND", raising=False)
    rng = np.random.default_rng(9)
    genome = random_genome(rng, 1500)
    seqs, quals = simulate_reads([genome], coverage=15, read_len=120,
                                 rng=rng, error_rate=0.005)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    sseqs = [store.unit_codes(u) for u in range(store.n_units)]
    sfo = find_overlap_candidates(sseqs, min_overlap_len=60, k=20,
                                  error_rate=0.01)
    ov = sfo_to_overlaps(sfo, len(store), 0)
    packed = store.pack()

    before = dict(V.BACKEND_COUNTS)
    s = Settings(min_overlap_len=60, edge_threshold=0.97, backend="auto")
    vr = V.verify_overlaps(store, packed, ov, s)
    assert (V.BACKEND_COUNTS["native"] > before["native"]
            or V.BACKEND_COUNTS["numpy"] > before["numpy"])  # ext fallback

    vr_np = V.verify_overlaps(store, packed, ov, s.derive(backend="numpy"))
    for f in ("v1", "v2", "pos1", "mismatch_rate"):
        assert np.array_equal(vr.edges[f], vr_np.edges[f]), f


def test_compile_cache_dir_follows_the_environment():
    from haploconduct_tpu.utils import jaxcache

    assert jaxcache.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/c"}) == "/x/c"
    default = jaxcache.compile_cache_dir({})
    assert default == os.path.join(jaxcache.CHECKOUT, ".jax_cache")
    assert os.path.isfile(os.path.join(jaxcache.CHECKOUT, "pyproject.toml"))
    assert jaxcache.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == default
    # the default never depends on the process: same path twice, no pid/time
    assert jaxcache.compile_cache_dir({}) == default
    assert str(os.getpid()) not in default


def test_enable_compile_cache_sets_the_default_only_without_env(monkeypatch):
    import jax

    from haploconduct_tpu.utils import jaxcache

    seen = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: seen.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere")
    jaxcache.enable_compile_cache.cache_clear()
    try:
        assert jaxcache.enable_compile_cache() == "/somewhere"
        assert seen == []
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        jaxcache.enable_compile_cache.cache_clear()
        path = jaxcache.enable_compile_cache()
        assert seen == [("jax_compilation_cache_dir", path)]
    finally:
        jaxcache.enable_compile_cache.cache_clear()
