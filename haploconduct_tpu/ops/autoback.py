"""Automatic verification-backend selection (backend="auto").

The question is host OpenMP engine vs device for the verification stream.
backend="auto" measures the link to device 0 once per process (no kernel
compile: h2d/d2h round trips with random payloads), projects the device
path's rate for a representative batch from that link and the scorer's
measured on-device rate, micro-benchmarks the native engine, and takes the
device when its projection beats the native rate by CROSSOVER. On a
machine whose only platform is the CPU the native engine is used without
probing. Reference analog: the engine-selection flag plumbing of
savage.py:643-677 (rust-overlaps vs blast fallback selection).

HC_BACKEND=native|jax|numpy overrides the probe entirely.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np

# Bytes over the link per verification task on the single-device path
# (ops/score.py:score_tasks_jax): four int32 subtask columns up (rowa,
# rowb, posa, bolen) and four 4-byte results down (sum_log, counted,
# mismatches, rejected). Read-scale tasks are one subtask each. The packed
# read matrix is uploaded once per call and is left out.
BYTES_PER_TASK = 4.0 * 4 + 4.0 * 4
# Scorer rate on the device (tasks/s): the jitted segment body over one
# 65,536-subtask batch of 150 bp reads took 0.107 ms per call (50 calls back
# to back, mean of two runs) on one NVIDIA H100 80GB HBM3 at a 700 W power
# limit, about 6e8 subtasks/s.
ONCHIP_RATE = 6.0e8
PROBE_TASKS = 1e6  # representative dispatch batch
# The device must project more than CROSSOVER times the native engine's
# rate to be chosen; the guard absorbs probe noise.
CROSSOVER = 5.0

_cache: dict = {}


def probe_link(size: int = 1 << 20) -> dict:
    """Measured link characteristics to device 0: h2d/d2h bytes/s and a
    fixed per-transfer latency (seconds), from one small + one `size`-byte
    transfer each way. Payloads are random, so no layer can shortcut a
    repeated buffer."""
    import jax

    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    tiny = rng.integers(0, 256, 64, dtype=np.uint8)
    big = rng.integers(0, 256, size, dtype=np.uint8)

    t0 = time.perf_counter()
    d_tiny = jax.device_put(tiny, dev)
    d_tiny.block_until_ready()
    lat_h2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(d_tiny)
    lat_d2h = time.perf_counter() - t0

    t0 = time.perf_counter()
    d_big = jax.device_put(big, dev)
    d_big.block_until_ready()
    t_h2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(d_big)
    t_d2h = time.perf_counter() - t0

    lat = max(min(lat_h2d, lat_d2h), 1e-6)
    return {
        "h2d_Bps": size / max(t_h2d - lat_h2d, 1e-9),
        "d2h_Bps": size / max(t_d2h - lat_d2h, 1e-9),
        "lat_s": lat,
    }


def probe_native_rate(n_tasks: int = 65536) -> float:
    """Quick micro-bench of the native OpenMP scorer (verifs/s) on
    synthetic 150bp tasks."""
    from ..native import load_baseline_ext

    ext = load_baseline_ext()
    if ext is None:
        return 0.0
    rng = np.random.default_rng(1)
    n_reads, L = 256, 150
    codes = rng.integers(0, 4, (2 * n_reads, L), dtype=np.int8)
    quals = np.full((2 * n_reads, L), 30, dtype=np.uint8)
    lens = np.full(2 * n_reads, L, dtype=np.int32)
    row_a = rng.integers(0, n_reads, n_tasks, dtype=np.int32)
    row_b = rng.integers(0, n_reads, n_tasks, dtype=np.int32)
    pos = rng.integers(0, L // 2, n_tasks, dtype=np.int32)
    ext.score_tasks(codes, quals, lens, row_a, row_b, pos)  # warm
    t0 = time.perf_counter()
    ext.score_tasks(codes, quals, lens, row_a, row_b, pos)
    dt = time.perf_counter() - t0
    return n_tasks / max(dt, 1e-9)


def decide(platform: str, probe: Optional[dict],
           native_rate: float) -> tuple:
    """Pure decision rule (unit-testable with faked probes). Returns
    (backend, info)."""
    if platform == "cpu":
        # the "device" is the host: the native engine does the same f64
        # work without XLA's CPU backend in between
        return "native", {"reason": "cpu-only platform"}
    if probe is None or native_rate <= 0.0:
        return "jax", {"reason": "no native engine — chip is the only path"}
    link_Bps = min(probe["h2d_Bps"], probe["d2h_Bps"])
    dispatch_s = (PROBE_TASKS * BYTES_PER_TASK / max(link_Bps, 1.0)
                  + 3 * probe["lat_s"]  # upload, dispatch, fetch
                  + PROBE_TASKS / ONCHIP_RATE)
    device_rate = PROBE_TASKS / dispatch_s
    info = {
        "link_Bps": link_Bps,
        "lat_s": probe["lat_s"],
        "projected_device_rate": device_rate,
        "native_rate": native_rate,
    }
    if device_rate > CROSSOVER * native_rate:
        return "jax", info
    return "native", info


def resolve_backend() -> str:
    """Resolve backend="auto" once per process; logs the measured probe.
    A failure to reach JAX or the device propagates: it is not a reason to
    pick the host."""
    if "backend" in _cache:
        return _cache["backend"]
    env = os.environ.get("HC_BACKEND")
    if env in ("native", "jax", "numpy"):
        _cache["backend"] = env
        return env
    import jax

    platform = jax.devices()[0].platform
    if platform == "cpu":
        choice, info = decide(platform, None, 0.0)
    else:
        native_rate = probe_native_rate()
        probe = probe_link() if native_rate > 0.0 else None
        choice, info = decide(platform, probe, native_rate)
    desc = ", ".join(f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in info.items())
    print(f"[auto-backend] platform={platform} -> {choice} ({desc})",
          file=sys.stderr, flush=True)
    _cache["backend"] = choice
    return choice
