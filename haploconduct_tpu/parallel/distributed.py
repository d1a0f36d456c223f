"""Multi-host process group + work sharding.

The reference has NO distributed backend (SURVEY §2f): its scale-out axes
are SAVAGE's random coverage patches (savage.py:286-342) and polyte-split's
genomic regions (polyte-split.py:297-354), both through the filesystem.
The mapping here: one jax.distributed process group across hosts,
patches/regions round-robined over processes, per-patch candidate streams
sharded over the global mesh inside verify_overlaps
(parallel/mesh.sharded_score_tasks), and the (small) per-patch contig sets
replicated to every host with allgather so the joint stages (SAVAGE stage
b/c) run identically everywhere.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


def maybe_initialize() -> bool:
    """Initialize jax.distributed when launched as a multi-process job.

    Triggered by the standard coordinator env vars (JAX_COORDINATOR_ADDRESS
    / COORDINATOR_ADDRESS, as set by cluster launchers) or an explicit
    HAPLO_DIST=1. Safe to call more than once."""
    import jax

    if jax.process_count() > 1:
        return True
    want = (os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("COORDINATOR_ADDRESS")
            or os.environ.get("HAPLO_DIST") == "1")
    if not want:
        return False
    try:
        jax.distributed.initialize()
        return True
    except (RuntimeError, ValueError):
        return jax.process_count() > 1


def process_count() -> int:
    try:
        import jax

        return jax.process_count()
    except Exception:
        return 1


def process_index() -> int:
    try:
        import jax

        return jax.process_index()
    except Exception:
        return 0


def my_work_items(n_items: int) -> List[int]:
    """Round-robin assignment of patch/region indices to this process."""
    pc, pi = process_count(), process_index()
    return [i for i in range(n_items) if i % pc == pi]


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Collect one byte blob from every process, in process order.

    Single-process: identity. Multi-host: two allgather rounds over the
    global devices (lengths, then max-padded payloads) via
    multihost_utils.process_allgather — DCN-backed, host-level data only
    (contig sets are tiny next to the candidate streams that ride ICI)."""
    if process_count() == 1:
        return [payload]
    from jax.experimental import multihost_utils

    arr = np.frombuffer(payload, dtype=np.uint8)
    lengths = multihost_utils.process_allgather(
        np.array([len(arr)], dtype=np.int64), tiled=True)
    max_len = int(lengths.max())
    padded = np.zeros(max_len, dtype=np.uint8)
    padded[:len(arr)] = arr
    gathered = multihost_utils.process_allgather(
        padded.reshape(1, -1), tiled=True)
    return [gathered[i, :int(lengths[i])].tobytes()
            for i in range(process_count())]


def encode_store_subreads(store, subreads) -> dict:
    """JSON-serializable form of a (ReadStore, SubreadDict) pair; the
    subreads travel in the reference's subreads.txt text format."""
    from ..io.subreads import subreads_to_text

    if store is None:
        return None
    singles = []
    paired = []
    for i in range(len(store)):
        rid = store.ids[i]
        if store.is_paired[i]:
            paired.append((rid, store.seq_str(i, 1), store.phred_str(i, 1),
                           store.seq_str(i, 2), store.phred_str(i, 2)))
        else:
            singles.append((rid, store.seq_str(i), store.phred_str(i)))
    return {
        "singles": singles,
        "paired": paired,
        "subreads": subreads_to_text(subreads) if subreads else "",
    }


def decode_store_subreads(blob):
    from ..core.reads import ReadStore
    from ..io.subreads import subreads_from_text

    if blob is None:
        return None, None
    store = ReadStore()
    for rid, seq, phred in blob["singles"]:
        store.add_single(int(rid), seq, phred)
    store.readcount_single = len(blob["singles"])
    for rid, s1, p1, s2, p2 in blob["paired"]:
        store.add_paired(int(rid), s1, p1, s2, p2)
    sub = subreads_from_text(blob["subreads"]) if blob["subreads"] else None
    return store, sub


def allgather_indexed(items: Sequence, indices: Sequence[int], n_total: int,
                      encode, decode, allow_missing: bool = False) -> list:
    """Merge per-process work results back into dense index order.

    Each process serializes its items to JSON blobs, allgathers the blobs,
    and reconstructs every index locally — after this call every host holds
    ALL results and the joint downstream stages proceed replicated."""
    if process_count() == 1:
        return list(items)
    import json

    my_blob = json.dumps({str(idx): encode(res)
                          for idx, res in zip(indices, items)}).encode()
    merged: dict = {}
    for data in allgather_bytes(my_blob):
        for key, blob in json.loads(data.decode()).items():
            merged[int(key)] = decode(blob) if blob is not None else None
    missing = [i for i in range(n_total) if i not in merged]
    if missing and not allow_missing:
        raise RuntimeError(f"work items {missing} produced by no process")
    return [merged.get(i) for i in range(n_total)]


def allgather_stage_results(results: Sequence, indices: Sequence[int],
                            n_total: int) -> list:
    """allgather_indexed specialization for assemble.stages.StageResult."""

    def encode(res) -> dict:
        blob = encode_store_subreads(res.store, res.subreads)
        blob["iterations"] = res.iterations
        return blob

    def decode(blob: dict):
        from ..assemble.stages import StageResult

        store, sub = decode_store_subreads(blob)
        return StageResult(store=store, subreads=sub, overlap_lines=[],
                           iterations=int(blob["iterations"]))

    return allgather_indexed(results, indices, n_total, encode, decode)
