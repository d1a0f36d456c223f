"""Unit tests for the reference-semantics order helpers (native/refsem.cpp):
the libstdc++ unordered_map iteration-order oracle and the quick-cliques
reference-order Bron-Kerbosch. The slow end-to-end proof that these orders
produce bit-identical contigs lives in test_reference_parity.py (RUN_SLOW)."""

import numpy as np
import pytest

from haploconduct_tpu.native import load_refsem_ext
from haploconduct_tpu.graph.cliques import enumerate_cliques, enumerate_cliques_ref
from haploconduct_tpu.utils.cpporder import reorder_map, umap_order

ext = load_refsem_ext()
pytestmark = pytest.mark.skipif(ext is None, reason="refsem extension unavailable")


def test_umap_order_small():
    # libstdc++: bucket_count 1 -> 13 -> 29...; per-bucket head insertion.
    # Values checked against a directly compiled std::unordered_map probe.
    assert umap_order([5, 3, 9, 1, 7]) == [7, 1, 9, 3, 5]
    assert umap_order(list(range(15))) == [14, 13] + list(range(13))


def test_umap_order_is_permutation():
    rng = np.random.default_rng(1)
    for n in (1, 2, 13, 14, 100, 1000):
        keys = rng.choice(10 ** 6, size=n, replace=False).tolist()
        order = umap_order(keys)
        assert sorted(order) == sorted(keys)


def test_umap_order_depends_only_on_sequence():
    keys = [10, 20, 30, 40, 50]
    assert umap_order(keys) == umap_order(list(keys))
    assert umap_order(keys) != umap_order(keys[::-1]) or len(keys) <= 1


def test_umap_order_canary_fixture():
    """Recorded-fixture canary: reference_order mode
    assumes the LOCAL libstdc++'s unordered_map hash policy matches the one
    the reference binary was built against. The fixture pins the replayed
    iteration order for sequences crossing several prime bucket-growth
    boundaries (13/29/59/127) and for large random keys; a hash-policy or
    growth-policy drift in a libstdc++ upgrade fails here loudly instead of
    silently breaking bit-identical parity (native/refsem.cpp:54-64)."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "umap_order_canary.json")
    with open(path) as f:
        cases = json.load(f)
    assert len(cases) >= 10
    for name, rec in cases.items():
        assert umap_order(rec["keys"]) == rec["order"], (
            f"libstdc++ unordered_map iteration order drifted (case {name}); "
            "reference_order parity mode is no longer bit-exact on this host")


def test_reorder_map_preserves_items():
    d = {k: k * 10 for k in [5, 3, 9, 1, 7]}
    r = reorder_map(d)
    assert dict(r) == dict(d)
    assert list(r.keys()) == [7, 1, 9, 3, 5]


def _random_pairs(rng, n, p):
    """Directed pair sequence in graph.txt style: (i,j),(j,i) back-to-back."""
    A = np.triu(rng.random((n, n)) < p, 1)
    us, vs = [], []
    for i in range(n):
        nbrs = np.flatnonzero(A[i])
        rng.shuffle(nbrs)
        for j in nbrs:
            us += [i, int(j)]
            vs += [int(j), i]
    return np.asarray(us, np.int64), np.asarray(vs, np.int64)


def test_ref_order_cliques_same_set_as_spec_order():
    rng = np.random.default_rng(2)
    for n, p in [(10, 0.5), (40, 0.2), (120, 0.06)]:
        u, v = _random_pairs(rng, n, p)
        ref = enumerate_cliques_ref(n, u, v)
        spec = enumerate_cliques(n, u, v)
        assert sorted(tuple(sorted(c)) for c in ref) == \
               sorted(tuple(sorted(c)) for c in spec)


def test_ref_order_cliques_isolated_vertices_are_singletons():
    # degree buckets are LIFO, so vertex 1 leaves the degeneracy order
    # after 0 and becomes the clique base ([1, 0], not [0, 1])
    ref = enumerate_cliques_ref(4, np.array([0, 1], np.int64), np.array([1, 0], np.int64))
    assert ref == [[1, 0], [2], [3]]


def test_ref_order_canary_fixture():
    """Recorded-fixture canary: pins the reference qc
    binary's exact clique EMISSION ORDER (degeneracy BK,
    quick-cliques/src/DegeneracyAlgorithm.cpp) for 8 random graphs spanning
    sparse/dense/empty regimes, so `enumerate_cliques_ref` is guarded in the
    default suite without needing the binary. Regenerate with the recipe in
    tests/fixtures/README if the fixture ever needs updating."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "qc_clique_order_canary.json")
    with open(path) as f:
        cases = json.load(f)
    assert len(cases) >= 8
    for name, rec in cases.items():
        u = np.asarray(rec["u"], np.int64)
        v = np.asarray(rec["v"], np.int64)
        got = enumerate_cliques_ref(rec["n"], u, v)
        assert got == rec["cliques"], (
            f"clique emission order drifted from the reference qc binary "
            f"(case {name}); reference_order parity mode is broken")


def test_ref_order_matches_qc_binary_when_available():
    import os
    import subprocess

    qc = "/root/repo/tools/refbuild/quick-cliques/bin/qc"
    if not os.path.exists(qc):
        pytest.skip("reference qc binary not built (RUN_SLOW parity builds it)")
    rng = np.random.default_rng(3)
    for n, p in [(30, 0.3), (80, 0.1)]:
        u, v = _random_pairs(rng, n, p)
        lines = [str(n), str(len(u))] + [f"{a},{b}" for a, b in zip(u, v)]
        out = subprocess.run(
            [qc, "--algorithm=degeneracy", "--input-file=/dev/stdin"],
            input="\n".join(lines) + "\n", capture_output=True, text=True)
        expected = []
        for line in out.stdout.splitlines():
            parts = line.split()
            if parts and all(t.isdigit() for t in parts):
                expected.append([int(t) for t in parts])
        assert enumerate_cliques_ref(n, u, v) == expected
