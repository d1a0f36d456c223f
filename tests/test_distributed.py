"""Multi-host execution test: a REAL 2-process jax.distributed group on
the CPU backend running SAVAGE with --split patches round-robined over
processes (parallel/distributed.py). Every process must converge to the
same contigs as the single-process run — the allgather of per-patch stage
a results makes the joint stages replicated (savage.py:373-396 was
sequential per-patch in the reference; SURVEY §2f multi-host mapping).
"""

import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    coord, pid = sys.argv[1], int(sys.argv[2])
    jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                               process_id=pid)
    sys.path.insert(0, %(repo)r)
    import numpy as np
    from haploconduct_tpu.core.reads import ReadStore
    from haploconduct_tpu.utils.simulate import random_genome, simulate_reads
    from haploconduct_tpu.workflows.savage import SavageConfig, run_savage

    rng = np.random.default_rng(11)
    genome = random_genome(rng, 2500)
    seqs, quals = simulate_reads([genome], coverage=30, read_len=150,
                                 rng=rng, error_rate=0.002)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    cfg = SavageConfig(min_overlap_len=80, split_num=2, backend="numpy",
                       stage_b=False, stage_c=False, filtering=False)
    res = run_savage(store, cfg)
    st = res.stage_a.store
    recs = sorted(st.seq_str(i) for i in range(len(st)))
    out = sys.argv[3]
    with open(out, "w") as f:
        f.write("\\n".join(recs))
""") % {"repo": REPO}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two_process(worker_path, outs, attempts=2):
    """Launch the 2-process group; retry once with a fresh coordinator port
    — under full-suite CPU contention the jax.distributed handshake can
    time out or the freed port can be re-taken before the workers bind."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # one CPU device per process
    last_err = b""
    for _ in range(attempts):
        coord = f"127.0.0.1:{_free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, worker_path, coord, str(pid), outs[pid]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for pid in range(2)]
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=600)
            errs.append(err)
        if all(p.returncode == 0 for p in procs):
            return
        last_err = b"\n".join(errs)
    raise AssertionError(last_err.decode()[-3000:])


# Worker for the sharded-scorer test: a REAL 2-process global mesh (one CPU
# device per process) pushed through verify_overlaps — which must route to
# parallel/mesh.py:sharded_score_tasks, exercising the multi-host global-
# array construction (make_array_from_callback) and the shard fetch +
# process-allgather on the way back — and through a full run_stage.
# Every decision must be byte-identical to the single-process f64 oracle
# (reference hot loop src/EdgeCalculator.cpp:395-423).
SCORER_WORKER = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    coord, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                               process_id=pid)
    assert jax.process_count() == 2 and jax.device_count() == 2
    sys.path.insert(0, %(repo)r)
    import numpy as np
    from haploconduct_tpu.core.reads import ReadStore
    from haploconduct_tpu.utils.simulate import random_genome, simulate_reads
    from haploconduct_tpu.ops.kmer import find_overlap_candidates
    from haploconduct_tpu.io.sfo import sfo_to_overlaps
    from haploconduct_tpu.utils.config import Settings
    from haploconduct_tpu.ops import verify as V
    from haploconduct_tpu.assemble.stages import StageParams, run_stage

    rng = np.random.default_rng(5)
    genome = random_genome(rng, 2500)
    seqs, quals = simulate_reads([genome], coverage=25, read_len=150,
                                 rng=rng, error_rate=0.002)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    sseqs = [store.unit_codes(u) for u in range(store.n_units)]
    sfo = find_overlap_candidates(sseqs, min_overlap_len=80, k=20,
                                  error_rate=0.01)
    ov = sfo_to_overlaps(sfo, len(store), 0)

    # --- verify_overlaps through the 2-process global mesh vs the oracle
    packed = store.pack()
    s_mesh = Settings(min_overlap_len=80, edge_threshold=0.97, backend="jax")
    s_np = s_mesh.derive(backend="numpy")
    vr_np = V.verify_overlaps(store, packed, ov, s_np)
    before = V.BACKEND_COUNTS["mesh"]
    vr = V.verify_overlaps(store, packed, ov, s_mesh)
    assert V.BACKEND_COUNTS["mesh"] > before, V.BACKEND_COUNTS
    for f in ("v1", "v2", "pos1", "mismatch_rate"):
        assert np.array_equal(vr.edges[f], vr_np.edges[f]), f
    assert np.array_equal(vr.nonedge_mask, vr_np.nonedge_mask)
    assert np.allclose(vr.edges["score"], vr_np.edges["score"], atol=2e-3)

    # --- full stage through the mesh == full stage through the oracle
    params = StageParams(stage="a", min_overlap_len=80, edge_threshold=0.97,
                         original_readcount=len(store), backend="jax")
    before = V.BACKEND_COUNTS["mesh"]
    res = run_stage(params, store, ov)
    assert V.BACKEND_COUNTS["mesh"] > before, V.BACKEND_COUNTS
    params_np = StageParams(stage="a", min_overlap_len=80,
                            edge_threshold=0.97,
                            original_readcount=len(store), backend="numpy")
    res_np = run_stage(params_np, store, ov)
    mesh_recs = [res.store.seq_str(i) for i in range(len(res.store))]
    np_recs = [res_np.store.seq_str(i) for i in range(len(res_np.store))]
    assert mesh_recs == np_recs and mesh_recs
    with open(out, "w") as f:
        f.write("\\n".join(mesh_recs))
""") % {"repo": REPO}


def test_two_process_global_mesh_scorer_and_stage(tmp_path):
    """sharded_score_tasks under jax.process_count()==2: verify_overlaps and
    a full run_stage on a 2-process global mesh, byte-identical to the f64
    oracle, identical across processes."""
    worker = tmp_path / "scorer_worker.py"
    worker.write_text(SCORER_WORKER)
    outs = [str(tmp_path / f"scontigs{i}.txt") for i in range(2)]
    _run_two_process(str(worker), outs)
    with open(outs[0]) as f:
        recs0 = f.read()
    with open(outs[1]) as f:
        recs1 = f.read()
    assert recs0 == recs1 and recs0


def test_two_process_savage_matches_single(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    outs = [str(tmp_path / f"out{i}.txt") for i in range(2)]
    _run_two_process(str(worker), outs)

    with open(outs[0]) as f:
        recs0 = f.read()
    with open(outs[1]) as f:
        recs1 = f.read()
    assert recs0 == recs1 and recs0  # both processes hold ALL contigs

    # single-process run must match the distributed result
    import numpy as np

    from haploconduct_tpu.core.reads import ReadStore
    from haploconduct_tpu.utils.simulate import random_genome, simulate_reads
    from haploconduct_tpu.workflows.savage import SavageConfig, run_savage

    rng = np.random.default_rng(11)
    genome = random_genome(rng, 2500)
    seqs, quals = simulate_reads([genome], coverage=30, read_len=150,
                                 rng=rng, error_rate=0.002)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    cfg = SavageConfig(min_overlap_len=80, split_num=2, backend="numpy",
                       stage_b=False, stage_c=False, filtering=False)
    res = run_savage(store, cfg)
    st = res.stage_a.store
    single = "\n".join(sorted(st.seq_str(i) for i in range(len(st))))
    assert single == recs0
