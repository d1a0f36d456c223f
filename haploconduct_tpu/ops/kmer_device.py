"""Device-side overlap candidate generation (k-mer sort-join).

The device replacement for rust-overlaps' FM-index search: k-mer
hashes over the packed unit matrix are computed with shifted fused
elementwise ops, sorted with XLA's sort, joined against queries with
vectorized searchsorted + bounded group expansion, and deduplicated by
key-sort — all on device. The candidate set can then feed the
verification kernel without leaving device memory; only verified survivors return
to host.

Shapes are static: the join emits up to `expand` matches per query k-mer
(groups larger than `max_group` are dropped entirely, matching the host
engine's repetitive-k-mer guard), and the output is a fixed-capacity
array with a validity count.

k is capped at 15 so hashes fit int32 (4^15 < 2^31); sensitivity at k=15
is slightly higher than the host default k=20 (more seeds), which only
adds candidates that verification filters.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from ..core.reads import N_CODE


@functools.lru_cache(maxsize=16)
def _build_join(R: int, W: int, k: int, expand: int, max_group: int):
    import jax
    import jax.numpy as jnp

    NK = W - k + 1

    def kmer_hashes(codes):
        """(rows, NK) int32 hashes; -1 where the window has N/pad."""
        h = jnp.zeros(codes[:, :NK].shape, jnp.int32)
        bad = jnp.zeros(codes[:, :NK].shape, jnp.bool_)
        for j in range(k):
            c = codes[:, j:j + NK].astype(jnp.int32)
            h = h * 4 + jnp.where(c < N_CODE, c, 0)
            bad = bad | (c >= N_CODE)
        return jnp.where(bad, -1, h)

    def run(codes_fwd, codes_rev):
        # --- table: forward k-mers, sorted by hash
        th = kmer_hashes(codes_fwd).reshape(-1)
        rows = jax.lax.broadcasted_iota(jnp.int32, (R, NK), 0).reshape(-1)
        poss = jax.lax.broadcasted_iota(jnp.int32, (R, NK), 1).reshape(-1)
        # push invalid to the end with hash = int32 max
        tkey = jnp.where(th < 0, jnp.int32(2**31 - 1), th)
        tkey, t_rid, t_pos = jax.lax.sort((tkey, rows, poss), num_keys=1)

        def join(qh_mat, rev: bool):
            qh = qh_mat.reshape(-1)
            q_rid = rows
            q_pos = poss
            left = jnp.searchsorted(tkey, qh, side="left").astype(jnp.int32)
            right = jnp.searchsorted(tkey, qh, side="right").astype(jnp.int32)
            count = right - left
            ok_q = (qh >= 0) & (count <= max_group)
            outs = []
            for d in range(expand):
                t_idx = jnp.minimum(left + d, len(tkey) - 1)
                valid = ok_q & (d < count)
                rid_b = t_rid[t_idx]
                pos_b = t_pos[t_idx]
                valid &= rid_b != q_rid
                # diagonal in the query frame
                shift = q_pos - pos_b
                outs.append((valid, q_rid, rid_b, shift))
            v = jnp.concatenate([o[0] for o in outs])
            qa = jnp.concatenate([o[1] for o in outs])
            tb = jnp.concatenate([o[2] for o in outs])
            sh = jnp.concatenate([o[3] for o in outs])
            if rev:
                # map the rev-query diagonal back to A's forward frame:
                # shift' = len(A) - (shift + len(B)) -- done by caller with
                # lens; here we just tag rev in the key
                pass
            return v, qa, tb, sh

        v1, qa1, tb1, sh1 = join(kmer_hashes(codes_fwd), rev=False)
        v2, qa2, tb2, sh2 = join(kmer_hashes(codes_rev), rev=True)
        valid = jnp.concatenate([v1, v2])
        qa = jnp.concatenate([qa1, qa2])
        tb = jnp.concatenate([tb1, tb2])
        sh = jnp.concatenate([sh1, sh2])
        rev = jnp.concatenate([jnp.zeros_like(v1, jnp.int32),
                               jnp.ones_like(v2, jnp.int32)])
        # Dedup + compact ON DEVICE so the host fetches only the unique
        # (idA, idB, shift, rev) diagonals instead of the full
        # R*NK*expand*2-slot buffer (4.4M valid slots -> ~10-100k uniques
        # on contig workloads). Keys are two int32 lanes
        # ((qa<<16)|tb needs R < 2^16 — asserted by the caller); invalid
        # slots sort last via the leading inv lane.
        inv = jnp.logical_not(valid).astype(jnp.int32)
        key1 = (qa << 16) | tb
        key2 = ((sh + (1 << 23)) << 1) | rev
        inv_s, k1s, k2s, qs, ts, ss, rs = jax.lax.sort(
            (inv, key1, key2, qa, tb, sh, rev), num_keys=3)
        first = jnp.concatenate([
            jnp.ones(1, jnp.bool_),
            (inv_s[1:] != inv_s[:-1]) | (k1s[1:] != k1s[:-1])
            | (k2s[1:] != k2s[:-1])])
        keep = first & (inv_s == 0)
        order = jnp.argsort(jnp.logical_not(keep), stable=True)
        n_unique = jnp.sum(keep).astype(jnp.int32)
        return qs[order], ts[order], ss[order], rs[order], n_unique

    return jax.jit(run)


@functools.lru_cache(maxsize=16)
def _build_dedup(n: int):
    import jax
    import jax.numpy as jnp

    def run(keys):
        skeys = jax.lax.sort(keys)
        first = jnp.concatenate([jnp.array([True]), skeys[1:] != skeys[:-1]])
        # invalid entries share the int64-max sentinel; they collapse into
        # one flagged slot which the caller strips
        return skeys, first

    return jax.jit(run)


def find_overlap_candidates_device(
    seqs,
    min_overlap_len: int,
    k: int = 15,
    expand: int = 32,
    max_group: int = 512,
    error_rate: float = 0.0,
    verify: bool = True,
):
    """Device candidate generation; returns an SFO array like the host
    engine (ops/kmer.py). Falls back to identical output semantics:
    canonical idA<idB rows with diagonal-derived overhangs; with
    `verify`, candidates exceeding the error rate on their diagonal are
    dropped."""
    import jax.numpy as jnp

    from ..core.reads import PAD_CODE, revcomp_codes
    from ..io.sfo import SFO_DTYPE
    from ..utils.jaxcache import enable_compile_cache

    enable_compile_cache()

    n = len(seqs)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    if n == 0:
        return np.zeros(0, dtype=SFO_DTYPE)
    assert n < (1 << 16), "device join packs (idA, idB) into one int32 lane"
    w = int(lens.max())
    codes_fwd = np.full((n, w), PAD_CODE, np.int8)
    codes_rev = np.full((n, w), PAD_CODE, np.int8)
    for i, s in enumerate(seqs):
        codes_fwd[i, :len(s)] = s
        codes_rev[i, :len(s)] = revcomp_codes(s)

    join = _build_join(n, w, min(k, 15), expand, max_group)
    d_qa, d_tb, d_sh, d_rev, d_n = join(jnp.asarray(codes_fwd),
                                        jnp.asarray(codes_rev))
    nv = int(d_n)
    # fetch only the compacted valid prefix (device-side slice, tiny copy)
    qa, tb, sh, rev = (np.asarray(x[:nv]) for x in (d_qa, d_tb, d_sh, d_rev))

    # frame mapping + canonicalization (same algebra as the host engine)
    la = lens[qa]
    lb = lens[tb]
    shift = np.where(rev == 1, la - (sh + lb), sh)
    start = np.maximum(0, shift)
    end = np.minimum(la, shift + lb)
    ov = end - start
    keep = ov >= min_overlap_len
    qa, tb, shift, rev, la, lb = (x[keep] for x in (qa, tb, shift, rev, la, lb))
    swap = qa > tb
    ida = np.where(swap, tb, qa)
    idb = np.where(swap, qa, tb)
    shift = np.where(swap, np.where(rev == 1, shift + lb - la, -shift), shift)

    from .kmer import _pack_keys

    key = _pack_keys(ida, idb, shift, rev)
    order = np.unique(key, return_index=True)[1]
    ida, idb, shift, rev = ida[order], idb[order], shift[order], rev[order]
    la, lb = lens[ida], lens[idb]

    oha = shift
    ohb = (shift + lb) - la
    start = np.maximum(0, shift)
    end = np.minimum(la, shift + lb)
    ov = end - start
    out = np.zeros(len(ida), dtype=SFO_DTYPE)
    out["ida"] = ida
    out["idb"] = idb
    out["ori"] = np.where(rev == 1, b"I", b"N")
    out["oha"] = oha
    out["ohb"] = ohb
    out["ola"] = ov
    out["olb"] = ov
    out["k"] = np.ceil(error_rate * ov).astype(np.int64)
    if verify and len(out):
        from .kmer import _verify_candidates

        out = _verify_candidates(seqs, lens, out, error_rate)
    return out
