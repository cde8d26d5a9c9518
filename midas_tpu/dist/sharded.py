"""Multi-device sharding: the replacement for the reference's
process-level parallelism (multiprocessing.Pool at utility.py:81-107,
RLIMIT-bounded sample batching at :38-57, line-range sharding at
merge/snps.py:366-386).

Parallel axes:
- "dp" (data parallel): read batches shard across chips; every chip
  aligns its shard against its local reference slice and per-species
  count tensors merge with psum — the device analogue of the reference's
  embarrassingly-parallel read streams.
- "tp" (index parallel): the packed reference + its seed index shard
  across chips (the reference sidesteps this because per-sample indexes
  fit RAM; a 5,952-species pangenome DB does not fit one chip's HBM).
  Each tp rank finds hits against its slice; the global best hit per
  read is resolved with pmax over scores + lowest-rank tie-break, all
  over ICI collectives.

The same step function runs under jit on any jax.sharding.Mesh — 8
virtual CPU devices in tests, a real pod slice in production (hosts
join via jax.distributed.initialize; the mesh spans all chips).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from midas_tpu.align.params import ScoringParams
from midas_tpu.align.pipeline import dispatch_banded_align
from midas_tpu.align.seed import SeedParams, find_candidates, gather_windows
from midas_tpu.db.index import SeedIndex, build_seed_index
from midas_tpu.db.refpack import GUARD, ReferencePack


def make_mesh(n_devices: int = None, tp: int = 1) -> Mesh:
    """1D/2D device mesh: ("dp", "tp"). tp divides the device count."""
    devices = np.array(jax.devices()[: n_devices or len(jax.devices())])
    dp = len(devices) // tp
    assert dp * tp == len(devices), (len(devices), tp)
    return Mesh(devices.reshape(dp, tp), ("dp", "tp"))


def shard_index(
    pack: ReferencePack, tp: int, k: int = 14, max_occ: int = 256,
) -> Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray]:
    """Split a ReferencePack into tp equal slices, each with its own seed
    index, padded to identical shapes for SPMD.

    Returns (pack_codes [tp, Gpad] int8, index arrays each [tp, ...],
    shard_base [tp] global offset of each slice)."""
    S = pack.num_seqs
    per = -(-S // tp)
    slices = []
    for r in range(tp):
        lo_seq, hi_seq = r * per, min((r + 1) * per, S)
        lo = int(pack.offsets[lo_seq]) if lo_seq < S else int(pack.offsets[-1])
        hi = int(pack.offsets[hi_seq]) if hi_seq <= S else int(pack.offsets[-1])
        sub = ReferencePack(
            codes=np.concatenate([pack.codes[lo:hi],
                                  np.full(GUARD, 4, dtype=np.int8)]),
            offsets=(pack.offsets[lo_seq: hi_seq + 1] - lo
                     if hi_seq > lo_seq else np.zeros(1, dtype=np.int64)),
            names=pack.names[lo_seq:hi_seq],
            lengths=pack.lengths[lo_seq:hi_seq],
        )
        slices.append((sub, lo, lo_seq))
    max_len = max(len(s.codes) for s, _lo, _ls in slices)
    max_pos = max(1, max(len(s.offsets) - 1 for s, _lo, _ls in slices))
    indexes = [build_seed_index(s, k=k, max_occ=max_occ) for s, _lo, _ls in slices]
    NB1 = max(len(ix.bucket1) for ix in indexes)
    NB2 = max(len(ix.bucket2) for ix in indexes)
    NR = max(len(ix.positions2d) for ix in indexes)
    # bucket addressing depends on the table size, so shards must agree
    # on NB1/NB2 exactly: rebuild any mismatched shard at the common
    # sizes (a forced-larger bucket2 can itself grow on overflow, hence
    # the loop; it converges because sizes only ratchet upward)
    while True:
        if all(len(ix.bucket1) == NB1 and len(ix.bucket2) == NB2
               for ix in indexes):
            break
        for r, ((sub, _lo, _ls), ix) in enumerate(zip(slices, indexes)):
            if len(ix.bucket1) != NB1 or len(ix.bucket2) != NB2:
                indexes[r] = build_seed_index(
                    sub, k=k, max_occ=max_occ,
                    min_table_size=NB1 * 8, min_buckets2=NB2)
        NB1 = max(len(ix.bucket1) for ix in indexes)
        NB2 = max(len(ix.bucket2) for ix in indexes)
    codes = np.full((tp, max_len), 4, dtype=np.int8)
    bucket1 = np.full((tp, NB1, 24), 0, dtype=np.int32)
    bucket1[:, :, :8] = -1
    bucket2 = np.full((tp, NB2, 24), 0, dtype=np.int32)
    bucket2[:, :, :8] = -1
    positions2d = np.zeros((tp, NR, 8), dtype=np.int32)
    offsets = np.zeros((tp, max_pos + 1), dtype=np.int32)
    shard_base = np.zeros(tp, dtype=np.int32)
    seq_base = np.zeros(tp, dtype=np.int32)
    for r, ((sub, lo, lo_seq), ix) in enumerate(zip(slices, indexes)):
        codes[r, : len(sub.codes)] = sub.codes
        bucket1[r, : len(ix.bucket1)] = ix.bucket1
        bucket2[r, : len(ix.bucket2)] = ix.bucket2
        positions2d[r, : len(ix.positions2d)] = ix.positions2d
        n_off = len(sub.offsets)
        offsets[r, :n_off] = sub.offsets
        offsets[r, n_off:] = sub.offsets[-1]
        shard_base[r] = lo
        seq_base[r] = lo_seq
    index_arrays = dict(bucket1=bucket1, bucket2=bucket2,
                        positions2d=positions2d)
    return codes, index_arrays, offsets, shard_base, seq_base


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "scoring", "seed_params", "max_len", "n_seqs"),
)
def distributed_profile_step(
    mesh: Mesh,
    codes: jnp.ndarray,          # [B, L] int8 (global batch)
    qlens: jnp.ndarray,          # [B]
    shard_pack_codes: jnp.ndarray,   # [tp, Gpad] int8
    shard_index_arrays: Dict[str, jnp.ndarray],  # each [tp, ...]
    shard_offsets: jnp.ndarray,  # [tp, S_loc+1] int32
    shard_seq_base: jnp.ndarray, # [tp] first global seq id of the slice
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    n_seqs: int,
) -> Dict[str, jnp.ndarray]:
    """One full distributed profiling step: seed + extend each read shard
    against every index shard, resolve the global best hit per read
    (pmax + lowest-rank tie-break over "tp"), and psum per-target-
    sequence mapped-read counts and aligned-bp depth over the whole mesh.

    Equivalent single-chip semantics: align_batch + best-hit counting.
    """
    C = seed_params.num_cands
    D = seed_params.band_width

    def local_step(codes, qlens, pack_codes, index_arrays, offsets, seq_base):
        # shapes inside shard_map: codes [B/dp, L]; pack/index local slice
        pack_codes = pack_codes[0]
        offsets = offsets[0]
        seq_base = seq_base[0]
        index_arrays = {k: v[0] for k, v in index_arrays.items()}
        B, L = codes.shape
        W = L + D - 1

        cands = find_candidates(index_arrays, codes, qlens, seed_params, max_len)
        winstart = cands["diag"] - D // 2
        ref_win, seq_idx = gather_windows(
            pack_codes, offsets, winstart, W,
            center=cands["diag"] + qlens[:, None] // 2)
        from midas_tpu.align.seed import revcomp_batch
        rc = revcomp_batch(codes, qlens)
        q_pair = jnp.where(cands["strand"][:, :, None] == 1,
                           rc[:, None, :], codes[:, None, :])
        q_pair = jnp.broadcast_to(q_pair, (B, C, L)).reshape(B * C, L)
        qlens_pair = jnp.broadcast_to(qlens[:, None], (B, C)).reshape(B * C)
        out = dispatch_banded_align(q_pair, qlens_pair,
                                    ref_win.reshape(B * C, W), scoring, D)
        score = jnp.where(cands["valid"],
                          out["score"].reshape(B, C), -jnp.inf)
        # local best candidate per read
        best_c = jnp.argmax(score, axis=1)
        rows = jnp.arange(B)
        local_best = score[rows, best_c]
        local_seq = seq_base + seq_idx[rows, best_c]
        local_bp = (out["matches"] + out["mismatches"] + out["gap_cols"]
                    ).reshape(B, C)[rows, best_c]

        # global best across index shards: pmax scores, lowest tp rank
        # wins ties
        tp_rank = jax.lax.axis_index("tp")
        global_best = jax.lax.pmax(local_best, "tp")
        is_best = (local_best == global_best) & jnp.isfinite(global_best)
        my_rank = jnp.where(is_best, tp_rank, jnp.iinfo(jnp.int32).max)
        win_rank = jax.lax.pmin(my_rank, "tp")
        i_win = is_best & (tp_rank == win_rank)

        # per-sequence mapped counts + aligned bp, merged over whole mesh
        seq_onehot = jnp.where(i_win, 1.0, 0.0)
        counts = jnp.zeros((n_seqs,), jnp.float32).at[local_seq].add(seq_onehot)
        bp = jnp.zeros((n_seqs,), jnp.float32).at[local_seq].add(
            jnp.where(i_win, local_bp.astype(jnp.float32), 0.0))
        counts = jax.lax.psum(counts, ("dp", "tp"))
        bp = jax.lax.psum(bp, ("dp", "tp"))
        aligned = jax.lax.psum(jnp.where(i_win, 1, 0).sum(), ("dp", "tp"))
        return counts, bp, aligned

    # check_vma=False: the 128-step DP scan's carry starts from literals
    # (unvarying) and becomes device-varying, which the static vma check
    # rejects; semantics are unaffected (outputs are psum-reduced).
    shard_fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp"), P("tp", None),
                  dict(bucket1=P("tp", None, None), bucket2=P("tp", None, None),
                       positions2d=P("tp", None, None)),
                  P("tp", None), P("tp")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    counts, bp, aligned = shard_fn(
        codes, qlens, shard_pack_codes, shard_index_arrays, shard_offsets,
        shard_seq_base)
    return dict(counts=counts, bp=bp, aligned_reads=aligned)
