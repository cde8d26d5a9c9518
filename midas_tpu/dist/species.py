"""Distributed species profiling: the FULL marker-gene classifier
(per-marker %id cutoffs, query coverage, best-score-with-ties,
unique/ambiguous split — reference semantics midas/run/species.py:64-119)
running over a dp x tp jax.sharding.Mesh.

Axes:
- "dp": the read batch shards across chips (the reference's
  embarrassingly-parallel read streams).
- "tp": the marker pack + bucketed seed index shard across chips by
  target sequence; each rank finds its top candidates against its
  slice, then the per-read candidate tables are reassembled with one
  all_gather over "tp" and the classifier math runs on the gathered
  [B/dp, tp*C] table — identical semantics to the single-chip
  species_update (profile/device_steps.py:160), just with the
  candidate set drawn from per-shard top-C searches.

Per-species unique counts/bp merge with psum over "dp" (tp ranks hold
identical copies after the gather); ambiguous tie rows are returned at
global batch granularity and appended into the replicated spill buffer
outside the shard_map, preserving stream order so the host RNG
assignment (species.py:104-119) sees the same sequence as a
single-chip run.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from midas_tpu.align.params import ScoringParams
from midas_tpu.align.pipeline import _align_batch_stages
from midas_tpu.align.seed import SeedParams, pack_words_host
from midas_tpu.db.refpack import ReferencePack
from midas_tpu.dist.sharded import make_mesh, shard_index
from midas_tpu.profile import device_steps as ds
from midas_tpu.profile.species import SpeciesProfiler

NEG_INF = ds.NEG_INF


def shard_pack_arrays(
    pack: ReferencePack, tp: int, k: int = 14, max_occ: int = 256,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], np.ndarray]:
    """Split a ReferencePack into tp sequence-disjoint slices and build
    the word-packed pack_arrays + bucketed index arrays each slice's
    rank aligns against (all stacked [tp, ...] for SPMD).

    Returns (index_arrays, pack_arrays, seq_base) where seq_base[r] is
    the global index of rank r's first sequence."""
    codes, index_arrays, offsets, _shard_base, seq_base = shard_index(
        pack, tp=tp, k=k, max_occ=max_occ)
    words_l, nmask_l = [], []
    for r in range(tp):
        w, nm = pack_words_host(codes[r])
        words_l.append(w)
        nmask_l.append(nm)
    pack_arrays = dict(
        words=np.stack(words_l), nmask=np.stack(nmask_l),
        offsets=offsets.astype(np.int32))
    return index_arrays, pack_arrays, seq_base.astype(np.int32)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "scoring", "seed_params", "max_len",
                     "aln_cov", "n_species", "dblen"),
    donate_argnames=("state",),
)
def dist_species_update(
    mesh: Mesh,
    state: ds.SpeciesState,
    shard_index_arrays: Dict[str, jnp.ndarray],  # each [tp, ...]
    shard_pack_arrays: Dict[str, jnp.ndarray],   # words/nmask/offsets [tp, ...]
    seq_base: jnp.ndarray,       # [tp] i32
    seq_species: jnp.ndarray,    # [num_seqs] i32 (replicated)
    seq_cutoff: jnp.ndarray,     # [num_seqs] f32 (replicated)
    codes: jnp.ndarray,          # [B, L] global batch
    qlens: jnp.ndarray,          # [B]
    n_reads: jnp.ndarray,        # scalar i32
    ord_base: jnp.ndarray,       # scalar i32 global stream rank of row 0
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    aln_cov: float,
    n_species: int,
    dblen: float = 0.0,
) -> ds.SpeciesState:
    """One distributed species-classifier batch. The carried state is
    replicated (its per-batch deltas are psum-merged inside); its amb
    buffer must be (amb_cap+1, tp * seed_params.num_cands) wide.
    dblen > 0 enables the hs-blastn -evalue gate, exactly as in the
    single-chip species_update (dblen is the GLOBAL pack length — the
    e-value is a whole-database statistic even when the index is
    tp-sharded)."""
    C = seed_params.num_cands

    def local(codes, qlens, n_reads, idx_a, pack_a, sb, seq_species, seq_cutoff):
        idx_a = {k: v[0] for k, v in idx_a.items()}
        pack_a = {k: v[0] for k, v in pack_a.items()}
        sb = sb[0]
        Bl = codes.shape[0]
        out = _align_batch_stages(idx_a, pack_a, codes, qlens,
                                  scoring, seed_params, max_len)
        dp_rank = jax.lax.axis_index("dp")
        real = dp_rank * Bl + jnp.arange(Bl) < n_reads
        aln = out["matches"] + out["mismatches"] + out["gap_cols"]
        pid = 100.0 * out["matches"].astype(jnp.float32) / jnp.maximum(
            aln.astype(jnp.float32), 1.0)
        gseq = sb + out["seq_idx"]
        cutoff = seq_cutoff[gseq]
        qcov = aln.astype(jnp.float32) / jnp.maximum(
            qlens[:, None].astype(jnp.float32), 1.0)
        keep = (out["valid"] & (out["score"] > 0) & (pid >= cutoff)
                & (qcov >= aln_cov) & real[:, None])
        if dblen > 0:
            ethr = scoring.evalue_score_threshold(
                jnp.maximum(qlens, 1), float(dblen))
            keep = keep & (out["score"] >= ethr[:, None])
        score_k = jnp.where(keep, out["score"], NEG_INF)
        sp = seq_species[gseq]

        # reassemble the full per-read candidate table across index shards
        g_score = jax.lax.all_gather(score_k, "tp", axis=1, tiled=True)
        g_aln = jax.lax.all_gather(aln, "tp", axis=1, tiled=True)
        g_sp = jax.lax.all_gather(sp, "tp", axis=1, tiled=True)
        g_seq = jax.lax.all_gather(gseq, "tp", axis=1, tiled=True)

        best = jnp.max(g_score, axis=1)
        has_hit = best > NEG_INF / 2
        best_mask = (g_score > NEG_INF / 2) & (g_score == best[:, None])
        n_best = jnp.sum(best_mask, axis=1)

        rows = jnp.arange(Bl)
        uniq_row = has_hit & (n_best == 1)
        col = jnp.argmax(best_mask, axis=1)
        spu = jnp.where(uniq_row, g_sp[rows, col], n_species)
        d_count = jnp.zeros(n_species + 1, jnp.int32).at[spu].add(
            jnp.where(uniq_row, 1, 0))
        d_bp = jnp.zeros(n_species + 1, jnp.int32).at[spu].add(
            jnp.where(uniq_row, g_aln[rows, col], 0))
        d_count = jax.lax.psum(d_count, "dp")
        d_bp = jax.lax.psum(d_bp, "dp")

        amb_row = has_hit & (n_best >= 2)
        amb_sp_rows = jnp.where(best_mask, g_sp, -1)
        amb_bp_rows = jnp.where(best_mask, g_aln, 0)
        amb_seq_rows = jnp.where(best_mask, g_seq, 0)
        total = jax.lax.psum(
            jnp.sum((out["valid"] & real[:, None]).astype(jnp.int32)),
            ("dp", "tp"))
        return d_count, d_bp, amb_sp_rows, amb_bp_rows, amb_seq_rows, amb_row, total

    # check_vma=False: as in dist/sharded.py, the DP scan carry trips
    # the static device-variance check; outputs are psum/gather-merged.
    shard_fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp"), P(),
                  dict(bucket1=P("tp", None, None),
                       bucket2=P("tp", None, None),
                       positions2d=P("tp", None, None)),
                  dict(words=P("tp", None), nmask=P("tp", None),
                       offsets=P("tp", None)),
                  P("tp"), P(), P()),
        out_specs=(P(), P(), P("dp", None), P("dp", None), P("dp", None),
                   P("dp"), P()),
        check_vma=False,
    )
    d_count, d_bp, amb_sp_rows, amb_bp_rows, amb_seq_rows, amb_row, total = \
        shard_fn(codes, qlens, n_reads, shard_index_arrays, shard_pack_arrays,
                 seq_base, seq_species, seq_cutoff)

    B = codes.shape[0]
    amb_ord_rows = ord_base + jnp.arange(B, dtype=jnp.int32)
    amb_sp, _ = ds._append_rows(state.amb_sp, state.amb_n, amb_sp_rows, amb_row)
    amb_bp, _ = ds._append_rows(state.amb_bp, state.amb_n, amb_bp_rows, amb_row)
    amb_seq, _ = ds._append_rows(state.amb_seq, state.amb_n, amb_seq_rows,
                                 amb_row)
    amb_ord, amb_n = ds._append_rows(state.amb_ord, state.amb_n, amb_ord_rows,
                                     amb_row)
    return ds.SpeciesState(
        uniq_count=state.uniq_count + d_count,
        uniq_bp=state.uniq_bp + d_bp,
        amb_sp=amb_sp, amb_bp=amb_bp, amb_seq=amb_seq, amb_ord=amb_ord,
        amb_n=amb_n,
        total_alns=state.total_alns + total,
    )


class DistributedSpeciesProfiler(SpeciesProfiler):
    """SpeciesProfiler whose device classifier runs over a dp x tp mesh.

    Same public surface (run() -> abundance dict); only the per-batch
    update is distributed. On a multi-host pod, construct after
    jax.distributed.initialize (dist/driver.py) — the mesh then spans
    every chip in the slice and batches shard over "dp" automatically.
    """

    def __init__(self, db, mesh: Optional[Mesh] = None, tp: int = 1, **kw):
        super().__init__(db, **kw)
        self.mesh = mesh if mesh is not None else make_mesh(tp=tp)
        self.tp = int(self.mesh.shape["tp"])
        self.dp = int(self.mesh.shape["dp"])
        idx, packa, seq_base = shard_pack_arrays(
            self.pack, tp=self.tp, k=self.aligner.seed_params.k)
        self.shard_index_arrays = {k: jnp.asarray(v) for k, v in idx.items()}
        self.shard_pack_arrays = {k: jnp.asarray(v) for k, v in packa.items()}
        self.shard_seq_base = jnp.asarray(seq_base)

    def _run_device(self, read_paths, read_length, max_reads, batch_size,
                    amb_cap: Optional[int] = None, checkpoint_path=None,
                    checkpoint_every: int = 64):
        import os

        from midas_tpu.io.batch import load_read_batches
        from midas_tpu.io.prefetch import prefetch_device_batches

        import dataclasses as _dc

        n_species = len(self.species_order)
        cap = amb_cap or int(os.environ.get("MIDAS_TPU_AMB_CAP", "262144"))
        al = self.aligner
        if batch_size % self.dp:
            batch_size += self.dp - batch_size % self.dp
        cap = max(cap, 2 * batch_size)
        # amb rows hold the gathered [tp * C] candidate table
        state = ds.species_init(n_species, self.tp * al.seed_params.num_cands,
                                cap)
        seq_species = jnp.asarray(self.seq_species)
        seq_cutoff = jnp.asarray(self.seq_cutoff)
        total_reads = total_bp = 0
        drained = []   # host spill rows in stream order (see the
        #                single-chip twin in profile/species.py)

        def drain(state):
            spill, n = ds.sliced_spill_host(
                dict(amb_sp=state.amb_sp, amb_bp=state.amb_bp,
                     amb_seq=state.amb_seq, amb_ord=state.amb_ord),
                state.amb_n, cap)
            if n > cap:
                raise RuntimeError(
                    f"ambiguous spill staging overflow ({n} > {cap})")
            if n:
                drained.append(spill)
            return _dc.replace(state, amb_n=jnp.zeros((), jnp.int32))

        skip = 0
        fp = None
        if checkpoint_path:
            from midas_tpu.profile import checkpoint as ckpt

            import jax as _jax

            fp = ckpt.fingerprint(
                kind="species-dist", schema=3,  # 3: + amb_ord stream rank
                paths=list(map(str, np.atleast_1d(read_paths))),
                read_length=read_length, max_reads=max_reads,
                batch_size=batch_size, aln_cov=self.aln_cov,
                cutoffs=sorted(self.cutoffs.items()),
                num_cands=al.seed_params.num_cands, cap=cap,
                tp=self.tp, dp=self.dp,
                process=_jax.process_index())
            got = ckpt.load(checkpoint_path, fp)
            if got is not None:
                arrays, meta = got
                st0 = ds.species_init(
                    n_species, self.tp * al.seed_params.num_cands, cap)
                state = _dc.replace(
                    st0,
                    uniq_count=jnp.asarray(arrays["uniq_count"]),
                    uniq_bp=jnp.asarray(arrays["uniq_bp"], jnp.int32),
                    total_alns=jnp.asarray(np.int32(arrays["total_alns"])))
                if arrays["amb_sp"].shape[0]:
                    drained.append({k: arrays[k] for k in
                                    ("amb_sp", "amb_bp", "amb_seq",
                                     "amb_ord")})
                skip = int(meta["batches_done"])
                total_reads = int(meta["total_reads"])
                total_bp = int(meta["total_bp"])

        def full_rows():
            keys = ("amb_sp", "amb_bp", "amb_seq", "amb_ord")
            if not drained:
                return {k: (np.zeros(0, np.int32) if k == "amb_ord" else
                            np.zeros((0, self.tp * al.seed_params.num_cands),
                                     np.int32)) for k in keys}
            return {k: np.concatenate([d[k] for d in drained]) for k in keys}

        batches = load_read_batches(
            read_paths, batch_size=batch_size, max_len=al.max_read_len,
            read_length=read_length, max_reads=max_reads,
        )
        if getattr(self, "_batch_filter", None):
            batches = self._batch_filter(batches)  # multi-host striding
        rows_bound = 0
        last_index = skip - 1
        for db in prefetch_device_batches(batches, ("codes", "lengths"),
                                          skip_batches=skip):
            last_index = db.index
            total_reads += db.n_reads
            total_bp += db.total_bp
            codes, lengths, n_reads = db.arrays
            state = dist_species_update(
                self.mesh, state,
                self.shard_index_arrays, self.shard_pack_arrays,
                self.shard_seq_base, seq_species, seq_cutoff,
                codes, lengths, n_reads,
                np.int32(db.global_index * batch_size),
                scoring=al.scoring, seed_params=al.seed_params,
                max_len=al.max_read_len, aln_cov=float(self.aln_cov),
                n_species=n_species, dblen=float(self.pack.total_len))
            rows_bound += db.n_reads
            if rows_bound > cap - batch_size:
                state = drain(state)
                rows_bound = 0
            if checkpoint_path and (db.index + 1) % checkpoint_every == 0:
                from midas_tpu.profile import checkpoint as ckpt

                state = drain(state)
                rows_bound = 0
                h = ds.species_state_host(state)
                rows = full_rows()
                h.update(rows)
                h["amb_n"] = np.int64(rows["amb_sp"].shape[0])
                ckpt.save(checkpoint_path, h, dict(
                    fingerprint=fp, batches_done=db.index + 1,
                    total_reads=total_reads, total_bp=total_bp))
        state = drain(state)
        host = ds.species_state_host(state)
        host.update(full_rows())
        amb_n = host["amb_sp"].shape[0]
        if checkpoint_path:
            from midas_tpu.profile import checkpoint as ckpt

            host["amb_n"] = np.int64(amb_n)
            ckpt.save(checkpoint_path, host, dict(
                fingerprint=fp, batches_done=last_index + 1,
                total_reads=total_reads, total_bp=total_bp))
        unique_count = host["uniq_count"][:n_species].astype(np.int64)
        unique_bp = host["uniq_bp"][:n_species].astype(np.float64)
        ambiguous = []
        amb_sp = host["amb_sp"]
        amb_bp = host["amb_bp"]
        amb_seq = host["amb_seq"]
        amb_ord = host["amb_ord"]
        for r in range(amb_n):
            cols = np.flatnonzero(amb_sp[r] >= 0)
            ambiguous.append((amb_seq[r, cols], amb_sp[r, cols],
                              amb_bp[r, cols].astype(np.float64),
                              int(amb_ord[r])))
        self.stats = dict(total_reads=total_reads, total_bp=total_bp,
                          total_alns=int(host["total_alns"]))
        return unique_count, unique_bp, ambiguous
