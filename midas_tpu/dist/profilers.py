"""Distributed CNV (genes) and SNP-pileup profiling over a dp x tp
jax.sharding.Mesh — the device replacement for the reference's fork pools
and per-species pileup workers (midas/utility.py:81-107,
midas/run/snps.py:219-244) and the index sharding the reference never
needed because per-sample indexes fit host RAM (a 5,952-species
pangenome DB does not fit one chip's HBM).

Axes, as in dist/species.py:
- "dp": read batches shard across chips; per-gene / per-site count
  deltas merge with psum over "dp".
- "tp": the pangenome / rep-genome pack + bucketed seed index shard
  across chips by target sequence. Each rank finds its top-C candidates
  against its slice; one all_gather over "tp" rebuilds the full
  per-read candidate table ([B/dp, tp*C]) so best-hit choice, MAPQ, and
  the four keep_read filters see every shard's hits (reference filter
  semantics: genes.py:153-169, snps.py:141-162).

The SNP pileup count tensor is the one genuinely large accumulator
([4 x genome] — GBs for many species), so it stays SHARDED over "tp":
each rank owns the count stripe of its pack slice and scatters only
reads whose chosen best hit lands in that slice (the gathered table is
rank-major, so owner = best_col // C). This is the device analogue of
the reference's per-species forked pileups + line-range shards
(midas/merge/snps.py:366-386) with psum instead of temp files.

With tp=1 the gathered table equals the single-chip candidate table;
with tp>1 it is a per-shard-drawn superset — in both cases the
canonical multimapper tie-break (score, then global
seq_idx/tstart/strand — device_steps.canonical_best_col) resolves
equal-score hits identically, so results are BIT-EQUAL to the
single-device profilers at any dp x tp (tested at tp=2 and tp=4).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from midas_tpu.align.params import ScoringParams
from midas_tpu.align.pipeline import (align_candidates_score,
                                      align_chosen_full)
from midas_tpu.align.seed import SeedParams, revcomp_batch, reverse_batch
from midas_tpu.dist.sharded import make_mesh
from midas_tpu.dist.species import shard_pack_arrays
from midas_tpu.profile import device_steps as ds
from midas_tpu.profile.genes import GenesProfiler
from midas_tpu.profile.snps import SnpsProfiler

NEG_INF = ds.NEG_INF

# pass-1 planes: all that best-hit choice, pairing, MAPQ, and the
# duplicate drop need. The full six-stat DP runs only over each read's
# CHOSEN candidate on its owner rank (two-pass alignment, the same
# optimization the single-chip genes_update/snps_update use —
# align/pipeline.align_candidates_score + align_chosen_full).
_GATHER_KEYS = ("valid", "score", "seq_idx", "strand", "tstart", "tend",
                "qend")


def _local_and_gathered(idx_a, pack_a, sb, codes, qlens, scoring,
                        seed_params, max_len, quals=None):
    """Score-only pass over the tp-local slice, then all_gather the
    per-read candidate planes over "tp" (rank-major column order) with
    seq_idx lifted to global ids. Returns (out1, aux, gat): local
    pass-1 planes, pass-2 re-alignment context, gathered table."""
    idx_a = {k: v[0] for k, v in idx_a.items()}
    pack_a = {k: v[0] for k, v in pack_a.items()}
    sb = sb[0]
    out1, aux = align_candidates_score(idx_a, pack_a, codes, qlens,
                                       scoring, seed_params, max_len,
                                       quals=quals)
    gat = {}
    for k in _GATHER_KEYS:
        v = sb + out1[k] if k == "seq_idx" else out1[k]
        gat[k] = jax.lax.all_gather(v, "tp", axis=1, tiled=True)
    return out1, aux, gat


def _owner_full_stats(pack_a, aux, codes, qlens, best_col, scoring,
                      seed_params, num_cands):
    """Pass 2 on the owner rank: gathered columns are rank-major, so
    owner = best_col // C and the local column is best_col % C. Every
    rank runs the [B]-row full-stat DP (SPMD), but only the owner's
    stats are real — callers mask with `own`."""
    tp_rank = jax.lax.axis_index("tp")
    owner = best_col // num_cands
    lc = jnp.where(owner == tp_rank, best_col % num_cands, 0)
    full = align_chosen_full({k: v[0] for k, v in pack_a.items()},
                             aux, codes, qlens, lc, scoring, seed_params)
    return owner == tp_rank, lc, full


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "num_genes", "scoring", "seed_params", "max_len",
                     "mapid", "readq", "min_mapq", "aln_cov", "paired",
                     "maxins"),
    donate_argnames=("state",),
)
def dist_genes_update(
    mesh: Mesh,
    state: ds.GenesState,
    shard_index_arrays: Dict[str, jnp.ndarray],
    shard_pack_arrays_: Dict[str, jnp.ndarray],
    seq_base: jnp.ndarray,
    num_genes: int,
    codes: jnp.ndarray,
    quals: jnp.ndarray,
    qlens: jnp.ndarray,
    mean_qual: jnp.ndarray,
    n_reads: jnp.ndarray,
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    mapid: float,
    readq: float,
    min_mapq: int,
    aln_cov: float,
    paired: bool = False,
    maxins: int = 500,
) -> ds.GenesState:
    """One distributed CNV batch; replicated [G+1] accumulators updated
    with psum-merged deltas (genes.py:153-203 semantics). Two-pass
    alignment as in the single-chip genes_update: score-only DP over
    every candidate on each tp rank, full-stat DP only over each read's
    chosen candidate on its OWNER rank — per-read deltas are owner-only
    and psum over both axes, so every read is counted exactly once."""
    G = num_genes
    C = seed_params.num_cands

    def local(codes, quals, qlens, mean_qual, n_reads, idx_a, pack_a, sb):
        Bl = codes.shape[0]
        _out1, aux, g = _local_and_gathered(idx_a, pack_a, sb, codes, qlens,
                                            scoring, seed_params, max_len,
                                            quals=quals)
        dp_rank = jax.lax.axis_index("dp")
        real = dp_rank * Bl + jnp.arange(Bl) < n_reads
        if paired:
            aligned, best_col, mapq = ds.paired_best_hit_device(
                g, qlens, scoring, maxins=maxins)
        else:
            aligned, best_col, mapq = ds.best_hit_device(g, qlens, scoring)
        own, _lc, full = _owner_full_stats(pack_a, aux, codes, qlens,
                                           best_col, scoring, seed_params, C)
        aligned = aligned & real & own
        gi = ds._pick(g["seq_idx"], best_col)
        ga = jnp.where(aligned, gi, G)
        d_aligned = jnp.zeros(G + 1, jnp.int32).at[ga].add(
            jnp.where(aligned, 1, 0))
        keep = aligned & ds.keep_mask_chosen(full, qlens, mean_qual, mapq,
                                             mapid, readq, min_mapq, aln_cov)
        gk = jnp.where(keep, gi, G)
        d_mapped = jnp.zeros(G + 1, jnp.int32).at[gk].add(
            jnp.where(keep, 1, 0))
        alen = full["qend"] - full["qstart"]
        d_bp = jnp.zeros(G + 1, jnp.int32).at[gk].add(
            jnp.where(keep, alen, 0))
        return (jax.lax.psum(d_aligned, ("dp", "tp")),
                jax.lax.psum(d_mapped, ("dp", "tp")),
                jax.lax.psum(d_bp, ("dp", "tp")))

    shard_fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("dp", None), P("dp", None), P("dp"), P("dp"), P(),
                  dict(bucket1=P("tp", None, None),
                       bucket2=P("tp", None, None),
                       positions2d=P("tp", None, None)),
                  dict(words=P("tp", None), nmask=P("tp", None),
                       offsets=P("tp", None)),
                  P("tp")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    d_aligned, d_mapped, d_bp = shard_fn(
        codes, quals, qlens, mean_qual, n_reads,
        shard_index_arrays, shard_pack_arrays_, seq_base)
    return ds.GenesState(
        aligned_reads=state.aligned_reads + d_aligned,
        mapped_reads=state.mapped_reads + d_mapped,
        bp=state.bp + d_bp,
    )


class DistributedGenesProfiler(GenesProfiler):
    """GenesProfiler over a dp x tp mesh; same run()/write_results()
    surface, only the per-batch update is distributed."""

    def __init__(self, db, species_ids, mesh: Optional[Mesh] = None,
                 tp: int = 1, **kw):
        super().__init__(db, species_ids, **kw)
        self.mesh = mesh if mesh is not None else make_mesh(tp=tp)
        self.tp = int(self.mesh.shape["tp"])
        self.dp = int(self.mesh.shape["dp"])
        idx, packa, seq_base = shard_pack_arrays(
            self.pack, tp=self.tp, k=self.aligner.seed_params.k)
        self.shard_index_arrays = {k: jnp.asarray(v) for k, v in idx.items()}
        self.shard_pack = {k: jnp.asarray(v) for k, v in packa.items()}
        self.shard_seq_base = jnp.asarray(seq_base)

    def _accumulate(self, read_paths, max_reads, trim, batch_size,
                    checkpoint_path=None, checkpoint_every: int = 64,
                    paired: bool = False, interleaved: bool = False,
                    read_length=None):
        from midas_tpu.io.prefetch import prefetch_device_batches
        from midas_tpu.profile import checkpoint as ckpt
        from midas_tpu.profile.common import select_batches

        G = self.pack.num_seqs
        al = self.aligner
        state = ds.genes_init(G)
        # paired mode needs mates (rows 2i/2i+1) inside one dp shard
        # with an even per-shard row count: round to a multiple of 2*dp
        # (a plain dp multiple can leave B/dp odd and crash the pair
        # reshape in paired_best_hit_device)
        mult = 2 * self.dp if paired else self.dp
        if batch_size % mult:
            batch_size += mult - batch_size % mult
        skip = 0
        fp = None
        if checkpoint_path:
            fp = self._fingerprint(read_paths, max_reads, trim, batch_size,
                                   paired=paired, interleaved=interleaved,
                                   read_length=read_length)
            got = ckpt.load(checkpoint_path, fp)
            if got is not None:
                arrays, meta = got
                state = ds.genes_state_restore(arrays)
                skip = int(meta["batches_done"])
        last_index = skip - 1
        batches = select_batches(read_paths, batch_size, al.max_read_len,
                                 max_reads, paired, interleaved,
                                 read_length=read_length)
        if getattr(self, "_batch_filter", None):
            batches = self._batch_filter(batches)  # multi-host striding
        for db in prefetch_device_batches(
                batches, ("codes", "quals", "lengths", "mean_qual"),
                trim=trim, skip_batches=skip):
            last_index = db.index
            codes, quals, lengths, mean_qual, n_reads = db.arrays
            state = dist_genes_update(
                self.mesh, state, self.shard_index_arrays, self.shard_pack,
                self.shard_seq_base, G, codes, quals, lengths, mean_qual,
                n_reads,
                scoring=al.scoring, seed_params=al.seed_params,
                max_len=al.max_read_len, mapid=float(self.mapid),
                readq=float(self.readq), min_mapq=int(self.mapq),
                aln_cov=float(self.aln_cov), paired=bool(paired))
            if checkpoint_path and (db.index + 1) % checkpoint_every == 0:
                ckpt.save(checkpoint_path, ds.genes_state_host(state),
                          dict(fingerprint=fp, batches_done=db.index + 1,
                               guard=self._guard()))
        host = ds.genes_state_host(state)
        if checkpoint_path:
            ckpt.save(checkpoint_path, host,
                      dict(fingerprint=fp, batches_done=last_index + 1,
                           guard=self._guard()))
        return host


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "scoring", "seed_params", "max_len", "mapid",
                     "readq", "min_mapq", "baseq", "aln_cov", "stripe_len",
                     "paired", "maxins"),
    donate_argnames=("counts", "state"),
)
def dist_snps_update(
    mesh: Mesh,
    counts: jnp.ndarray,            # [tp, 4*(stripe_len+1)] sharded over tp
    state: ds.SnpsState,            # replicated (counts field unused: [1])
    shard_index_arrays: Dict[str, jnp.ndarray],
    shard_pack_arrays_: Dict[str, jnp.ndarray],
    seq_base: jnp.ndarray,
    contig_species: jnp.ndarray,    # [num_seqs] global, replicated
    codes: jnp.ndarray,
    quals: jnp.ndarray,
    qlens: jnp.ndarray,
    mean_qual: jnp.ndarray,
    n_reads: jnp.ndarray,
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    mapid: float,
    readq: float,
    min_mapq: int,
    baseq: int,
    aln_cov: float,
    stripe_len: int,
    paired: bool = False,
    maxins: int = 500,
) -> Tuple[jnp.ndarray, ds.SnpsState]:
    """One distributed pileup batch. The count tensor stays sharded over
    "tp" (each rank owns its pack slice's stripe); per-species read
    counters psum over "dp"; kept gapped reads return as replicated
    global-coordinate rows and append to the replicated spill buffer."""
    S = state.aligned_reads.shape[0] - 1
    C = seed_params.num_cands

    def local(counts, codes, quals, qlens, mean_qual, n_reads,
              idx_a, pack_a, sb, contig_species):
        Bl, L = codes.shape
        counts = counts[0]
        out1, aux, g = _local_and_gathered(idx_a, pack_a, sb, codes, qlens,
                                           scoring, seed_params, max_len,
                                           quals=quals)
        dp_rank = jax.lax.axis_index("dp")
        real = dp_rank * Bl + jnp.arange(Bl) < n_reads
        if paired:
            aligned, best_col, mapq = ds.paired_best_hit_device(
                g, qlens, scoring, maxins=maxins)
        else:
            aligned, best_col, mapq = ds.best_hit_device(g, qlens, scoring)
        # two-pass: full stats for the chosen candidate on its owner
        # rank only (align_chosen_full); every per-read quantity below
        # is owner-masked and merged with psum over ("dp", "tp")
        own, lc, full = _owner_full_stats(pack_a, aux, codes, qlens,
                                          best_col, scoring, seed_params, C)
        aligned = aligned & real & own
        gci = ds._pick(g["seq_idx"], best_col)
        sp = contig_species[gci]
        d_aligned = jnp.zeros(S + 1, jnp.int32).at[
            jnp.where(aligned, sp, S)].add(jnp.where(aligned, 1, 0))
        keep = aligned & ds.keep_mask_chosen(full, qlens, mean_qual, mapq,
                                             mapid, readq, min_mapq, aln_cov)
        d_mapped = jnp.zeros(S + 1, jnp.int32).at[
            jnp.where(keep, sp, S)].add(jnp.where(keep, 1, 0))

        # strand-adjusted query/qual planes (identical on all ranks)
        strand = ds._pick(g["strand"], best_col)
        rc_codes = revcomp_batch(codes, qlens)
        j = jnp.arange(L, dtype=jnp.int32)[None, :]
        rc_quals = reverse_batch(quals, qlens, fill=0)
        qsel = jnp.where(strand[:, None] == 1, rc_codes, codes)
        qqsel = jnp.where(strand[:, None] == 1, rc_quals,
                          quals).astype(jnp.int32)

        # the owner rank scatters its kept gapless reads into its stripe
        mine = keep                  # already owner-masked
        gapless = full["gap_cols"] == 0
        qs = full["qstart"]
        qe = full["qend"]
        ts = full["tstart"]
        lci = ds._pick(out1["seq_idx"], lc)         # local seq id
        seq_lo = pack_a["offsets"][0][lci].astype(jnp.int32)
        Gs = stripe_len
        scatter_row = mine & gapless
        in_aln = (j >= qs[:, None]) & (j < qe[:, None])
        tpos = seq_lo[:, None] + ts[:, None] + (j - qs[:, None])
        base = qsel.astype(jnp.int32)
        ok = (scatter_row[:, None] & in_aln & (qqsel >= baseq) & (base < 4)
              & (tpos >= 0) & (tpos < Gs))
        flat_idx = jnp.where(ok, jnp.clip(base, 0, 3) * (Gs + 1) + tpos, Gs)
        # the stripe is sharded over "tp" but REPLICATED over "dp": each
        # dp rank scatters different reads, so accumulate into a zero
        # delta and psum over "dp" before adding to the carried stripe
        delta = jnp.zeros_like(counts).at[flat_idx.reshape(-1)].add(1)
        counts = counts + jax.lax.psum(delta, "dp")

        # gapped spill in GLOBAL coordinates: owner-only stats (ts/te)
        # replicate over "tp" via a masked psum, then a non-tiled dp
        # gather rebuilds full-batch rows so the append outside the
        # shard_map sees stream order. Gapped kept reads are RARE
        # (typically zero per batch), so the [B, L] plane gathers —
        # per-batch DCN traffic at multi-host scale — are gated on a
        # one-scalar psum: no gapped read anywhere, no gather (the
        # predicate is replicated over "dp" AND "tp", so every rank
        # takes the same cond branch and the collective stays legal).
        is_gap_own = keep & ~gapless
        te = full["tend"]
        meta_own = jnp.where(is_gap_own[:, None],
                             jnp.stack([gci, ts, te, qlens], axis=1), 0)
        meta = jax.lax.psum(meta_own, "tp")
        is_gap = jax.lax.psum(is_gap_own.astype(jnp.int32), "tp") > 0
        n_gap_global = jax.lax.psum(jnp.sum(is_gap.astype(jnp.int32)),
                                    "dp")

        def do_gather():
            return (jax.lax.all_gather(qsel.astype(jnp.int8), "dp",
                                       axis=0, tiled=True),
                    jax.lax.all_gather(qqsel.astype(jnp.int8), "dp",
                                       axis=0, tiled=True),
                    jax.lax.all_gather(meta, "dp", axis=0, tiled=True),
                    jax.lax.all_gather(is_gap, "dp", axis=0, tiled=True))

        def no_gather():
            dp = mesh.shape["dp"]
            return (jnp.zeros((Bl * dp, L), jnp.int8),
                    jnp.zeros((Bl * dp, L), jnp.int8),
                    jnp.zeros((Bl * dp, 4), jnp.int32),
                    jnp.zeros((Bl * dp,), jnp.bool_))

        g_codes, g_quals, g_meta, g_isgap = jax.lax.cond(
            n_gap_global > 0, do_gather, no_gather)
        return (counts[None], jax.lax.psum(d_aligned, ("dp", "tp")),
                jax.lax.psum(d_mapped, ("dp", "tp")),
                g_codes, g_quals, g_meta, g_isgap)

    shard_fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("tp", None), P("dp", None), P("dp", None), P("dp"),
                  P("dp"), P(),
                  dict(bucket1=P("tp", None, None),
                       bucket2=P("tp", None, None),
                       positions2d=P("tp", None, None)),
                  dict(words=P("tp", None), nmask=P("tp", None),
                       offsets=P("tp", None)),
                  P("tp"), P()),
        out_specs=(P("tp", None), P(), P(), P(), P(), P(), P()),
        check_vma=False,
    )
    counts, d_aligned, d_mapped, g_codes, g_quals, g_meta, g_isgap = shard_fn(
        counts, codes, quals, qlens, mean_qual, n_reads,
        shard_index_arrays, shard_pack_arrays_, seq_base, contig_species)

    gap_codes, _ = ds._append_rows(state.gap_codes, state.gap_n,
                                   g_codes, g_isgap)
    gap_quals, _ = ds._append_rows(state.gap_quals, state.gap_n,
                                   g_quals, g_isgap)
    gap_meta, gap_n = ds._append_rows(state.gap_meta, state.gap_n,
                                      g_meta, g_isgap)
    new_state = ds.SnpsState(
        counts=state.counts,
        aligned_reads=state.aligned_reads + d_aligned,
        mapped_reads=state.mapped_reads + d_mapped,
        gap_codes=gap_codes, gap_quals=gap_quals, gap_meta=gap_meta,
        gap_n=gap_n)
    return counts, new_state


class DistributedSnpsProfiler(SnpsProfiler):
    """SnpsProfiler over a dp x tp mesh with the [4 x genome] pileup
    count tensor sharded over "tp" (each chip holds 1/tp of the genome
    stripe — the accumulator that cannot be replicated at DB scale)."""

    def __init__(self, db, species_ids, mesh: Optional[Mesh] = None,
                 tp: int = 1, **kw):
        super().__init__(db, species_ids, **kw)
        self.mesh = mesh if mesh is not None else make_mesh(tp=tp)
        self.tp = int(self.mesh.shape["tp"])
        self.dp = int(self.mesh.shape["dp"])
        from midas_tpu.dist.sharded import shard_index

        codes_, idx, offsets, shard_base, seq_base = shard_index(
            self.pack, tp=self.tp, k=self.aligner.seed_params.k)
        from midas_tpu.align.seed import pack_words_host

        words_l, nmask_l = [], []
        for r in range(self.tp):
            w, nm = pack_words_host(codes_[r])
            words_l.append(w)
            nmask_l.append(nm)
        self.shard_index_arrays = {k: jnp.asarray(v) for k, v in idx.items()}
        self.shard_pack = dict(words=jnp.asarray(np.stack(words_l)),
                               nmask=jnp.asarray(np.stack(nmask_l)),
                               offsets=jnp.asarray(offsets))
        self.shard_seq_base = jnp.asarray(seq_base.astype(np.int32))
        self.shard_base = shard_base.astype(np.int64)
        # per-rank real stripe lengths (offsets[-1] of each slice)
        self.stripe_real = np.asarray(offsets)[:, -1].astype(np.int64)
        self.stripe_len = int(self.stripe_real.max())

    def _reassemble_counts(self, stripes: np.ndarray) -> np.ndarray:
        """[tp, 4*(stripe_len+1)] rank stripes -> the single-chip flat
        [4 * (G_total + 1)] counts layout _finalize expects."""
        G = self.pack.total_len
        full = np.zeros((4, G + 1), dtype=np.int32)
        for r in range(self.tp):
            Lr = int(self.stripe_real[r])
            lo = int(self.shard_base[r])
            stripe = stripes[r].reshape(4, self.stripe_len + 1)
            full[:, lo: lo + Lr] += stripe[:, :Lr]
        return full.reshape(-1)

    def _shard_counts(self, flat: np.ndarray) -> np.ndarray:
        """Inverse of _reassemble_counts (checkpoint restore): slice the
        flat [4*(G+1)] counts back into per-rank stripes (the per-stripe
        dump column Gs resets to 0 — it only ever held discards)."""
        full = flat.reshape(4, self.pack.total_len + 1)
        stripes = np.zeros((self.tp, 4, self.stripe_len + 1), dtype=np.int32)
        for r in range(self.tp):
            Lr = int(self.stripe_real[r])
            lo = int(self.shard_base[r])
            stripes[r, :, :Lr] = full[:, lo: lo + Lr]
        return stripes.reshape(self.tp, -1)

    def _accumulate(self, read_paths, max_reads, trim, batch_size,
                    gap_cap=None, checkpoint_path=None,
                    checkpoint_every: int = 64, paired: bool = False,
                    interleaved: bool = False, read_length=None) -> Dict:
        import dataclasses as _dc
        import os

        from midas_tpu.io.prefetch import prefetch_device_batches
        from midas_tpu.profile import checkpoint as ckpt
        from midas_tpu.profile.common import select_batches

        S = len(self.species_ids)
        al = self.aligner
        L = al.max_read_len
        # staging capacity with host drains, as in the single-chip
        # SnpsProfiler — no hard gapped-read cap
        cap = gap_cap or int(os.environ.get("MIDAS_TPU_GAP_CAP", "131072"))
        cap = max(cap, 2 * batch_size)
        # replicated spill/counter state; the real counts live sharded
        state = ds.snps_init(0, S, cap, L)
        counts = jnp.zeros((self.tp, 4 * (self.stripe_len + 1)), jnp.int32)
        contig_species = jnp.asarray(self.contig_species)
        mult = 2 * self.dp if paired else self.dp   # see genes twin
        if batch_size % mult:
            batch_size += mult - batch_size % mult
        skip = 0
        fp = None
        drained = []

        def drain(state):
            spill, n = ds.sliced_spill_host(
                dict(gap_codes=state.gap_codes, gap_quals=state.gap_quals,
                     gap_meta=state.gap_meta), state.gap_n, cap)
            if n > cap:
                raise RuntimeError(
                    f"gapped spill staging overflow ({n} > {cap})")
            if n:
                drained.append(spill)
            return _dc.replace(state, gap_n=jnp.zeros((), jnp.int32))

        def gap_rows():
            if not drained:
                return dict(gap_codes=np.full((0, L), 4, np.int8),
                            gap_quals=np.zeros((0, L), np.int8),
                            gap_meta=np.zeros((0, 4), np.int32))
            return {k: np.concatenate([d[k] for d in drained])
                    for k in ("gap_codes", "gap_quals", "gap_meta")}

        if checkpoint_path:
            fp = ckpt.fingerprint(
                kind="snps", schema=2,  # 2: quality-scaled --mp/--np
                paths=list(map(str, np.atleast_1d(read_paths))),
                max_reads=max_reads, trim=trim, batch_size=batch_size,
                mapid=self.mapid, readq=self.readq, mapq=self.mapq,
                baseq=self.baseq, aln_cov=self.aln_cov, cap=cap,
                species=self.species_ids, paired=paired,
                interleaved=interleaved, read_length=read_length)
            got = ckpt.load(checkpoint_path, fp)
            if got is not None:
                arrays, meta = got
                # counters restore to device; gap rows stay host-side
                state = _dc.replace(
                    ds.snps_init(0, S, cap, L),
                    aligned_reads=jnp.asarray(arrays["aligned_reads"]),
                    mapped_reads=jnp.asarray(arrays["mapped_reads"]))
                if arrays["gap_codes"].shape[0]:
                    drained.append({k: arrays[k] for k in
                                    ("gap_codes", "gap_quals", "gap_meta")})
                counts = jnp.asarray(self._shard_counts(arrays["counts"]))
                skip = int(meta["batches_done"])

        def snapshot(state) -> Dict:
            from midas_tpu.profile.sparse_counts import counts_host_sparse

            h = ds.snps_state_host(state)
            rows = gap_rows()
            h.update(rows)
            h["gap_n"] = np.int64(rows["gap_codes"].shape[0])
            # per-rank sparse readback of each tp stripe (each rank row
            # is its own flat [4*(SL+1)] layout with the dump column at
            # local index SL — exactly the single-chip contract)
            h["counts"] = self._reassemble_counts(np.stack(
                [counts_host_sparse(counts[r], self.stripe_len)
                 for r in range(self.tp)]))
            return h

        last_index = skip - 1
        rows_bound = 0
        batches = select_batches(read_paths, batch_size, L, max_reads,
                                 paired, interleaved,
                                 read_length=read_length)
        if getattr(self, "_batch_filter", None):
            batches = self._batch_filter(batches)  # multi-host striding
        for db in prefetch_device_batches(
                batches, ("codes", "quals", "lengths", "mean_qual"),
                trim=trim, skip_batches=skip):
            last_index = db.index
            codes, quals, lengths, mean_qual, n_reads = db.arrays
            counts, state = dist_snps_update(
                self.mesh, counts, state, self.shard_index_arrays,
                self.shard_pack, self.shard_seq_base, contig_species,
                codes, quals, lengths, mean_qual, n_reads,
                scoring=al.scoring, seed_params=al.seed_params, max_len=L,
                mapid=float(self.mapid), readq=float(self.readq),
                min_mapq=int(self.mapq), baseq=int(self.baseq),
                aln_cov=float(self.aln_cov), stripe_len=self.stripe_len,
                paired=bool(paired))
            rows_bound += db.n_reads
            if rows_bound > cap - batch_size:
                state = drain(state)
                rows_bound = 0
            if checkpoint_path and (db.index + 1) % checkpoint_every == 0:
                state = drain(state)
                rows_bound = 0
                ckpt.save(checkpoint_path, snapshot(state),
                          dict(fingerprint=fp, batches_done=db.index + 1,
                               guard=self._guard()))
        state = drain(state)
        host = snapshot(state)
        if checkpoint_path:
            ckpt.save(checkpoint_path, host,
                      dict(fingerprint=fp, batches_done=last_index + 1,
                           guard=self._guard()))
        return host