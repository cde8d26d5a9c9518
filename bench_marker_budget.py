#!/usr/bin/env python
"""Device-step time budget for the marker (species) pipeline at the
bench_scale configuration: where does the batch time go (seed / window
gather / banded DP / classify+spill)?

Each stage is timed as a standalone jit over the same inputs; stage
deltas are computed by nesting (seed; seed+gather; seed+gather+DP; full
update) so XLA fusion boundaries stay realistic. Needs a GPU; prints
the card's name and power limit, then one JSON line. Run by hand."""

import json
import os
import sys
import tempfile
import time

import numpy as np

BATCH = 8192


def main():
    import jax
    import jax.numpy as jnp

    from midas_tpu.runtime import card_info, require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()
    card = card_info()
    print(f"card: {card}", flush=True)

    from midas_tpu.align.pipeline import (_prepare_pairs,
                                          dispatch_banded_align)
    from midas_tpu.align.seed import find_candidates, gather_windows_packed
    from midas_tpu.db import Database
    from midas_tpu.io.batch import load_read_batches
    from midas_tpu.profile import device_steps as ds
    from midas_tpu.profile.species import SpeciesProfiler
    from midas_tpu.testkit import simulate_db, simulate_reads

    n_species = int(os.environ.get("SCALE_SPECIES", "500"))
    n_sel = int(os.environ.get("SCALE_SELECTED", "20"))
    tmp = tempfile.mkdtemp(prefix="midas_budget_")
    comm = simulate_db(os.path.join(tmp, "db"), n_species=n_species,
                       genome_len=100000, gene_len=900, n_extra_genes=0,
                       related_pairs=n_species // 4, divergence=0.03, seed=0)
    db = Database(comm.db_dir)
    fq = os.path.join(tmp, "reads.fq.gz")
    abund = [1.0 / n_sel] * n_sel + [0.0] * (len(comm.species) - n_sel)
    simulate_reads(comm, fq, n_reads=4 * BATCH, read_len=100,
                   error_rate=0.005, indel_rate=0.01, seed=7,
                   abundances=abund)

    prof = SpeciesProfiler(db)
    al = prof.aligner
    sp = al.seed_params
    L = al.max_read_len
    C, D = sp.num_cands, sp.band_width
    W = L + D - 1
    batches = list(load_read_batches(fq, batch_size=BATCH, max_len=L))
    dev = [(jnp.asarray(b.codes), jnp.asarray(b.lengths),
            jnp.int32(b.n_reads)) for b in batches]
    seq_species = jnp.asarray(prof.seq_species)
    seq_cutoff = jnp.asarray(prof.seq_cutoff)
    n_sp_total = len(prof.species_order)

    # index/pack arrays must be jit ARGUMENTS, not closure constants —
    # captured constants would embed the 400 MB index into the HLO
    @jax.jit
    def stage_seed(idx, codes, qlens):
        c = find_candidates(idx, codes, qlens, sp=sp, max_len=L)
        return c["diag"].sum() + c["strand"].sum() + c["rc"].sum()

    @jax.jit
    def stage_seed_gather(idx, pack, codes, qlens):
        c = find_candidates(idx, codes, qlens, sp=sp, max_len=L)
        winstart = c["diag"] - D // 2
        win, seq_idx = gather_windows_packed(
            pack["words"], pack["nmask"], pack["offsets"], winstart,
            window_len=W)
        return win.astype(jnp.int32).sum() + seq_idx.sum() + c["rc"].sum()

    @jax.jit
    def stage_through_dp(idx, pack, codes, qlens):
        c = find_candidates(idx, codes, qlens, sp=sp, max_len=L)
        winstart = c["diag"] - D // 2
        win, seq_idx = gather_windows_packed(
            pack["words"], pack["nmask"], pack["offsets"], winstart,
            window_len=W)
        B = codes.shape[0]
        q_pair, qlens_pair, _ = _prepare_pairs(codes, qlens, c["strand"],
                                               num_cands=C, rc=c["rc"])
        out = dispatch_banded_align(q_pair, qlens_pair,
                                    win.reshape(B * C, W), al.scoring, D)
        return sum(v.astype(jnp.float32).sum() for v in out.values())

    def full_update(state, d):
        codes, qlens, n = d
        return ds.species_update(
            state, al.index_arrays, al.pack_arrays, seq_species, seq_cutoff,
            codes, qlens, n, jnp.int32(0), scoring=al.scoring,
            seed_params=sp, max_len=L, aln_cov=0.75, n_species=n_sp_total)

    def timed(fn, reps=3):
        # drain with a device_get of the scalar result, so the timing
        # region ends when the device work has
        best = float("inf")
        for _ in range(reps):
            t0 = time.time()
            for d in dev:
                r = fn(d)
            float(jax.device_get(jnp.sum(r)))
            best = min(best, (time.time() - t0) / len(dev))
        return best

    idx_a, pack_a = al.index_arrays, al.pack_arrays
    # warm every stage (device_get forces compile + first run)
    for d in dev:
        float(jax.device_get(jnp.sum(stage_seed(idx_a, d[0], d[1]))))
        float(jax.device_get(jnp.sum(
            stage_seed_gather(idx_a, pack_a, d[0], d[1]))))
        float(jax.device_get(jnp.sum(
            stage_through_dp(idx_a, pack_a, d[0], d[1]))))
    st = ds.species_init(n_sp_total, C, 65536)
    st = full_update(st, dev[0])
    int(jax.device_get(st.amb_n))

    t_seed = timed(lambda d: stage_seed(idx_a, d[0], d[1]))
    t_gather = timed(lambda d: stage_seed_gather(idx_a, pack_a, d[0], d[1]))
    t_dp = timed(lambda d: stage_through_dp(idx_a, pack_a, d[0], d[1]))

    state = ds.species_init(n_sp_total, C, 65536)
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        for d in dev:
            state = full_update(state, d)
        int(jax.device_get(state.amb_n))
        best = min(best, (time.time() - t0) / len(dev))
    t_full = best

    out = dict(
        n_species=n_species,
        batch=BATCH,
        seed_ms=round(1e3 * t_seed, 2),
        gather_ms=round(1e3 * (t_gather - t_seed), 2),
        dp_ms=round(1e3 * (t_dp - t_gather), 2),
        classify_ms=round(1e3 * (t_full - t_dp), 2),
        total_ms=round(1e3 * t_full, 2),
        device_reads_per_sec=round(BATCH / t_full, 1),
    )
    d0 = jax.devices()[0]
    out["platform"] = f"{d0.platform}:{d0.device_kind}"
    out["card"] = card
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
