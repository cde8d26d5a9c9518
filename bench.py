#!/usr/bin/env python
"""Benchmark: the device-resident profiling pipelines, end to end.

Times exactly what a user runs — `SpeciesProfiler.run` /
`GenesProfiler.run` / `SnpsProfiler.run`, i.e. native FASTQ parsing +
H2D + the fused seed/extend/classify jit with donated accumulators +
the single end-of-stream readback — against the reference's published
single-thread numbers (species ~5,000 reads/s, docs/species.md:68;
pangenome and SNP mapping ~16,000 reads/s, docs/cnvs.md:103 and
docs/snvs.md:110). Also reports the device pileup rate in base
observations scattered per second (snps_update steady state).

Needs a GPU (exits non-zero without one); prints the card's name and
power limit, then ONE JSON line: {"metric", "value", "unit",
"vs_baseline", ...} with the device in its detail.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

REF_SPECIES_READS_PER_SEC = 5000.0   # docs/species.md:68
REF_GENES_READS_PER_SEC = 16000.0    # docs/cnvs.md:103
REF_SNPS_READS_PER_SEC = 16000.0     # docs/snvs.md:110

N_READS = 65536
BATCH = 8192


def main():
    import jax
    import jax.numpy as jnp

    from midas_tpu.runtime import card_info, require_gpu, setup_compile_cache

    # persistent compile cache: without it the 2nd timed run pays a
    # fresh compile for the spill-slice readback bucket shapes
    setup_compile_cache()
    dev = require_gpu()
    card = card_info()
    print(f"card: {card}", flush=True)

    from midas_tpu.db import Database
    from midas_tpu.io.batch import load_read_batches
    from midas_tpu.profile.genes import GenesProfiler
    from midas_tpu.profile.snps import SnpsProfiler
    from midas_tpu.profile.species import SpeciesProfiler
    from midas_tpu.testkit import simulate_db, simulate_reads

    tmp = tempfile.mkdtemp(prefix="midas_bench_")
    comm = simulate_db(os.path.join(tmp, "db"), n_species=12,
                       genome_len=40000, gene_len=900, n_extra_genes=10,
                       related_pairs=3, divergence=0.03, seed=0)
    db = Database(comm.db_dir)
    fq = os.path.join(tmp, "reads.fq.gz")
    simulate_reads(comm, fq, n_reads=N_READS, read_len=100,
                   error_rate=0.005, seed=7)
    results = {}

    def best_of(fn, reps=3):
        # best of a few runs: the host-side share of a run varies
        best = float("inf")
        for _ in range(reps):
            t0 = time.time()
            fn()
            best = min(best, time.time() - t0)
        return best

    # --- species profiling (marker-gene mapping), end to end ------------
    prof = SpeciesProfiler(db)
    prof.run([fq], max_reads=BATCH, batch_size=BATCH)   # compile + warm
    dt = best_of(lambda: prof.run([fq], batch_size=BATCH))
    results["marker_reads_per_sec"] = N_READS / dt

    # --- pangenome CNV mapping, end to end -------------------------------
    # reference baseline condition: a single selected species
    # (docs/cnvs.md:103, docs/snvs.md:110 both quote "single species")
    one_species = comm.species_ids()[:1]
    gprof = GenesProfiler(db, one_species)
    gprof.run([fq], max_reads=BATCH, batch_size=BATCH)
    dt = best_of(lambda: gprof.run([fq], batch_size=BATCH))
    results["pangenome_reads_per_sec"] = N_READS / dt

    # --- SNP pileup, end to end -------------------------------------------
    sprof = SnpsProfiler(db, one_species)
    sprof.run([fq], max_reads=BATCH, batch_size=BATCH)
    dt = best_of(lambda: sprof.run([fq], batch_size=BATCH))
    results["snps_reads_per_sec"] = N_READS / dt

    # --- device-only rates: update steps over preloaded batches ----------
    # The e2e numbers above include parsing + H2D + readback; these time
    # ONLY the donated-state device chain (seed -> gather -> banded DP ->
    # classify/scatter). IMPORTANT: with donated accumulators,
    # block_until_ready can return before execution finishes (aliased
    # buffers look "ready"), so each timing region ends with a
    # device_get of a scalar leaf.
    from midas_tpu.align.params import GLOBAL_SCORING
    from midas_tpu.profile import device_steps as ds

    batches = list(load_read_batches(fq, batch_size=BATCH,
                                     max_len=sprof.aligner.max_read_len,
                                     max_reads=4 * BATCH))
    dev = [(jnp.asarray(b.codes), jnp.asarray(b.quals),
            jnp.asarray(b.lengths), jnp.asarray(b.mean_qual),
            jnp.int32(b.n_reads)) for b in batches]

    # species device rate
    sal = prof.aligner
    n_species = len(prof.species_order)
    seq_species = jnp.asarray(prof.seq_species)
    seq_cutoff = jnp.asarray(prof.seq_cutoff)

    def sp_step(state, d):
        codes, _q, lengths, _mq, n = d
        return ds.species_update(
            state, sal.index_arrays, sal.pack_arrays, seq_species,
            seq_cutoff, codes, lengths, n, jnp.int32(0),
            scoring=sal.scoring,
            seed_params=sal.seed_params, max_len=sal.max_read_len,
            aln_cov=0.75, n_species=n_species)

    sstate = sp_step(ds.species_init(n_species, sal.seed_params.num_cands,
                                     65536), dev[0])
    int(jax.device_get(sstate.amb_n))
    t0 = time.time()
    reps, n_dev_reads = 4, 0
    for _ in range(reps):
        for b, d in zip(batches, dev):
            sstate = sp_step(sstate, d)
            n_dev_reads += b.n_reads
    int(jax.device_get(sstate.amb_n))
    results["marker_device_reads_per_sec"] = n_dev_reads / (time.time() - t0)

    # SNP pileup device rate (base observations scattered per second:
    # every base of every read is one potential pileup site update)
    al = sprof.aligner
    contig_species = jnp.asarray(sprof.contig_species)
    state = ds.snps_init(sprof.pack.total_len, len(sprof.species_ids),
                         1024, al.max_read_len)

    def step(state, d):
        return ds.snps_update(
            state, al.index_arrays, al.pack_arrays, contig_species,
            *d, scoring=GLOBAL_SCORING, seed_params=al.seed_params,
            max_len=al.max_read_len, mapid=94.0, readq=20.0,
            min_mapq=20, baseq=30, aln_cov=0.75)

    state = step(state, dev[0])
    int(jax.device_get(state.gap_n))
    t0 = time.time()
    sites = snp_dev_reads = 0
    for _ in range(reps):
        for b, d in zip(batches, dev):
            state = step(state, d)
            sites += int(b.lengths[: b.n_reads].sum())
            snp_dev_reads += b.n_reads
    int(jax.device_get(state.gap_n))
    dt = time.time() - t0
    results["pileup_sites_per_sec"] = sites / dt
    results["snps_device_reads_per_sec"] = snp_dev_reads / dt

    # --- Mb-scale reality check (bench_scale.run_scale, trimmed) ---------
    # The toy community above has 40 kb genomes; the number that matters
    # for the SNP pipeline is the Mb-scale one (the [4 x G] readback is
    # the historical bottleneck), so the driver-recorded bench carries a
    # 500-species / 100 kb-genome / 20-selected config too.
    scale = {}
    try:
        from bench_scale import run_scale

        s = run_scale(n_species=500, genome_len=100000, n_sel=20,
                      n_reads=32768, batch=BATCH, audit=False)
        for k in ("marker_reads_per_sec", "pangenome_reads_per_sec",
                  "snps_reads_per_sec", "rep_pack_mb", "n_reads"):
            scale[f"scale_{k}"] = s[k]
        scale["scale_snps_vs_baseline"] = round(
            s["snps_reads_per_sec"] / REF_SNPS_READS_PER_SEC, 2)
    except Exception as e:  # noqa: BLE001 - bench must still report
        scale["scale_error"] = repr(e)[:200]

    value = results["marker_reads_per_sec"]
    print(json.dumps({
        "metric": "marker-gene aligned reads/sec/GPU (end-to-end)",
        "value": round(value, 1),
        "unit": "reads/s",
        "vs_baseline": round(value / REF_SPECIES_READS_PER_SEC, 2),
        "detail": {
            "pangenome_reads_per_sec": round(results["pangenome_reads_per_sec"], 1),
            "pangenome_vs_baseline": round(
                results["pangenome_reads_per_sec"] / REF_GENES_READS_PER_SEC, 2),
            "snps_reads_per_sec": round(results["snps_reads_per_sec"], 1),
            "snps_vs_baseline": round(
                results["snps_reads_per_sec"] / REF_SNPS_READS_PER_SEC, 2),
            "pileup_sites_per_sec": round(results["pileup_sites_per_sec"], 1),
            "marker_device_reads_per_sec": round(
                results["marker_device_reads_per_sec"], 1),
            "snps_device_reads_per_sec": round(
                results["snps_device_reads_per_sec"], 1),
            "n_reads": N_READS,
            **scale,
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": card,
        },
    }))


if __name__ == "__main__":
    sys.exit(main())
