#!/usr/bin/env python
"""Scale-realism benchmark: exercise the profilers at 1-2 orders above
the unit-test fixtures and audit every fixed cap against measured
behavior. The production contract is the reference DB's 5,952 species /
31,007 genomes / ~15 MB phyeco.fa (/root/reference/docs/ref_db.md:35);
this harness simulates the same *shape* at configurable scale:

- marker DB: n_species x 15 markers (~900 bp) — at 500 species the
  phyeco.fa is ~7 MB vs the real 15 MB (5,952 species share marker
  sequence at high identity; distinct-sequence count is what sizes the
  index, and 7,500 distinct genes is the right order).
- pangenome: per-run pack over the SELECTED species (the reference
  builds per-sample pangenome DBs the same way, genes.py:84-114);
  n_extra_genes scales the gene count into the 100k range.
- rep genomes: Mb-scale multi-contig genomes for the pileup tensor.

Measured per pipeline: e2e reads/s, device bytes of pack+index vs the
int32/2 GiB addressing asserts (db/index.py:163,189), marker tie-set
widths vs num_cands, and ambiguous/gapped spill rates vs the default
staging caps. Needs a GPU (exits non-zero without one); prints the
card's name and power limit, then one JSON line. Run manually.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

N_READS = 65536
BATCH = 8192


def nbytes(tree) -> int:
    total = 0
    for v in (tree.values() if isinstance(tree, dict) else tree):
        total += int(np.asarray(v).nbytes) if not isinstance(v, dict) \
            else nbytes(v)
    return total


def run_scale(n_species: int = 500, genome_len: int = 100000,
              n_sel: int = 20, extra: int = 0, n_reads: int = N_READS,
              batch: int = BATCH, audit: bool = True) -> dict:
    """One scale configuration end to end; returns the metrics dict.
    audit=False skips the tie-width / cap audit passes (used by
    bench.py to fold a trimmed scale line into the driver bench)."""
    import jax

    from midas_tpu.db import Database
    from midas_tpu.profile.genes import GenesProfiler
    from midas_tpu.profile.snps import SnpsProfiler
    from midas_tpu.profile.species import SpeciesProfiler
    from midas_tpu.testkit import simulate_db, simulate_reads

    tmp = tempfile.mkdtemp(prefix="midas_scale_")
    t0 = time.time()
    comm = simulate_db(os.path.join(tmp, "db"), n_species=n_species,
                       genome_len=genome_len, gene_len=900,
                       n_extra_genes=extra, related_pairs=n_species // 4,
                       divergence=0.03, seed=0)
    t_sim = time.time() - t0
    db = Database(comm.db_dir)
    fq = os.path.join(tmp, "reads.fq.gz")
    # reads drawn from the first n_sel species (the abundant community)
    abund = [1.0 / n_sel] * n_sel + [0.0] * (len(comm.species) - n_sel)
    simulate_reads(comm, fq, n_reads=n_reads, read_len=100,
                   error_rate=0.005, indel_rate=0.01, seed=7,
                   abundances=abund)
    out = dict(n_species=n_species, genome_len=genome_len,
               n_selected=n_sel, n_reads=n_reads, sim_secs=round(t_sim, 1))

    # --- species at full DB scale ---------------------------------------
    # warm runs cover the FULL stream: a short warm run picks different
    # spill-readback bucket shapes than the timed run, so the timed
    # region silently paid a fresh XLA compile (measured: 40k "reads/s"
    # one-shot vs 89k warmed at 500 species)
    prof = SpeciesProfiler(db)
    out["marker_pack_mb"] = round(prof.pack.total_len / 1e6, 1)
    out["marker_hbm_mb"] = round(
        (nbytes(prof.aligner.index_arrays)
         + nbytes(prof.aligner.pack_arrays)) / 2**20, 1)
    prof.run([fq], batch_size=batch)   # warm (full stream)
    t0 = time.time()
    prof.run([fq], batch_size=batch)
    out["marker_reads_per_sec"] = round(n_reads / (time.time() - t0), 1)
    if audit:
        # tie-width audit: how wide are ambiguous tie sets vs num_cands?
        uc, ub, amb = prof._run_device([fq], None, None, batch)
        C = prof.aligner.seed_params.num_cands
        widths = np.array([len(t[1]) for t in amb], dtype=np.int64)
        out["amb_rate"] = round(len(amb) / prof.stats["total_reads"], 4)
        out["amb_tie_width_p99"] = (int(np.percentile(widths, 99))
                                    if len(widths) else 0)
        out["amb_tie_width_max"] = int(widths.max()) if len(widths) else 0
        out["amb_tie_at_cap_frac"] = round(
            float((widths >= C).mean()), 4) if len(widths) else 0.0
        out["num_cands"] = C

    # --- genes over the selected community -------------------------------
    sel = comm.species_ids()[:n_sel]
    gprof = GenesProfiler(db, sel)
    out["pangenome_genes"] = int(gprof.pack.num_seqs)
    out["pangenome_pack_mb"] = round(gprof.pack.total_len / 1e6, 1)
    out["pangenome_hbm_mb"] = round(
        (nbytes(gprof.aligner.index_arrays)
         + nbytes(gprof.aligner.pack_arrays)) / 2**20, 1)
    gprof.run([fq], batch_size=batch)   # warm (full stream)
    t0 = time.time()
    gprof.run([fq], batch_size=batch)
    out["pangenome_reads_per_sec"] = round(n_reads / (time.time() - t0), 1)

    # --- snps over the selected community --------------------------------
    sprof = SnpsProfiler(db, sel)
    out["rep_pack_mb"] = round(sprof.pack.total_len / 1e6, 1)
    out["rep_hbm_mb"] = round(
        (nbytes(sprof.aligner.index_arrays)
         + nbytes(sprof.aligner.pack_arrays)
         + 4 * 4 * (sprof.pack.total_len + 1)) / 2**20, 1)  # + counts
    sprof.run([fq], batch_size=batch)   # warm (full stream)
    t0 = time.time()
    res = sprof.run([fq], batch_size=batch)
    out["snps_reads_per_sec"] = round(n_reads / (time.time() - t0), 1)
    out["gap_rate"] = round(res["n_gapped"] / n_reads, 5)
    if audit:
        out["gap_cap_default"] = int(os.environ.get("MIDAS_TPU_GAP_CAP",
                                                    "131072"))
        out["gap_reads_at_default_cap_capacity"] = int(
            out["gap_cap_default"] / max(out["gap_rate"], 1e-9))

    d = jax.devices()[0]
    out["platform"] = f"{d.platform}:{getattr(d, 'device_kind', '?')}"
    return out


def main():
    from midas_tpu.runtime import card_info, require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()
    card = card_info()
    print(f"card: {card}", flush=True)
    out = run_scale(
        n_species=int(os.environ.get("SCALE_SPECIES", "500")),
        genome_len=int(os.environ.get("SCALE_GENOME", "100000")),
        n_sel=int(os.environ.get("SCALE_SELECTED", "20")),
        extra=int(os.environ.get("SCALE_EXTRA_GENES", "0")),
        n_reads=int(os.environ.get("SCALE_READS", str(N_READS))),
    )
    out["card"] = card
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
