"""Device-resident profiling steps (profile/device_steps.py) must
produce the same accumulations as the host-side classifiers they
replaced (which mirror midas/run/species.py:64-119, genes.py:153-203,
snps.py:141-216)."""

import os

import numpy as np
import pytest

from midas_tpu.align.params import GLOBAL_SCORING, LOCAL_SCORING
from midas_tpu.db import Database
from midas_tpu.io.batch import load_read_batches
from midas_tpu.profile.common import keep_read_mask, pick_best_hits
from midas_tpu.profile.species import SpeciesProfiler


@pytest.fixture(scope="module")
def noisy_reads(sim_community, tmp_path_factory):
    from midas_tpu.testkit import simulate_reads

    fq = tmp_path_factory.mktemp("dsreads") / "r.fq.gz"
    simulate_reads(sim_community, str(fq), n_reads=600,
                   abundances=[0.4, 0.3, 0.2, 0.1], error_rate=0.02, seed=3)
    return str(fq)


def test_species_device_equals_host(sim_community, noisy_reads, tmp_path):
    db = Database(sim_community.db_dir)
    prof = SpeciesProfiler(db)
    m8 = str(tmp_path / "alignments.m8")
    host_abund = prof.run([noisy_reads], m8_path=m8)
    host_stats = dict(prof.stats)
    dev_abund = prof.run([noisy_reads], m8_path=None)
    assert prof.stats == host_stats
    assert dev_abund == host_abund


def test_species_uniq_bp_is_exact_int32():
    """uniq_bp accumulates in int32 (an exact sum in any scatter order,
    past float32's 2^24), and a snapshot written while it was float32
    restores to the same integers."""
    import jax.numpy as jnp

    from midas_tpu.profile import device_steps as ds

    st = ds.species_init(3, 4, 64)
    assert st.uniq_bp.dtype == jnp.int32
    big = 2**24 + 1                      # not representable in float32
    st = ds.SpeciesState(**{**vars(st),
                            "uniq_bp": st.uniq_bp.at[1].add(big).at[1].add(2)})
    h = ds.species_state_host(st)
    assert h["uniq_bp"][1] == big + 2
    old = dict(h, uniq_bp=np.array([0, 1500, 7, 0], np.float32))
    restored = ds.species_state_restore(old, 64)
    assert restored.uniq_bp.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(restored.uniq_bp),
                                  [0, 1500, 7, 0])


def test_genes_device_equals_host(sim_community, noisy_reads):
    from midas_tpu.profile.genes import GenesProfiler

    db = Database(sim_community.db_dir)
    prof = GenesProfiler(db, sim_community.species_ids())
    res = prof.run([noisy_reads])

    # independent host-side recount from full alignment readback
    G = prof.pack.num_seqs
    aligned = np.zeros(G, np.int64)
    mapped = np.zeros(G, np.int64)
    bp = np.zeros(G, np.int64)
    for batch in load_read_batches([noisy_reads], batch_size=8192,
                                   max_len=prof.aligner.max_read_len):
        r = prof.aligner.align_batch(batch)
        a, col, mq = pick_best_hits(r, LOCAL_SCORING, batch.lengths)
        a[r.n_reads:] = False
        rows = np.flatnonzero(a)
        np.add.at(aligned, r.seq_idx[rows, col[rows]], 1)
        keep = keep_read_mask(r, col, batch, mq, prof.mapid, prof.readq,
                              prof.mapq, prof.aln_cov)
        k = np.flatnonzero(a & keep)
        g = r.seq_idx[k, col[k]]
        np.add.at(mapped, g, 1)
        np.add.at(bp, g, (r.qend - r.qstart)[k, col[k]])
    assert np.array_equal(res["aligned_reads"], aligned)
    assert np.array_equal(res["mapped_reads"], mapped)
    depth = bp.astype(np.float64) / np.maximum(
        prof.pack.lengths.astype(np.float64), 1.0)
    np.testing.assert_allclose(res["depth"], depth, rtol=0, atol=0)


def test_snps_device_equals_host(sim_community, noisy_reads):
    from midas_tpu.align.oracle import align_oracle
    from midas_tpu.profile.snps import SnpsProfiler

    db = Database(sim_community.db_dir)
    prof = SnpsProfiler(db, sim_community.species_ids())
    res = prof.run([noisy_reads])

    G = prof.pack.total_len
    counts = np.zeros((4, G), np.int32)
    for batch in load_read_batches([noisy_reads], batch_size=8192,
                                   max_len=prof.aligner.max_read_len):
        r = prof.aligner.align_batch(batch)
        a, col, mq = pick_best_hits(r, GLOBAL_SCORING, batch.lengths)
        a[r.n_reads:] = False
        keep = keep_read_mask(r, col, batch, mq, prof.mapid, prof.readq,
                              prof.mapq, prof.aln_cov)
        for i in np.flatnonzero(a & keep):
            c = col[i]
            n = int(batch.lengths[i])
            seg = batch.codes[i, :n]
            if r.strand[i, c]:
                q = np.full_like(batch.codes[i], 4)
                q[:n] = np.where(seg < 4, 3 - seg, 4)[::-1]
                qq = np.zeros_like(batch.quals[i])
                qq[:n] = batch.quals[i, :n][::-1]
            else:
                q, qq = batch.codes[i], batch.quals[i]
            seq_lo = int(prof.pack.offsets[r.seq_idx[i, c]])
            if r.gap_cols[i, c] == 0:
                qpos = np.arange(r.qstart[i, c], r.qend[i, c])
                tpos = seq_lo + r.tstart[i, c] + (qpos - r.qstart[i, c])
            else:
                lo = max(seq_lo + int(r.tstart[i, c]) - 8, 0)
                hi = min(seq_lo + int(r.tend[i, c]) + 8, G)
                qp = np.array([GLOBAL_SCORING.mismatch_penalty(int(x))
                               for x in qq[:n]])
                al = align_oracle(q[:n], prof.pack.codes[lo:hi],
                                  GLOBAL_SCORING, qpen=qp)
                m = al.qpos_to_tpos(n)
                qpos = np.flatnonzero(m >= 0)
                tpos = lo + m[qpos]
            base = q[qpos]
            mask = (qq[qpos] >= prof.baseq) & (base < 4)
            np.add.at(counts, (base[mask], tpos[mask]), 1)
    assert np.array_equal(res["counts"], counts)
