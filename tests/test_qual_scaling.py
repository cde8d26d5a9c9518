"""Bowtie2 quality-scaled mismatch penalties (--mp 6,2) and read-N
penalty (--np 1). The DP personalities for pangenome (local) and
rep-genome (glocal) mapping score a mismatch at Phred quality Q as
MN + floor((MX-MN)*MIN(Q,40)/40) per the bowtie2 manual; scores must
agree exactly between the banded DP and the NumPy oracle (the CUDA
kernel is held to the banded DP in tests/test_dp_dispatch.py), and Q40
reads must reproduce the flat
model bit-for-bit (simulator fixtures with constant top quality are
unchanged by this feature)."""

import numpy as np
import pytest

import jax.numpy as jnp

from midas_tpu.align import GLOBAL_SCORING, LOCAL_SCORING, align_oracle
from midas_tpu.align.banded import banded_align
from midas_tpu.io.seqio import PAD_CODE

BAND = 16


def test_mismatch_penalty_table():
    """Spot values of the bowtie2 manual formula, exact integers."""
    s = GLOBAL_SCORING
    assert s.qual_scaled
    expect = {0: 2, 2: 2, 9: 2, 10: 3, 13: 3, 19: 3, 20: 4, 29: 4,
              30: 5, 39: 5, 40: 6, 41: 6, 60: 6}
    for q, p in expect.items():
        assert s.mismatch_penalty(q) == p, (q, s.mismatch_penalty(q), p)
    # flat personality ignores quality entirely
    from midas_tpu.align import MARKER_SCORING
    assert MARKER_SCORING.mismatch_penalty(2) == 4
    assert MARKER_SCORING.mismatch_penalty(40) == 4


def _pack(queries, refs, quals, L, band=BAND):
    P = len(queries)
    W = L + band - 1
    qarr = np.full((P, L), PAD_CODE, dtype=np.int8)
    rarr = np.full((P, W), PAD_CODE, dtype=np.int8)
    parr = np.zeros((P, L), dtype=np.int8)
    qlens = np.zeros(P, dtype=np.int32)
    for i, (q, r, qq) in enumerate(zip(queries, refs, quals)):
        qarr[i, : len(q)] = q
        rarr[i, : min(len(r), W)] = r[:W]
        parr[i, : len(q)] = qq
        qlens[i] = len(q)
    return qarr, rarr, parr, qlens


@pytest.mark.parametrize("params", [GLOBAL_SCORING, LOCAL_SCORING])
def test_banded_qual_scaled_matches_oracle(params):
    rng = np.random.default_rng(7)
    L = 100
    queries, refs, quals, qpens = [], [], [], []
    for t in range(24):
        ref = rng.integers(0, 4, size=L + BAND - 1).astype(np.int8)
        q = np.array(ref[BAND // 2: BAND // 2 + L], copy=True)
        nmut = t % 7
        if nmut:
            pos = rng.choice(L, size=nmut, replace=False)
            q[pos] = (q[pos] + rng.integers(1, 4, size=nmut)) % 4
        if t % 3 == 0 and L > 10:
            q[5] = 4        # read N
        qq = rng.integers(0, 45, size=L).astype(np.int8)
        queries.append(q)
        refs.append(ref)
        quals.append(qq)
        qpens.append(np.array([params.mismatch_penalty(int(x))
                               for x in qq]))
    qarr, rarr, parr, qlens = _pack(queries, refs, qpens, L)
    out = banded_align(jnp.asarray(qarr), jnp.asarray(qlens),
                       jnp.asarray(rarr), params, band_width=BAND,
                       qpen=jnp.asarray(parr))
    out = {k: np.asarray(v) for k, v in out.items()}
    n_checked = 0
    for i in range(len(queries)):
        oracle = align_oracle(queries[i], refs[i], params, qpen=qpens[i])
        if oracle is None:
            assert out["score"][i] <= 0
            continue
        assert out["score"][i] == oracle.score, i
        assert out["matches"][i] == oracle.matches, i
        assert out["mismatches"][i] == oracle.mismatches, i
        n_checked += 1
    assert n_checked >= 16


def test_q40_reads_reproduce_flat_model():
    """At constant Q40 the quality table hits MX=6 everywhere, so the
    qual-scaled DP must equal the flat DP bit-for-bit on N-free reads."""
    rng = np.random.default_rng(3)
    L = 80
    ref = rng.integers(0, 4, size=(32, L + BAND - 1)).astype(np.int8)
    q = np.array(ref[:, BAND // 2: BAND // 2 + L], copy=True)
    for i in range(32):
        pos = rng.choice(L, size=i % 6, replace=False)
        q[i, pos] = (q[i, pos] + rng.integers(1, 4, size=i % 6)) % 4
    qlens = np.full(32, L, dtype=np.int32)
    qpen = np.full((32, L), 6, dtype=np.int8)   # Q40 -> MX
    flat = banded_align(jnp.asarray(q), jnp.asarray(qlens), jnp.asarray(ref),
                        GLOBAL_SCORING, band_width=BAND)
    scaled = banded_align(jnp.asarray(q), jnp.asarray(qlens),
                          jnp.asarray(ref), GLOBAL_SCORING, band_width=BAND,
                          qpen=jnp.asarray(qpen))
    for k in flat:
        np.testing.assert_array_equal(np.asarray(scaled[k]),
                                      np.asarray(flat[k]), err_msg=k)


def test_read_n_costs_np_not_mx():
    """A read N over a real ref base costs 1 (--np), not 6: a glocal
    read with 3 Ns scores -3 under the scaled model vs -18 flat."""
    rng = np.random.default_rng(5)
    L = 50
    ref = rng.integers(0, 4, size=(1, L + BAND - 1)).astype(np.int8)
    q = np.array(ref[:, BAND // 2: BAND // 2 + L], copy=True)
    q[0, [10, 20, 30]] = 4
    qlens = np.full(1, L, dtype=np.int32)
    qpen = np.full((1, L), 6, dtype=np.int8)
    flat = banded_align(jnp.asarray(q), jnp.asarray(qlens), jnp.asarray(ref),
                        GLOBAL_SCORING, band_width=BAND)
    scaled = banded_align(jnp.asarray(q), jnp.asarray(qlens),
                          jnp.asarray(ref), GLOBAL_SCORING, band_width=BAND,
                          qpen=jnp.asarray(qpen))
    assert float(np.asarray(flat["score"])[0]) == -18.0
    assert float(np.asarray(scaled["score"])[0]) == -3.0
    # the oracle agrees
    o = align_oracle(q[0], ref[0], GLOBAL_SCORING,
                     qpen=np.full(L, 6, np.int64))
    assert o.score == -3.0


def test_genes_profiler_quality_scores_end_to_end(tmp_path):
    """End-to-end: a degraded-quality mismatch scores by ITS OWN
    quality. Two reads with one mismatch each — one at Q40, one at Q2 —
    must produce different device scores (−6 vs −2 from perfect), which
    shows the quals really reach the DP through the profiler path."""
    import gzip

    from midas_tpu.db import Database
    from midas_tpu.profile.genes import GenesProfiler
    from midas_tpu.testkit import simulate_db

    comm = simulate_db(str(tmp_path / "db"), n_species=2, genome_len=8000,
                       gene_len=600, n_extra_genes=1, related_pairs=0,
                       seed=2)
    db = Database(comm.db_dir)
    sp = comm.species[0]
    gene = sp.genes[0]["seq"][:100]
    base = np.frombuffer(gene.encode(), np.uint8)
    mut = base.copy()
    mut[50] = {65: 67, 67: 71, 71: 84, 84: 65}[mut[50]]  # A>C>G>T>A
    read = mut.tobytes().decode()
    fq = str(tmp_path / "r.fq.gz")
    with gzip.open(fq, "wt") as f:
        f.write(f"@hi\n{read}\n+\n{'I' * 100}\n")          # Q40
        lowq = "I" * 50 + "#" + "I" * 49                    # Q2 at the snp
        f.write(f"@lo\n{read}\n+\n{lowq}\n")
    prof = GenesProfiler(db, [sp.species_id])
    from midas_tpu.io.batch import load_read_batches

    batch = next(load_read_batches([fq], batch_size=8, max_len=128))
    r = prof.aligner.align_batch(batch)
    s_hi = r.score[0][r.valid[0]].max()
    s_lo = r.score[1][r.valid[1]].max()
    # local mode, match +2: perfect = 200; Q40 mismatch -6 -> 192
    # (99*2 - 6 + clip...) — the exact values depend on clipping; the
    # invariant is the Q2 read scores 4 higher (penalty 2 vs 6)
    assert s_lo == s_hi + 4, (s_hi, s_lo)
