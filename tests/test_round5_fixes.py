"""Round-5 regression tests: cross-host ambiguous-read stream-order
byte-identity, and friends."""

import gzip
import os

import numpy as np
import pytest


def _amb_row(seq_ids, sp_ids, alns, ord_):
    return (np.asarray(seq_ids, np.int64), np.asarray(sp_ids, np.int64),
            np.asarray(alns, np.float64), int(ord_))


def test_amb_assignment_sorts_to_stream_order(sim_community):
    """assign_and_normalize must produce identical profiles no matter
    how the ambiguous rows were merged (stream order vs the multi-host
    process-major concatenation), because each row carries its global
    stream rank. The fixture's tie sets are engineered NON-exchangeable
    — positional (pre-ord) consumption provably diverges between the
    two orders, which is exactly the bug the rank fixes."""
    from midas_tpu.db import Database
    from midas_tpu.profile.species import SpeciesProfiler

    db = Database(sim_community.db_dir)
    prof = SpeciesProfiler(db)
    S = len(prof.species_order)
    assert S >= 4
    uc = np.zeros(S, np.int64)
    uc[0], uc[1], uc[2], uc[3] = 40, 5, 25, 60   # skewed weights
    ub = uc.astype(np.float64) * 100.0
    prof.stats = dict(total_reads=1000, total_bp=100000, total_alns=500)

    # rank 0 saw even-ord rows with tie {sp0, sp2}; rank 1 odd-ord rows
    # with tie {sp1, sp3}: the weighted cdfs differ, so consuming the
    # uniform draws in a different row order flips assignments.
    rank0 = [_amb_row([2 * r, 2 * r + 1], [0, 2], [95.0, 95.0], 2 * r)
             for r in range(25)]
    rank1 = [_amb_row([100 + 2 * r, 101 + 2 * r], [1, 3], [90.0, 90.0],
                      2 * r + 1)
             for r in range(25)]
    stream = sorted(rank0 + rank1, key=lambda t: t[3])
    process_major = rank0 + rank1

    got_stream = prof.assign_and_normalize(uc.copy(), ub.copy(), stream)
    got_pm = prof.assign_and_normalize(uc.copy(), ub.copy(), process_major)
    assert got_stream == got_pm, (
        "merged ambiguous rows must be order-independent via stream rank")

    # non-exchangeability proof: WITHOUT the rank (3-tuples keep list
    # position), the two orders must disagree — i.e. the old
    # process-major merge really was wrong on this fixture.
    old_stream = prof.assign_and_normalize(
        uc.copy(), ub.copy(), [t[:3] for t in stream])
    old_pm = prof.assign_and_normalize(
        uc.copy(), ub.copy(), [t[:3] for t in process_major])
    assert old_stream != old_pm, (
        "fixture failed to exercise order dependence — tighten it")
    assert got_stream == old_stream, (
        "stream-order consumption must match the positional stream order")


def _conserved_window(a: str, b: str, c: str, L: int = 100):
    """First window where a==b but a!=c (position-aligned sequences)."""
    n = min(len(a), len(b), len(c))
    for i in range(0, n - L):
        wa, wb, wc = a[i:i + L], b[i:i + L], c[i:i + L]
        if wa == wb and wa != wc:
            return wa
    return None


def _unique_window(a: str, others, L: int = 100):
    n = min([len(a)] + [len(o) for o in others])
    for i in range(0, n - L):
        wa = a[i:i + L]
        if all(wa != o[i:i + L] for o in others):
            return wa
    return None


@pytest.fixture(scope="module")
def tie_streams(tmp_path_factory):
    """An engineered read stream whose ambiguous tie sets are
    rank-asymmetric under 2-way batch striding (batch_size=128):
    batch 0 -> tie {base, relA}; batch 1 -> tie {base, relB};
    batch 2 -> mixed; batch 3 -> uniques that skew the weights."""
    from midas_tpu.db import Database
    from midas_tpu.testkit import simulate_db

    tmp = tmp_path_factory.mktemp("tie_stream")
    comm = simulate_db(str(tmp / "db"), n_species=2, genome_len=9000,
                       gene_len=600, n_extra_genes=2, related_pairs=2,
                       divergence=0.03, seed=11)
    db = Database(comm.db_dir)
    info = db.marker_info()
    # species 3 and 4 are both mutated copies of species 1
    by_sp = {}
    for gid, rec in info.items():
        by_sp.setdefault(rec["species_id"], {})[rec["marker_id"]] = gid
    sids = sorted(by_sp)
    base, relA, relB = sids[0], sids[2], sids[3]
    seqs = {}
    from midas_tpu.io.seqio import iopen, read_fastx

    with iopen(db.marker_fasta()) as fh:
        for name, seq, _q in read_fastx(fh):
            seqs[name] = seq.upper()

    def win(kind):
        for mid in sorted(by_sp[base]):
            a = seqs[by_sp[base][mid]]
            b = seqs[by_sp[relA][mid]]
            c = seqs[by_sp[relB][mid]]
            if kind == "AB":
                w = _conserved_window(a, b, c)
            elif kind == "AC":
                w = _conserved_window(a, c, b)
            else:
                w = _unique_window({"A": a, "B": b, "C": c}[kind],
                                   [x for k, x in
                                    (("A", a), ("B", b), ("C", c))
                                    if k != kind])
            if w:
                return w
        raise AssertionError(f"no {kind} window in fixture")

    amb_ab = win("AB")      # ties {base, relA}
    amb_ac = win("AC")      # ties {base, relB}
    u_a, u_b, u_c = win("A"), win("B"), win("C")

    reads = []
    reads += [amb_ab] * 96 + [u_a] * 20 + [u_b] * 12    # batch 0
    reads += [amb_ac] * 96 + [u_c] * 32                 # batch 1
    reads += [amb_ab] * 48 + [amb_ac] * 48 + [u_a] * 32  # batch 2
    reads += [u_b] * 40 + [u_c] * 24                    # batch 3 (short)
    fq = str(tmp / "tie_reads.fq.gz")
    with gzip.open(fq, "wt") as f:
        for i, seq in enumerate(reads):
            f.write(f"@tie{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return comm, fq


_WORKER = r"""
import os, sys
import jax

jax.config.update("jax_platforms", "cpu")
rank = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
db_dir, fq, outdir = sys.argv[4], sys.argv[5], sys.argv[6]
jax.distributed.initialize(f"localhost:{port}", nproc, rank)
from midas_tpu.dist.driver import run_species_multihost
run_species_multihost(db_dir, fq, outdir=outdir, batch_size=128)
print("WORKER_OK", rank)
"""


def test_two_process_heterogeneous_ties_byte_identical(tie_streams,
                                                       tmp_path):
    """2-process run over the ENGINEERED stream: rank 0's batches carry
    tie {base, relA}, rank 1's tie {base, relB} (non-exchangeable), so
    the old process-major merge consumed the RNG draws against the
    wrong rows and diverged from single-process output. With the
    carried stream ranks the written profile must be byte-identical."""
    import socket
    import subprocess
    import sys as _sys

    from midas_tpu.db import Database
    from midas_tpu.profile.species import SpeciesProfiler, write_abundance

    comm, fq = tie_streams
    prof = SpeciesProfiler(Database(comm.db_dir))
    want = prof.run([fq], batch_size=128)
    want_path = str(tmp_path / "single_profile.txt")
    write_abundance(want_path, want)

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    outdir = str(tmp_path / "multi")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    procs = [
        subprocess.Popen(
            [_sys.executable, "-c", _WORKER, str(r), "2", str(port),
             comm.db_dir, fq, outdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("two-process driver timed out")
    for rc, out, err in outs:
        if rc != 0 and ("distributed" in err.lower()
                        and "not" in err.lower()):
            pytest.skip(f"jax.distributed unavailable: {err[-200:]}")
        assert rc == 0, f"worker failed:\n{out}\n{err[-2000:]}"
        assert "WORKER_OK" in out
    got_path = os.path.join(outdir, "species/species_profile.txt")
    assert open(got_path).read() == open(want_path).read()


def test_discordant_pair_divergence_quantified(sim_community, tmp_path):
    """Quantify the documented pairing divergence: when a concordant pair exists, it always wins here even if one
    mate's best UNPAIRED alignment scores higher elsewhere. Chimeric
    pairs (mate 2 swapped to the homologous locus of a 3%-related
    genome — a structural-variant / mate-contamination model) are the
    worst case: the divergence between paired and per-mate placement
    must be bounded by the chimera fraction, and clean pairs must be
    unaffected."""
    from midas_tpu.db import Database
    from midas_tpu.profile.snps import SnpsProfiler

    comm = sim_community
    spA, spB = comm.species[0], comm.species[3]   # B = 3% mutant of A
    rng = np.random.default_rng(17)
    n_pairs, chimera_frac, rl = 300, 0.1, 100

    def revcomp(s):
        return s[::-1].translate(str.maketrans("ACGT", "TGCA"))

    cidA = sorted(spA.contigs)[0]
    cidB = sorted(spB.contigs)[0]
    seqA, seqB = spA.contigs[cidA], spB.contigs[cidB]
    layout = []
    for i in range(n_pairs):
        flen = int(rng.integers(260, 380))
        pos = int(rng.integers(0, len(seqA) - flen))
        layout.append((pos, flen, rng.random() < chimera_frac))
    n_chim = sum(1 for _p, _f, c in layout if c)

    def write_lib(path, with_chimeras):
        with gzip.open(path, "wt") as f:
            for i, (pos, flen, chim) in enumerate(layout):
                m1 = seqA[pos: pos + rl]
                src = seqB if (chim and with_chimeras) else seqA
                m2 = revcomp(src[pos + flen - rl: pos + flen])
                f.write(f"@p{i}/1\n{m1}\n+\n{'I' * rl}\n")
                f.write(f"@p{i}/2\n{m2}\n+\n{'I' * rl}\n")

    db = Database(comm.db_dir)
    sel = [spA.species_id, spB.species_id]

    def mapped(path, paired):
        prof = SnpsProfiler(db, sel)
        got = prof.run([path], batch_size=256, paired=paired,
                       interleaved=paired)
        return got["mapped_reads"].astype(np.int64)

    clean = str(tmp_path / "clean.fq.gz")
    chim = str(tmp_path / "chimeric.fq.gz")
    write_lib(clean, with_chimeras=False)
    write_lib(chim, with_chimeras=True)
    # clean pairs: neither policy puts anything on the related genome
    assert mapped(clean, True)[1] == 0
    assert mapped(clean, False)[1] == 0
    # chimeric mates: per-mate best-hit places a fraction on their true
    # (related-genome) locus; the concordant-priority policy forces
    # every one of them back to the concordant placement. Measured with
    # this fixture (7% chimeric pairs, 3% divergence): 13 of 22
    # chimeric mates move — the number documented in
    # paired_best_hit_device's docstring.
    moved_unpaired = int(mapped(chim, False)[1])
    moved_paired = int(mapped(chim, True)[1])
    assert moved_paired == 0, moved_paired
    assert 0 < moved_unpaired <= n_chim, (moved_unpaired, n_chim)


def test_evalue_gate_drops_subthreshold_short_hits(sim_community):
    """The -evalue 1e-3 gate (hs-blastn pre-thresholds the m8 the
    reference parses, midas/run/species.py:39-46): an ultra-short
    perfect hit whose e-value exceeds 1e-3 at a large database size
    must be dropped by the device classifier; the same alignment passes
    with the gate disabled (dblen=0). Also pins the algebra: the score
    threshold's e-value is exactly 1e-3."""
    import jax.numpy as jnp

    from midas_tpu.align.params import MARKER_SCORING
    from midas_tpu.db import Database
    from midas_tpu.io.batch import batch_reads
    from midas_tpu.io.seqio import iopen, read_fastx
    from midas_tpu.profile import device_steps as ds
    from midas_tpu.profile.species import SpeciesProfiler

    thr = MARKER_SCORING.evalue_score_threshold(20, 1e9)
    assert abs(MARKER_SCORING.evalue(float(thr), 20, int(1e9)) - 1e-3) < 1e-9

    db = Database(sim_community.db_dir)
    prof = SpeciesProfiler(db)
    with iopen(db.marker_fasta()) as fh:
        _name, seq, _q = next(read_fastx(fh))
    read = seq[10:30].upper()          # 20 bp perfect marker fragment
    batch = batch_reads([("s", read, "I" * 20)] * 4, 8, 128)
    al = prof.aligner

    def run(dblen):
        st = ds.species_init(len(prof.species_order),
                             al.seed_params.num_cands, 1024)
        st = ds.species_update(
            st, al.index_arrays, al.pack_arrays,
            jnp.asarray(prof.seq_species), jnp.asarray(prof.seq_cutoff),
            jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
            jnp.int32(batch.n_reads), jnp.int32(0),
            scoring=al.scoring, seed_params=al.seed_params,
            max_len=al.max_read_len, aln_cov=0.75,
            n_species=len(prof.species_order), dblen=dblen)
        h = ds.species_state_host(st)
        return int(h["uniq_count"][:-1].sum()) + int(h["amb_n"])

    # score 40 (20 matches x 2): kept without the gate, dropped when
    # dblen makes the e-value threshold exceed it
    assert run(0.0) == 4
    assert float(MARKER_SCORING.evalue_score_threshold(20, 1e9)) > 40
    assert run(1e9) == 0


def test_gap_spill_staging_drain(tmp_path):
    """The gapped-read spill is a draining STAGING buffer, not a hard
    cap: a tiny gap_cap forces a drain after every batch and the final
    pileup must be bit-identical to a default-cap run (previously a
    long indel-rich stream could overflow MIDAS_TPU_GAP_CAP and die)."""
    from midas_tpu.db import Database
    from midas_tpu.profile.snps import SnpsProfiler
    from midas_tpu.testkit import simulate_reads
    import midas_tpu.testkit as tk

    comm = tk.simulate_db(str(tmp_path / "db"), n_species=2,
                          genome_len=9000, gene_len=600, n_extra_genes=1,
                          related_pairs=0, seed=21)
    fq = str(tmp_path / "indel_reads.fq.gz")
    simulate_reads(comm, fq, n_reads=600, read_len=100, error_rate=0.005,
                   indel_rate=0.05, seed=22)
    db = Database(comm.db_dir)
    sel = comm.species_ids()
    want = SnpsProfiler(db, sel).run([fq], batch_size=128)
    assert want["n_gapped"] > 10, "fixture produced too few gapped reads"
    got = SnpsProfiler(db, sel).run([fq], batch_size=128, gap_cap=1)
    # gap_cap=1 clamps to 2*batch_size=256 staging rows -> a drain
    # after every batch; results must not change
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert got["n_gapped"] == want["n_gapped"]


def test_revcomp_shift_ladder_exact():
    """revcomp_batch / reverse_batch via the flip + binary-shift ladder
    (gather-free, where the take_along_axis row gather was not) must
    match the naive per-element
    construction for every read length."""
    import jax.numpy as jnp

    from midas_tpu.align.seed import reverse_batch, revcomp_batch

    rng = np.random.default_rng(9)
    B, L = 64, 128
    codes = rng.integers(0, 5, size=(B, L)).astype(np.int8)
    qlens = np.concatenate([[0, 1, L], rng.integers(1, L + 1, B - 3)]
                           ).astype(np.int32)
    for i in range(B):
        codes[i, qlens[i]:] = 4
    want_rc = np.full((B, L), 4, np.int8)
    want_rev = np.zeros((B, L), np.int8)
    for i in range(B):
        n = qlens[i]
        seg = codes[i, :n][::-1]
        want_rc[i, :n] = np.where(seg < 4, 3 - seg, 4)
        want_rev[i, :n] = seg
    got_rc = np.asarray(revcomp_batch(jnp.asarray(codes),
                                      jnp.asarray(qlens)))
    got_rev = np.asarray(reverse_batch(jnp.asarray(codes),
                                       jnp.asarray(qlens), fill=0))
    np.testing.assert_array_equal(got_rc, want_rc)
    np.testing.assert_array_equal(got_rev, want_rev)


def test_split_reads_round_robin(tmp_path):
    """split_reads (the multi-host input-sharding escape hatch): byte-
    exact record dealing, round-robin, with --paired keeping interleaved
    mates together."""
    from midas_tpu.cli.split_reads import split_reads

    fq = str(tmp_path / "in.fq.gz")
    with gzip.open(fq, "wt") as f:
        for i in range(10):
            f.write(f"@r{i}/1\nACGT\n+\nIIII\n@r{i}/2\nTTTT\n+\nIIII\n")
    outs = split_reads(fq, 3, str(tmp_path / "sh"))
    assert len(outs) == 3
    whole = []
    for p in outs:
        with gzip.open(p, "rt") as f:
            whole.append(f.read())
    # all 20 records present, none duplicated, byte-identical content
    assert sum(w.count("@r") for w in whole) == 20
    assert "".join(sorted("".join(whole).splitlines(True))) == \
        "".join(sorted(gzip.open(fq, "rt").read().splitlines(True)))
    # paired mode: mates never split across shards
    outs_p = split_reads(fq, 3, str(tmp_path / "shp"), paired=True)
    for p in outs_p:
        with gzip.open(p, "rt") as f:
            names = [line.strip() for line in f if line.startswith("@r")]
        assert len(names) % 2 == 0
        for a, b in zip(names[0::2], names[1::2]):
            assert a[:-2] == b[:-2] and a.endswith("/1") and b.endswith("/2")


def test_detect_max_read_len_scans_whole_file(tmp_path):
    """A long read appearing AFTER the first 4096 reads must still grow
    the padded-length bucket (advisor r4: head sampling silently
    truncated late long reads; detection now scans the whole file
    through the native reader)."""
    from midas_tpu.io.batch import detect_max_read_len
    from midas_tpu.io.native import native_max_read_len

    fq = str(tmp_path / "late_long.fq.gz")
    with gzip.open(fq, "wt") as f:
        for i in range(5000):
            f.write(f"@r{i}\n{'A' * 100}\n+\n{'I' * 100}\n")
        f.write(f"@long\n{'C' * 180}\n+\n{'I' * 180}\n")
    if native_max_read_len([fq]) is None:
        pytest.skip("native reader unavailable")
    assert detect_max_read_len([fq]) == 256   # bucket covering 180


def test_engineered_ties_are_ambiguous(tie_streams):
    """Sanity: the engineered stream really produces rank-asymmetric
    ambiguous rows (>=90 per conserved window batch)."""
    from midas_tpu.db import Database
    from midas_tpu.profile.species import SpeciesProfiler

    comm, fq = tie_streams
    prof = SpeciesProfiler(Database(comm.db_dir))
    uc, ub, amb = prof._run_device([fq], None, None, 128)
    assert len(amb) >= 200, f"only {len(amb)} ambiguous rows"
    widths = {len(t[1]) for t in amb}
    assert widths == {2}
    # tie sets split by batch parity of their stream rank
    sets0 = {tuple(t[1]) for t in amb if (t[3] // 128) % 2 == 0}
    sets1 = {tuple(t[1]) for t in amb if (t[3] // 128) % 2 == 1}
    assert sets0 != sets1, "tie sets are exchangeable across ranks"
