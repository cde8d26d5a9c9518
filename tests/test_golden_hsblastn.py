"""GOLDEN cross-validation against the real reference pipeline.

Runs the reference MIDAS species profiler — the actual bundled
`hs-blastn` binary (megablast seed-extend) piped from the reference's
own stream_seqs.py, classified by the reference's find_best_hits /
assign_unique / assign_non_unique / normalize_counts
(midas/run/species.py:29-175) — on a simulated marker DB, and asserts
our device pipeline produces:

1. identical post-filter best-hit target sets per read (the quantity
   every downstream number derives from), and
2. a byte-identical species_profile.txt (same seed for the ambiguous-
   read RNG; both sides draw from MT19937(seed)).

This is the BASELINE "bit-identical outputs" contract, tested against
the real tool rather than a reimplementation.
"""

import os
import shutil

import pytest

from tests import refmidas
from midas_tpu.testkit import simulate_db, simulate_reads

pytestmark = pytest.mark.skipif(
    not refmidas.hsblastn_available(),
    reason="reference hs-blastn binary unavailable")


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Simulated community profiled by BOTH pipelines."""
    root = tmp_path_factory.mktemp("golden")
    db = simulate_db(str(root / "db"), n_species=4, genome_len=20000,
                     gene_len=600, n_extra_genes=4, related_pairs=1,
                     divergence=0.03, seed=0)
    reads = str(root / "reads.fq.gz")
    simulate_reads(db, reads, n_reads=1200, read_len=100,
                   abundances=[0.35, 0.25, 0.2, 0.1, 0.1],
                   error_rate=0.01, seed=7)
    refmidas.ensure_hsblastn_index(db.db_dir)

    refout = str(root / "refout")
    ref_profile = refmidas.run_reference_species(
        db.db_dir, reads, refout, seed=42, tmpdir=str(root))

    from midas_tpu.db.layout import Database
    from midas_tpu.profile.species import SpeciesProfiler, write_abundance

    ourout = str(root / "ourout")
    os.makedirs(os.path.join(ourout, "species/temp"), exist_ok=True)
    prof = SpeciesProfiler(Database(db.db_dir), seed=42)
    our_m8 = os.path.join(ourout, "species/temp/alignments.m8")
    abun = prof.run(reads, batch_size=512, m8_path=our_m8)
    our_profile = os.path.join(ourout, "species/species_profile.txt")
    write_abundance(our_profile, abun)

    yield dict(db=db, prof=prof, ref_profile=ref_profile,
               our_profile=our_profile, our_m8=our_m8,
               ref_m8=os.path.join(refout, "species/temp/alignments.m8"))
    # the FMD index is ~400 MB — drop it with the module
    shutil.rmtree(str(root), ignore_errors=True)


def test_best_hit_sets_identical(golden):
    """Post-filter best-hit target sets (marker cutoff + qcov + top
    score w/ ties) must match hs-blastn's read for read."""
    prof = golden["prof"]
    ours = refmidas.parse_best_hits(golden["our_m8"], prof.cutoffs,
                                    prof.marker_info)
    refs = refmidas.parse_best_hits(golden["ref_m8"], prof.cutoffs,
                                    prof.marker_info)
    assert set(ours) == set(refs), (
        f"hit-read sets differ: only_ours={len(set(ours)-set(refs))} "
        f"only_ref={len(set(refs)-set(ours))}")
    mismatch = {q for q in refs if ours[q][1] != refs[q][1]}
    assert not mismatch, (
        f"{len(mismatch)} reads with different best-hit sets, e.g. "
        f"{sorted(mismatch)[:3]}")


def test_species_profile_byte_identical(golden):
    ref = open(golden["ref_profile"], "rb").read()
    ours = open(golden["our_profile"], "rb").read()
    assert ref == ours


def test_reference_fixture_reads_agree(golden, tmp_path):
    """/root/reference/test/test.fq.gz (2,500 real gut-metagenome reads)
    vs the simulated marker DB: both pipelines must agree on which reads
    align at all (the no-hit path) and on every best-hit set."""
    fq = "/root/reference/test/test.fq.gz"
    if not os.path.exists(fq):
        pytest.skip("reference test.fq.gz missing")
    db = golden["db"]
    refout = str(tmp_path / "ref")
    refmidas.run_reference_species(db.db_dir, fq, refout, seed=42,
                                   tmpdir=str(tmp_path))
    from midas_tpu.db.layout import Database
    from midas_tpu.profile.species import SpeciesProfiler

    prof = SpeciesProfiler(Database(db.db_dir), seed=42)
    our_m8 = str(tmp_path / "our.m8")
    prof.run(fq, batch_size=512, m8_path=our_m8)
    ours = refmidas.parse_best_hits(our_m8, prof.cutoffs, prof.marker_info)
    refs = refmidas.parse_best_hits(
        os.path.join(refout, "species/temp/alignments.m8"),
        prof.cutoffs, prof.marker_info)
    assert set(ours) == set(refs)
    assert all(ours[q][1] == refs[q][1] for q in refs)


def test_best_hits_with_indel_reads(golden, tmp_path):
    """Golden agreement on GAPPED reads: 1-3bp indels at 8% of reads —
    the first external validation of the banded DP's gap handling
    (band_width=16) and gap scoring against real megablast. Asserts the
    same reads align and best-hit sets match read for read."""
    db = golden["db"]
    prof = golden["prof"]
    reads = str(tmp_path / "indel_reads.fq.gz")
    simulate_reads(db, reads, n_reads=800, read_len=100,
                   abundances=[0.35, 0.25, 0.2, 0.1, 0.1],
                   error_rate=0.005, indel_rate=0.08, seed=13)
    refout = str(tmp_path / "ref")
    refmidas.run_reference_species(db.db_dir, reads, refout, seed=42,
                                   tmpdir=str(tmp_path))
    our_m8 = str(tmp_path / "our.m8")
    prof.run(reads, batch_size=512, m8_path=our_m8)
    ours = refmidas.parse_best_hits(our_m8, prof.cutoffs, prof.marker_info)
    refs = refmidas.parse_best_hits(
        os.path.join(refout, "species/temp/alignments.m8"),
        prof.cutoffs, prof.marker_info)
    only_ours = set(ours) - set(refs)
    only_ref = set(refs) - set(ours)
    assert set(ours) == set(refs), (
        f"hit-read sets differ on indel reads: only_ours={len(only_ours)} "
        f"only_ref={len(only_ref)} e.g. {sorted(only_ref | only_ours)[:5]}")
    mismatch = {q for q in refs if ours[q][1] != refs[q][1]}
    assert not mismatch, (
        f"{len(mismatch)}/{len(refs)} indel reads with different best-hit "
        f"sets, e.g. {sorted(mismatch)[:5]}")


def test_best_hits_150bp_reads(golden, tmp_path):
    """Golden agreement on 150 bp reads (the common Illumina length):
    the auto-sized kernel bucket (160) must reproduce real hs-blastn's
    post-filter best-hit sets read for read at full length — the
    round-3 review's silent-truncation regression can never return
    unnoticed."""
    from midas_tpu.db.layout import Database
    from midas_tpu.io.batch import detect_max_read_len
    from midas_tpu.profile.species import SpeciesProfiler

    db = golden["db"]
    reads = str(tmp_path / "reads150.fq.gz")
    simulate_reads(db, reads, n_reads=600, read_len=150,
                   abundances=[0.35, 0.25, 0.2, 0.1, 0.1],
                   error_rate=0.01, indel_rate=0.02, seed=29)
    L = detect_max_read_len([reads])
    assert L == 160
    refout = str(tmp_path / "ref")
    refmidas.run_reference_species(db.db_dir, reads, refout, seed=42,
                                   tmpdir=str(tmp_path))
    prof = SpeciesProfiler(Database(db.db_dir), seed=42, max_read_len=L)
    our_m8 = str(tmp_path / "our.m8")
    abun = prof.run(reads, batch_size=512, m8_path=our_m8)
    assert prof.stats["total_bp"] == 600 * 150   # full length, no cap
    ours = refmidas.parse_best_hits(our_m8, prof.cutoffs, prof.marker_info)
    refs = refmidas.parse_best_hits(
        os.path.join(refout, "species/temp/alignments.m8"),
        prof.cutoffs, prof.marker_info)
    assert set(ours) == set(refs), (
        f"only_ours={len(set(ours) - set(refs))} "
        f"only_ref={len(set(refs) - set(ours))}")
    mismatch = {q for q in refs if ours[q][1] != refs[q][1]}
    assert not mismatch, sorted(mismatch)[:3]


def test_best_hits_short_reads_40bp(golden, tmp_path):
    """Golden agreement at 40 bp (the reference's --read_length 36-50
    regime, just above hs-blastn's 28 bp word size): our -evalue 1e-3
    score gate must keep the post-filter best-hit sets identical to the
    binary's own e-value-thresholded m8."""
    from midas_tpu.db.layout import Database
    from midas_tpu.profile.species import SpeciesProfiler, write_abundance

    db = golden["db"]
    reads = str(tmp_path / "reads40.fq.gz")
    simulate_reads(db, reads, n_reads=800, read_len=40,
                   abundances=[0.35, 0.25, 0.2, 0.1, 0.1],
                   error_rate=0.01, seed=37)
    refout = str(tmp_path / "ref")
    ref_profile = refmidas.run_reference_species(db.db_dir, reads, refout,
                                                 seed=42, tmpdir=str(tmp_path))
    prof = SpeciesProfiler(Database(db.db_dir), seed=42)
    our_m8 = str(tmp_path / "our.m8")
    abun = prof.run(reads, batch_size=512, m8_path=our_m8)
    ours = refmidas.parse_best_hits(our_m8, prof.cutoffs, prof.marker_info)
    refs = refmidas.parse_best_hits(
        os.path.join(refout, "species/temp/alignments.m8"),
        prof.cutoffs, prof.marker_info)
    assert set(ours) == set(refs), (
        f"only_ours={len(set(ours) - set(refs))} "
        f"only_ref={len(set(refs) - set(ours))}")
    assert all(ours[q][1] == refs[q][1] for q in refs)
    our_profile = str(tmp_path / "profile.txt")
    write_abundance(our_profile, abun)
    assert open(our_profile, "rb").read() == open(ref_profile, "rb").read()


def test_profile_byte_identical_250bp(golden, tmp_path):
    """250 bp reads (bucket 256): full-length best-hit parity AND a
    byte-identical species_profile.txt against the real pipeline."""
    from midas_tpu.db.layout import Database
    from midas_tpu.io.batch import detect_max_read_len
    from midas_tpu.profile.species import SpeciesProfiler, write_abundance

    db = golden["db"]
    reads = str(tmp_path / "reads250.fq.gz")
    simulate_reads(db, reads, n_reads=400, read_len=250,
                   abundances=[0.35, 0.25, 0.2, 0.1, 0.1],
                   error_rate=0.01, indel_rate=0.02, seed=31)
    L = detect_max_read_len([reads])
    assert L == 256
    refout = str(tmp_path / "ref")
    ref_profile = refmidas.run_reference_species(
        db.db_dir, reads, refout, seed=42, tmpdir=str(tmp_path))
    prof = SpeciesProfiler(Database(db.db_dir), seed=42, max_read_len=L)
    our_m8 = str(tmp_path / "our.m8")
    abun = prof.run(reads, batch_size=256, m8_path=our_m8)
    assert prof.stats["total_bp"] == 400 * 250
    ours = refmidas.parse_best_hits(our_m8, prof.cutoffs, prof.marker_info)
    refs = refmidas.parse_best_hits(
        os.path.join(refout, "species/temp/alignments.m8"),
        prof.cutoffs, prof.marker_info)
    assert set(ours) == set(refs)
    assert all(ours[q][1] == refs[q][1] for q in refs)
    our_profile = str(tmp_path / "profile.txt")
    write_abundance(our_profile, abun)
    assert open(our_profile, "rb").read() == open(ref_profile, "rb").read()
