"""Golden merge-layer validation: the reference's merge pipelines are
pure Python (midas/merge/{species,genes,snps}.py — no binaries), so we
drive them IN-PROCESS on OUR per-sample outputs and byte-diff every
data file against our mergers. This is the same trick
tests/refmidas.py plays for the species run-layer, extended to the
merge layer — snps_info/freq/depth.txt ({0:.3g} mafs, NA fields,
site_id numbering, GeneSweep degeneracy annotation) is the hardest
format in the project and is validated here against the reference's
own implementation, byte for byte."""

import os

import pytest

import refmidas

pytestmark = pytest.mark.skipif(
    not refmidas.reference_available(),
    reason="reference MIDAS checkout unavailable")


def _diff(path_a, path_b):
    __tracebackhide__ = True
    with open(path_a) as fa, open(path_b) as fb:
        a, b = fa.read(), fb.read()
    if a != b:
        la, lb = a.splitlines(), b.splitlines()
        for i, (ra, rb) in enumerate(zip(la, lb)):
            if ra != rb:
                pytest.fail(
                    f"{os.path.basename(path_a)} differs at line {i + 1}:\n"
                    f"  ours: {ra!r}\n  ref:  {rb!r}")
        pytest.fail(f"{os.path.basename(path_a)} differs in length: "
                    f"{len(la)} vs {len(lb)} lines")


def test_merge_species_matches_reference(three_samples, sim_community,
                                         tmp_path):
    from midas_tpu.merge import species as merge_species

    ours = str(tmp_path / "ours")
    merge_species.run_pipeline(dict(
        indirs=three_samples, outdir=ours, db=sim_community.db_dir,
        min_cov=1.0))
    ref = refmidas.run_reference_merge_species(
        three_samples, str(tmp_path / "ref"), sim_community.db_dir,
        min_cov=1.0)
    for f in ("count_reads.txt", "coverage.txt", "relative_abundance.txt",
              "species_prevalence.txt"):
        _diff(os.path.join(ours, f), os.path.join(ref, f))


def test_merge_genes_matches_reference(three_samples, sim_community,
                                       tmp_path):
    from midas_tpu.merge import genes as merge_genes

    common = dict(sample_depth=0.0, min_samples=1, cluster_pid="95",
                  min_copy=0.35)
    ours = str(tmp_path / "ours")
    merge_genes.run_pipeline(dict(
        indirs=three_samples, outdir=ours, db=sim_community.db_dir,
        species_id=None, max_samples=None, max_species=None, **common))
    ref = refmidas.run_reference_merge_genes(
        three_samples, str(tmp_path / "ref"), sim_community.db_dir, **common)
    ref_species = [d for d in os.listdir(ref)
                   if os.path.isdir(os.path.join(ref, d))]
    assert ref_species, "reference merge produced no species"
    assert sorted(ref_species) == sorted(
        d for d in os.listdir(ours) if os.path.isdir(os.path.join(ours, d)))
    for sp in ref_species:
        for f in ("genes_presabs.txt", "genes_copynum.txt",
                  "genes_depth.txt", "genes_reads.txt", "genes_summary.txt"):
            _diff(os.path.join(ours, sp, f), os.path.join(ref, sp, f))


@pytest.mark.parametrize("config", ["all_sites", "core_snps"])
def test_merge_snps_matches_reference(three_samples, sim_community,
                                      tmp_path, config):
    from midas_tpu.merge import snps as merge_snps

    if config == "all_sites":
        site = dict(snp_type=["any"], allele_freq=0.01, site_depth=0,
                    site_ratio=float("inf"), site_prev=0.0)
    else:
        site = dict(snp_type=["bi"], allele_freq=0.01, site_depth=1,
                    site_ratio=2.0, site_prev=0.95)
    # sample_depth 0.01, not 0.0: a sample with ZERO coverage of a
    # species (sample 2 x the related species, whose borderline reads
    # the bowtie2-faithful quality-scaled MAPQ now rejects) makes the
    # REFERENCE divide by zero at site_depth/mean_depth
    # (midas/merge/snps.py:99) when site_depth=0 lets the site reach
    # the ratio test. Any positive sample_depth filters such samples
    # the way the reference's real default (5.0) always would.
    common = dict(sample_depth=0.01, fract_cov=0.0, min_samples=1, **site)
    ours = str(tmp_path / "ours")
    merge_snps.run_pipeline(dict(
        indirs=three_samples, outdir=ours, db=sim_community.db_dir,
        **common))
    ref = refmidas.run_reference_merge_snps(
        three_samples, str(tmp_path / "ref"), sim_community.db_dir,
        snp_type=tuple(site["snp_type"]),
        allele_freq=site["allele_freq"], site_depth=site["site_depth"],
        site_ratio=site["site_ratio"], site_prev=site["site_prev"],
        sample_depth=0.01, fract_cov=0.0, min_samples=1)
    ref_species = [d for d in os.listdir(ref)
                   if os.path.isdir(os.path.join(ref, d))]
    assert ref_species, "reference merge produced no species"
    assert sorted(ref_species) == sorted(
        d for d in os.listdir(ours) if os.path.isdir(os.path.join(ours, d)))
    for sp in ref_species:
        for f in ("snps_info.txt", "snps_freq.txt", "snps_depth.txt",
                  "snps_summary.txt"):
            _diff(os.path.join(ours, sp, f), os.path.join(ref, sp, f))
