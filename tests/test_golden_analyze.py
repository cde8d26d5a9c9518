"""Golden analyze-layer validation: the reference's downstream analysis
scripts (call_consensus, snp_diversity, compare_genes — pure Python,
/root/reference/scripts/) run as subprocess oracles on the same merged
matrices as our flag-compatible equivalents, outputs byte-diffed."""

import os
import subprocess
import sys

import pytest

import refmidas

pytestmark = pytest.mark.skipif(
    not refmidas.reference_available(),
    reason="reference MIDAS checkout unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_ours(script_name, args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script_name)]
        + [str(a) for a in args],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, (
        f"our {script_name} failed:\n{r.stdout}\n{r.stderr[-3000:]}")


def _diff(ours, ref):
    __tracebackhide__ = True
    a = open(ours).read()
    b = open(ref).read()
    if a != b:
        la, lb = a.splitlines(), b.splitlines()
        for i, (ra, rb) in enumerate(zip(la, lb)):
            if ra != rb:
                pytest.fail(f"line {i + 1} differs:\n  ours: {ra!r}\n"
                            f"  ref:  {rb!r}")
        pytest.fail(f"length differs: {len(la)} vs {len(lb)} lines")


@pytest.fixture(scope="module")
def sp_dir(merged_all_sites, sim_community):
    sp0 = sim_community.species[0].species_id
    return os.path.join(merged_all_sites, sp0)


def test_call_consensus_matches_reference(sp_dir, tmp_path):
    args = ["--site_depth", 1, "--site_prev", 0.0, "--site_maf", 0.0]
    ours = str(tmp_path / "ours.fa")
    ref = str(tmp_path / "ref.fa")
    _run_ours("call_consensus.py", [sp_dir, "--out", ours] + args)
    refmidas.run_reference_script(
        "call_consensus.py", [sp_dir, "--out", ref] + args, str(tmp_path))
    _diff(ours, ref)


@pytest.mark.parametrize("mode", ["per-sample", "pooled-samples"])
def test_snp_diversity_matches_reference(sp_dir, tmp_path, mode):
    args = ["--genomic_type", "genome-wide", "--sample_type", mode,
            "--site_depth", 2, "--site_prev", 0.0]
    ours = str(tmp_path / "ours.txt")
    ref = str(tmp_path / "ref.txt")
    _run_ours("snp_diversity.py", [sp_dir, "--out", ours] + args)
    refmidas.run_reference_script(
        "snp_diversity.py", [sp_dir, "--out", ref] + args, str(tmp_path))
    _diff(ours, ref)


def test_snp_diversity_per_gene_matches_reference(sp_dir, tmp_path):
    """Per-gene rows compare as SORTED sets: the reference iterates a
    Python set of gene ids (snp_diversity.py list_genes), so its row
    order is hash-dependent — semantically unordered. Ours emits genes
    sorted; content must match row for row after sorting both."""
    args = ["--genomic_type", "per-gene", "--sample_type", "per-sample",
            "--locus_type", "CDS", "--site_depth", 2, "--site_prev", 0.0]
    ours = str(tmp_path / "ours.txt")
    ref = str(tmp_path / "ref.txt")
    _run_ours("snp_diversity.py", [sp_dir, "--out", ours] + args)
    refmidas.run_reference_script(
        "snp_diversity.py", [sp_dir, "--out", ref] + args, str(tmp_path))
    a = open(ours).read().splitlines()
    b = open(ref).read().splitlines()
    assert a[0] == b[0]                      # header
    assert sorted(a[1:]) == sorted(b[1:])


def _diff_tolerant(ours, ref, rel=1e-12):
    """Byte compare except float fields, which compare at rel tolerance:
    the reference parses its matrix with pandas' fast float parser
    (xstrtod), which rounds some decimal strings 1 ulp away from
    Python's strtod — a documented parser artifact, not a semantic
    difference (all integer-valued fields still match exactly)."""
    __tracebackhide__ = True
    la = open(ours).read().splitlines()
    lb = open(ref).read().splitlines()
    assert len(la) == len(lb), f"row count {len(la)} vs {len(lb)}"
    for i, (ra, rb) in enumerate(zip(la, lb)):
        if ra == rb:
            continue
        fa, fb = ra.split("\t"), rb.split("\t")
        assert len(fa) == len(fb), f"line {i + 1} field count"
        for x, y in zip(fa, fb):
            if x == y:
                continue
            assert abs(float(x) - float(y)) <= rel * max(
                abs(float(x)), abs(float(y))), f"line {i + 1}: {x} vs {y}"


@pytest.mark.parametrize("dtype,distance", [("presabs", "jaccard"),
                                            ("copynum", "euclidean")])
def test_compare_genes_matches_reference(three_samples, sim_community,
                                         tmp_path, dtype, distance):
    from midas_tpu.merge import genes as merge_genes

    merged = str(tmp_path / "merged_genes")
    merge_genes.run_pipeline(dict(
        indirs=three_samples, outdir=merged, db=sim_community.db_dir,
        sample_depth=0.0, min_samples=1, cluster_pid="95", min_copy=0.35,
        species_id=None, max_samples=None, max_species=None))
    sp0 = sim_community.species[0].species_id
    spdir = os.path.join(merged, sp0)
    args = ["--dtype", dtype, "--distance", distance, "--cutoff", 0.35]
    ours = str(tmp_path / "ours.txt")
    ref = str(tmp_path / "ref.txt")
    _run_ours("compare_genes.py", [spdir, "--out", ours] + args)
    refmidas.run_reference_script(
        "compare_genes.py", [spdir, "--out", ref] + args, str(tmp_path))
    if dtype == "copynum":
        _diff_tolerant(ours, ref)   # pandas xstrtod 1-ulp parse artifact
    else:
        _diff(ours, ref)


def test_strain_tracking_matches_reference(sp_dir, tmp_path):
    """id_markers + track_markers vs the reference's
    midas/analyze/track_strains.py driven through its script oracle
    (byte-diffed; both stages are deterministic)."""
    ours_m = str(tmp_path / "ours_markers.txt")
    ref_m = str(tmp_path / "ref_markers.txt")
    common = ["--min_freq", 0.1, "--min_reads", 1, "--allele_prev", 2]
    _run_ours("strain_tracking.py",
              ["id_markers", sp_dir, "--out", ours_m] + common)
    refmidas.run_reference_script(
        "strain_tracking.py",
        ["id_markers", "--indir", sp_dir, "--out", ref_m] + common,
        str(tmp_path))
    _diff(ours_m, ref_m)

    ours_t = str(tmp_path / "ours_track.txt")
    ref_t = str(tmp_path / "ref_track.txt")
    _run_ours("strain_tracking.py",
              ["track_markers", sp_dir, "--out", ours_t,
               "--markers", ours_m, "--min_freq", 0.1, "--min_reads", 1])
    refmidas.run_reference_script(
        "strain_tracking.py",
        ["track_markers", "--indir", sp_dir, "--out", ref_t,
         "--markers", ref_m, "--min_freq", 0.1, "--min_reads", 1],
        str(tmp_path))
    _diff(ours_t, ref_t)


def test_query_by_compound_matches_reference(three_samples, sim_community,
                                             tmp_path):
    """query_by_compound vs the reference script (whose 27.6k-row KEGG
    cpd->enzyme table we package verbatim as data): same compound, same
    samples, byte-identical per-sample gene abundance report."""
    import gzip as _gzip

    db = sim_community.db_dir
    # deterministic EC annotations for every species (an earlier test
    # may have rewritten species 0's file — restore a known state)
    for sp in sim_community.species:
        fdir = os.path.join(db, "pan_genomes", sp.species_id)
        with _gzip.open(os.path.join(fdir, "centroid_functions.txt.gz"),
                        "wt") as f:
            f.write("gene_id\tfunction_id\tontology\n")
            for g, ec in zip(sp.genes[:2], ("4.1.3.22", "4.1.3.25")):
                f.write(f"{g['gene_id']}\t{ec}\tec\n")
    # drop any kegg/ override so both sides use their built-in table
    kegg_override = os.path.join(db, "kegg", "cpd_to_enzyme.txt")
    if os.path.exists(kegg_override):
        os.unlink(kegg_override)
    ours = str(tmp_path / "ours.txt")
    ref = str(tmp_path / "ref.txt")
    inlist = ",".join(three_samples)
    _run_ours("query_by_compound.py",
              ["-i", inlist, "-t", "list", "-d", db, "-c", "C00022",
               "-o", ours])
    refmidas.run_reference_script(
        "query_by_compound.py",
        ["-i", inlist, "-t", "list", "-d", db, "-c", "C00022", "-o", ref],
        str(tmp_path))
    a = open(ours).read().splitlines()
    b = open(ref).read().splitlines()
    assert len(a) > 1, "no rows reported"
    assert a[0] == b[0]
    # reference iterates samples dict in insertion order = -t list order
    # for both; rows must match exactly
    assert a == b
