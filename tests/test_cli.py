"""CLI surface tests: help exits, full pipeline through the shims
(mirrors reference test_midas.py's CLI smoke tests + pipeline tests)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ,
           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           JAX_PLATFORMS="cpu")


def run(cmd, **kw):
    return subprocess.run([sys.executable] + cmd, cwd=REPO, env=ENV,
                          capture_output=True, text=True, **kw)


@pytest.mark.parametrize("script,progs", [
    ("scripts/run_midas.py", ["species", "genes", "snps"]),
    ("scripts/merge_midas.py", ["species", "genes", "snps"]),
])
def test_subcommand_help(script, progs):
    for prog in progs:
        r = run([script, prog, "-h"])
        assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("script", [
    "scripts/call_consensus.py", "scripts/snp_diversity.py",
    "scripts/compare_genes.py", "scripts/query_by_compound.py",
])
def test_analysis_help(script):
    r = run([script, "-h"])
    assert r.returncode == 0, r.stderr


def test_strain_tracking_help():
    for prog in ["id_markers", "track_markers"]:
        r = run(["scripts/strain_tracking.py", prog, "-h"])
        assert r.returncode == 0, r.stderr


def test_full_cli_pipeline(sim_community, sim_reads, tmp_path):
    """run_midas species/genes/snps + merge_midas through the real CLI,
    like reference test_midas.py:86-120."""
    fq, _ = sim_reads
    sample = str(tmp_path / "sample")
    db = sim_community.db_dir
    r = run(["scripts/run_midas.py", "species", sample, "-1", fq, "-d", db, "-n", "300"],
            timeout=500)
    assert r.returncode == 0, r.stderr
    assert os.path.isfile(os.path.join(sample, "species/species_profile.txt"))
    assert os.path.isfile(os.path.join(sample, "species/log.txt"))

    sp0 = sim_community.species[0].species_id
    r = run(["scripts/run_midas.py", "genes", sample, "-1", fq, "-d", db,
             "-n", "300", "--species_id", sp0], timeout=500)
    assert r.returncode == 0, r.stderr
    assert os.path.isfile(os.path.join(sample, f"genes/output/{sp0}.genes.gz"))

    r = run(["scripts/run_midas.py", "snps", sample, "-1", fq, "-d", db,
             "-n", "300", "--species_id", sp0], timeout=500)
    assert r.returncode == 0, r.stderr
    assert os.path.isfile(os.path.join(sample, f"snps/output/{sp0}.snps.gz"))

    merged = str(tmp_path / "merged")
    r = run(["scripts/merge_midas.py", "species", merged + "/species",
             "-i", sample, "-t", "list", "-d", db, "--sample_depth", "0.0"])
    assert r.returncode == 0, r.stderr
    r = run(["scripts/merge_midas.py", "genes", merged + "/genes",
             "-i", sample, "-t", "list", "-d", db, "--sample_depth", "0.0"])
    assert r.returncode == 0, r.stderr
    r = run(["scripts/merge_midas.py", "snps", merged + "/snps",
             "-i", sample, "-t", "list", "-d", db, "--all_samples",
             "--all_sites", "--max_sites", "10000"])
    assert r.returncode == 0, r.stderr
    assert os.path.isfile(os.path.join(merged, "snps", sp0, "snps_info.txt"))

    r = run(["scripts/snp_diversity.py", os.path.join(merged, "snps", sp0),
             "--out", str(tmp_path / "pi.txt")])
    assert r.returncode == 0, r.stderr
    r = run(["scripts/call_consensus.py", os.path.join(merged, "snps", sp0),
             "--out", str(tmp_path / "cons.fa"), "--max_sites", "5000"])
    assert r.returncode == 0, r.stderr
    r = run(["scripts/compare_genes.py", os.path.join(merged, "genes", sp0),
             "--out", str(tmp_path / "dist.txt")])
    assert r.returncode == 0, r.stderr
