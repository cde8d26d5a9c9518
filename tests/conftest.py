"""Test configuration. On the CPU backend (JAX_PLATFORMS=cpu, as the
tier-1 run sets it) JAX gets 8 virtual devices, so the sharding paths
compile and run without an accelerator. Tests marked `gpu` need an
NVIDIA GPU and skip without one (see the `gpu` fixture).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest

from midas_tpu.testkit import simulate_db, simulate_reads


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(scope="session")
def sim_community(tmp_path_factory):
    db_dir = tmp_path_factory.mktemp("simdb")
    return simulate_db(str(db_dir), n_species=3, genome_len=12000,
                       gene_len=600, n_extra_genes=4, related_pairs=1,
                       divergence=0.03, seed=0)


@pytest.fixture(scope="session")
def three_samples(sim_community, tmp_path_factory):
    """Three per-sample pipeline runs (species+genes+snps) over different
    simulated mixtures; shared by merge and analyze tests."""
    from midas_tpu.profile.genes import run_genes
    from midas_tpu.profile.snps import run_snps
    from midas_tpu.profile.species import run_species

    root = tmp_path_factory.mktemp("cohort")
    dirs = []
    mixes = [[0.5, 0.3, 0.15, 0.05], [0.2, 0.5, 0.2, 0.1], [0.4, 0.4, 0.1, 0.1]]
    for i, mix in enumerate(mixes):
        fq = str(root / f"reads{i}.fq.gz")
        # sample 2 carries biological variants (normal base quality, so
        # they survive the baseq>=30 pileup filter and become SNPs) plus
        # a smaller sequencing-error load at degraded quality
        simulate_reads(sim_community, fq, n_reads=500, abundances=mix,
                       variant_rate=0.02 if i == 2 else 0.0,
                       error_rate=0.005 if i == 2 else 0.0, seed=10 + i)
        outdir = str(root / f"sample{i}")
        base = dict(outdir=outdir, db=sim_community.db_dir, m1=fq, m2=None)
        run_species(dict(base))
        run_genes(dict(base, build_db=True, align=True, cov=True, species_cov=0.1))
        run_snps(dict(base, build_db=True, align=True, call=True, species_cov=0.1))
        dirs.append(outdir)
    return dirs


@pytest.fixture(scope="session")
def merged_all_sites(three_samples, sim_community, tmp_path_factory):
    """merge_midas snps with lenient (all-sites) filters, for analyze tests."""
    from midas_tpu.merge import snps as merge_snps

    outdir = str(tmp_path_factory.mktemp("merged_snps_all"))
    merge_snps.run_pipeline(dict(
        indirs=three_samples, outdir=outdir, db=sim_community.db_dir,
        sample_depth=0.0, fract_cov=0.0, min_samples=1,
        snp_type=["any"], allele_freq=0.01, site_depth=0,
        site_ratio=float("inf"), site_prev=0.0))
    return outdir


@pytest.fixture(scope="session")
def sim_reads(sim_community, tmp_path_factory):
    fq = tmp_path_factory.mktemp("reads") / "sim.fq.gz"
    truth = simulate_reads(sim_community, str(fq), n_reads=800,
                           read_len=100, abundances=[0.5, 0.3, 0.15, 0.05],
                           error_rate=0.005, seed=1)
    return str(fq), truth
