"""Helpers to run the REFERENCE MIDAS species pipeline as a golden
oracle, driving the real bundled `hs-blastn` binary
(/root/reference/bin/Linux/hs-blastn) plus the reference's own Python
classifier (midas/run/species.py). Used by test_golden_hsblastn.py to
prove the BASELINE bit-identical-output contract.

Biopython is not installed in this environment; the reference only uses
Bio.SeqIO.parse for FASTA ids, so a minimal shim is injected before
importing the reference package.
"""

from __future__ import annotations

import os
import subprocess
import sys
import types

REF_ROOT = "/root/reference"
HSBLASTN = os.path.join(REF_ROOT, "bin", "Linux", "hs-blastn")

_STREAM_WRAP = """\
import sys, types
bio = types.ModuleType("Bio"); seqio = types.ModuleType("Bio.SeqIO")
seqio.parse = lambda *a, **k: iter(())
bio.SeqIO = seqio
sys.modules["Bio"] = bio; sys.modules["Bio.SeqIO"] = seqio
sys.path.insert(0, {ref_root!r})
import runpy
runpy.run_path({stream_seqs!r}, run_name="__main__")
"""


def reference_available() -> bool:
    """The reference MIDAS checkout these golden tests run is present."""
    return os.path.isdir(os.path.join(REF_ROOT, "midas"))


def hsblastn_available() -> bool:
    return os.path.isfile(HSBLASTN) and os.access(HSBLASTN, os.X_OK)


def _install_bio_shim() -> None:
    if "Bio" in sys.modules:
        return

    class _Rec:
        def __init__(self, rid, seq):
            self.id = rid
            self.seq = seq
            self.description = rid

    def _parse(path, fmt):
        assert fmt == "fasta"
        rid, chunks = None, []
        # the reference passes both path strings (run/species.py) and
        # already-open file objects (utility.read_genome)
        f = path if hasattr(path, "read") else open(path)
        try:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    if rid is not None:
                        yield _Rec(rid, "".join(chunks))
                    rid, chunks = line[1:].split()[0], []
                else:
                    chunks.append(line)
            if rid is not None:
                yield _Rec(rid, "".join(chunks))
        finally:
            if f is not path:
                f.close()

    bio = types.ModuleType("Bio")
    seqio = types.ModuleType("Bio.SeqIO")
    seqio.parse = _parse
    bio.SeqIO = seqio
    sys.modules["Bio"] = bio
    sys.modules["Bio.SeqIO"] = seqio


def ensure_hsblastn_index(db_dir: str) -> None:
    """`hs-blastn index` over marker_genes/phyeco.fa (writes ~400 MB of
    FMD-index files next to it; skipped when already present)."""
    fa = os.path.join(db_dir, "marker_genes", "phyeco.fa")
    if os.path.exists(fa + ".bwt"):
        return
    subprocess.run([HSBLASTN, "index", fa], check=True,
                   capture_output=True, timeout=300)


def run_reference_species(db_dir: str, reads: str, outdir: str,
                          seed: int = 42, tmpdir: str = None) -> str:
    """Run the reference species pipeline (stream_seqs | hs-blastn |
    find_best_hits/assign/normalize, midas/run/species.py:229-269)
    in-process against the real binary. Returns the profile path."""
    _install_bio_shim()
    if REF_ROOT not in sys.path:
        sys.path.insert(0, REF_ROOT)
    import random

    import numpy as np

    from midas.run import species  # the REFERENCE package

    np.random.seed(seed)
    random.seed(seed)

    wrap_dir = tmpdir or outdir
    os.makedirs(wrap_dir, exist_ok=True)
    wrap = os.path.join(wrap_dir, "stream_wrap.py")
    with open(wrap, "w") as f:
        f.write(_STREAM_WRAP.format(
            ref_root=REF_ROOT,
            stream_seqs=os.path.join(REF_ROOT, "midas/run/stream_seqs.py")))

    os.makedirs(os.path.join(outdir, "species/temp"), exist_ok=True)
    log = open(os.path.join(outdir, "log.txt"), "w")
    try:
        species.run_pipeline({
            "db": db_dir, "outdir": outdir, "m1": reads, "m2": None,
            "max_reads": None, "read_length": None, "word_size": 28,
            "mapid": None, "aln_cov": 0.75, "threads": 1,
            "remove_temp": False, "stream_seqs": wrap,
            "hs-blastn": HSBLASTN, "log": log,
        })
    finally:
        log.close()
    return os.path.join(outdir, "species/species_profile.txt")


def parse_best_hits(m8_path: str, cutoffs: dict, marker_info: dict,
                    aln_cov: float = 0.75) -> dict:
    """The reference's find_best_hits semantics (species.py:64-85):
    per-marker %id cutoff + query coverage, then top score with ties.
    Returns {query: (score, frozenset(targets))}."""
    best = {}
    for line in open(m8_path):
        f = line.split()
        q, t, pid, aln, score = f[0], f[1], float(f[2]), int(f[3]), float(f[11])
        qlen = int(q.rsplit("_", 1)[1])
        if pid < cutoffs[marker_info[t]["marker_id"]]:
            continue
        if aln / qlen < aln_cov:
            continue
        if q not in best or score > best[q][0]:
            best[q] = (score, {t})
        elif score == best[q][0]:
            best[q][1].add(t)
    return {q: (s, frozenset(ts)) for q, (s, ts) in best.items()}


# ---------------------------------------------------------------------------
# Reference MERGE pipelines as in-process golden oracles (pure Python in
# the reference — no binaries needed): midas/merge/{species,genes,snps}.py
# driven on OUR per-sample outputs, for byte-level merge parity tests.
# ---------------------------------------------------------------------------

def _ref_import(modname):
    _install_bio_shim()
    if REF_ROOT not in sys.path:
        sys.path.insert(0, REF_ROOT)
    import importlib

    return importlib.import_module(modname)


def _serial_parallel(fn, argument_list, threads):
    """Replace the reference's mp.Pool driver with in-process serial
    execution (identical results, no fork inside the test process)."""
    for arguments in argument_list:
        fn(*arguments)


def run_reference_merge_species(indirs, outdir, db, min_cov=1.0,
                                max_samples=None):
    ref = _ref_import("midas.merge.species")
    os.makedirs(outdir, exist_ok=True)
    ref.run_pipeline(dict(indirs=list(indirs), outdir=outdir, db=db,
                          min_cov=min_cov, max_samples=max_samples))
    return outdir


def run_reference_merge_genes(indirs, outdir, db, sample_depth=1.0,
                              min_samples=1, cluster_pid="95",
                              min_copy=0.35, species_id=None,
                              max_samples=None, max_species=None):
    ref = _ref_import("midas.merge.genes")
    os.makedirs(outdir, exist_ok=True)
    ref.run_pipeline(dict(
        indirs=list(indirs), outdir=outdir, db=db,
        sample_depth=sample_depth, min_samples=min_samples,
        cluster_pid=cluster_pid, min_copy=min_copy,
        species_id=species_id, max_samples=max_samples,
        max_species=max_species))
    return outdir


def run_reference_merge_snps(indirs, outdir, db, sample_depth=5.0,
                             fract_cov=0.4, min_samples=1,
                             allele_freq=0.01, site_depth=1,
                             site_ratio=float("inf"), site_prev=0.0,
                             snp_type=("any",), max_sites=float("inf"),
                             species_id=None, max_samples=None,
                             max_species=None):
    ref = _ref_import("midas.merge.snps")
    ref.parallel = _serial_parallel   # no fork pools inside pytest
    os.makedirs(outdir, exist_ok=True)
    ref.run_pipeline(dict(
        indirs=list(indirs), outdir=outdir, db=db, threads=1,
        sample_depth=sample_depth, fract_cov=fract_cov,
        min_samples=min_samples, allele_freq=allele_freq,
        site_depth=site_depth, site_ratio=site_ratio,
        site_prev=site_prev, snp_type=list(snp_type),
        max_sites=max_sites, species_id=species_id,
        max_samples=max_samples, max_species=max_species))
    return outdir


_SCRIPT_WRAP = """\
import sys, types
bio = types.ModuleType("Bio"); seqio = types.ModuleType("Bio.SeqIO")

class _Rec:
    def __init__(self, rid, seq):
        self.id = rid; self.seq = seq; self.description = rid

def _parse(path, fmt):
    f = path if hasattr(path, "read") else open(path)
    rid, chunks = None, []
    try:
        for line in f:
            line = line.rstrip("\\n")
            if line.startswith(">"):
                if rid is not None:
                    yield _Rec(rid, "".join(chunks))
                rid, chunks = line[1:].split()[0], []
            else:
                chunks.append(line)
        if rid is not None:
            yield _Rec(rid, "".join(chunks))
    finally:
        if f is not path:
            f.close()

seqio.parse = _parse
bio.SeqIO = seqio
sys.modules["Bio"] = bio; sys.modules["Bio.SeqIO"] = seqio
try:  # the reference predates pandas 2.x (DataFrame.applymap removal)
    import pandas as _pd
    if not hasattr(_pd.DataFrame, "applymap"):
        _pd.DataFrame.applymap = _pd.DataFrame.map
except ImportError:
    pass
sys.path.insert(0, {ref_root!r})
sys.argv = [{script!r}] + {args!r}
import runpy
g = runpy.run_path({script!r}, run_name="__main__")
# the reference scripts never close their outfiles; flush them before
# the runpy globals are dropped (interpreter teardown does not)
import io
for v in list(g.values()):
    if isinstance(v, io.IOBase):
        try:
            if not v.closed:
                v.flush()
        except Exception:
            pass
"""


# The reference scripts are Python-2 era; a couple of lines crash under
# py3 before any analysis runs (None-vs-int comparisons in arg checks).
# The oracle wrapper applies these TARGETED textual py3 fixes to a temp
# copy — semantics identical for our invocations (rand_reads unset).
_PY3_FIXES = {
    "snp_diversity.py": [(
        "\tif args['rand_reads'] > args['site_depth'] and not args['replace_reads']:",
        "\tif args['rand_reads'] is not None and args['rand_reads'] > args['site_depth'] and not args['replace_reads']:",
    )],
    # py2 gzip.open returned text; py3 needs explicit "rt" for DictReader
    "query_by_compound.py": [(
        "csv.DictReader(gzip.open(path), delimiter='\\t')",
        "csv.DictReader(gzip.open(path, 'rt'), delimiter='\\t')",
    )],
}


def run_reference_script(script_name: str, args, tmpdir: str) -> None:
    """Run a reference analysis script (scripts/*.py — pure Python) in a
    subprocess with the Bio.SeqIO shim injected, as a golden oracle for
    our flag-compatible equivalents."""
    script = os.path.join(REF_ROOT, "scripts", script_name)
    fixes = _PY3_FIXES.get(script_name)
    if fixes:
        src = open(script).read()
        for old, new in fixes:
            assert old in src, f"py3 fix target missing in {script_name}"
            src = src.replace(old, new)
        script = os.path.join(tmpdir, f"py3_{script_name}")
        with open(script, "w") as f:
            f.write(src)
    wrap = os.path.join(tmpdir, f"wrap_{script_name}")
    with open(wrap, "w") as f:
        f.write(_SCRIPT_WRAP.format(ref_root=REF_ROOT, script=script,
                                    args=[str(a) for a in args]))
    r = subprocess.run([sys.executable, wrap], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, (
        f"reference {script_name} failed:\n{r.stdout}\n{r.stderr[-3000:]}")
