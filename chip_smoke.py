#!/usr/bin/env python
"""Smoke test of the whole system on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py          # phases (a)-(d) below, on one card
    python chip_smoke.py --four   # the multi-card drivers on four cards,
                                  # against the one-card run

Phases, each of which fails the run:

(a) device: JAX's default device is a GPU; prints its kind and the
    card's name and power limit (nvidia-smi).
(b) banded DP: the CUDA kernel against the jnp reference
    (align/banded.py) at the widths the profilers use, every scoring
    personality, full statistics and score-only, with and without
    quality penalties. Tolerance: none, every output bit-equal. Prints
    both times, and the species_update step's time with each.
(c) the species, genes and snps legs of run_midas, in this process, on
    a simulated database and sample of realistic size; per leg its wall
    time, compile time, peak device memory and whether the native FASTQ
    reader ran. The simulated community's species must be found and no
    other.
(d) GPU against CPU: the three legs on a tiny community here and in a
    child process pinned to the CPU; the outputs (decompressed) must be
    byte-identical.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
(count 4 with --four). Any failure raises, exits non-zero and prints no
such line.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

import midas_tpu  # noqa: F401  (fails outside a checkout)

CARD = "?"          # "name, power.limit" of the card, set by phase (a)

# phase (c): the simulated database and sample (cut from a production
# MIDAS DB of 5,952 species with 2-6 Mb genomes and a ~17M-pair sample)
DB_SIZE = dict(n_species=500, related_pairs=125, genome_len=1_000_000,
               gene_len=900, seed=0)
N_PAIRS = 131_072
COMMUNITY = list(range(1, 500, 25))   # 20 unrelated base species
SPECIES_COV = "1.0"

# phase (b): widths the profilers run the DP at (batch 8192 x 8
# candidates in the score-only pass, 8192 chosen pairs with full stats)
DP_P_SCORE, DP_P_FULL, DP_D = 65_536, 8_192, 16
DP_LENS = (128, 160)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, reps: int = 5) -> float:
    """Median seconds of fn(*args) over reps runs after one warm-up."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling since reset()."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration

    def reset(self) -> None:
        self.total = 0.0


# --------------------------------------------------------------------------
# (a) device
# --------------------------------------------------------------------------

def phase_device(n_cards: int = 1):
    import jax

    from midas_tpu.runtime import card_info, require_gpu

    global CARD
    dev = require_gpu(n_cards)
    CARD = card_info()
    log(f"(a) device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}")
    log(f"(a) card: {CARD}")
    return dev


# --------------------------------------------------------------------------
# (b) the banded DP kernel against the jnp reference
# --------------------------------------------------------------------------

def dp_case(rng: np.random.Generator, P: int, L: int, D: int):
    """P (query, window) pairs as the aligner builds them: reads taken
    from their windows at a random band offset with substitutions,
    1-2 base indels, read and reference Ns, short and empty reads, and
    one pair in ten unrelated to its window. Returns int8 query [P, L],
    int32 qlens [P], int8 window [P, L+D-1], int8 Phred quals [P, L]."""
    W = L + D - 1
    win = rng.integers(0, 4, (P, W)).astype(np.int8)
    win[rng.random((P, W)) < 0.002] = 4
    qlens = rng.choice(np.array([L, L - 10, L - 28, L // 4]), P,
                       p=[0.55, 0.25, 0.15, 0.05]).astype(np.int32)
    qlens[rng.random(P) < 0.01] = 0
    j = np.arange(L)[None, :]
    start = rng.integers(0, D, P)[:, None]
    at = rng.integers(1, L, P)[:, None]
    shift = rng.choice(np.array([0, 1, 2, -1, -2]), P,
                       p=[0.6, 0.1, 0.1, 0.1, 0.1])[:, None]
    src = np.clip(start + j + np.where(j >= at, shift, 0), 0, W - 1)
    q = np.take_along_axis(win, src, axis=1)
    q = np.where(win[np.arange(P)[:, None], src] == 4,
                 rng.integers(0, 4, (P, L)), q).astype(np.int8)
    sub = rng.random((P, L)) < 0.03
    q[sub] = (q[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    q[rng.random((P, L)) < 0.003] = 4
    unrelated = rng.random(P) < 0.1
    q[unrelated] = rng.integers(0, 4, (int(unrelated.sum()), L))
    q[j >= qlens[:, None]] = 4
    quals = rng.integers(2, 42, (P, L)).astype(np.int8)
    return q, qlens, win, quals


def _equal(name: str, want: dict, got: dict, keys, rows=None) -> None:
    for k in keys:
        a = np.asarray(want[k])[:rows]
        b = np.asarray(got[k])
        if a.shape != b.shape:
            raise AssertionError(f"(b) {name}: {k} shape {b.shape} != "
                                 f"{a.shape}")
        bad = np.flatnonzero(a != b)
        if bad.size:
            first = ", ".join(f"pair {i}: {a[i]} vs {b[i]}" for i in bad[:4])
            raise AssertionError(f"(b) {name}: {k} differs from the "
                                 f"reference at {bad.size} pairs ({first})")


def phase_dp():
    import jax
    import jax.numpy as jnp

    from midas_tpu.align.banded import banded_align
    from midas_tpu.align.banded_cuda import banded_align_cuda, build
    from midas_tpu.align.params import (GLOBAL_SCORING, LOCAL_SCORING,
                                        MARKER_SCORING)
    from midas_tpu.align.pipeline import (SCORE_ONLY_KEYS,
                                          dp_for_platform,
                                          quality_penalties)

    t0 = time.perf_counter()
    build()
    log(f"(b) kernel library built/loaded in "
        f"{time.perf_counter() - t0:.3f} s (set-up) [{CARD}]")
    if dp_for_platform(jax.default_backend()) is not banded_align_cuda:
        raise AssertionError("(b) dispatch does not pick the CUDA kernel")
    rng = np.random.default_rng(0)
    personalities = (("GLOBAL", GLOBAL_SCORING), ("LOCAL", LOCAL_SCORING),
                     ("MARKER", MARKER_SCORING))
    n_cmp = 0
    for L in DP_LENS:
        q, qlens, win, quals = (jnp.asarray(a) for a in
                                dp_case(rng, DP_P_SCORE, L, DP_D))
        qf, qlf, wf = q[:DP_P_FULL], qlens[:DP_P_FULL], win[:DP_P_FULL]
        for pname, params in personalities:
            qpen_all = quality_penalties(quals, params)
            for use_qpen in (False, True):
                qp = qpen_all if use_qpen else None
                qpf = qp[:DP_P_FULL] if use_qpen else None
                ref = banded_align(q, qlens, win, params, DP_D, qpen=qp)
                got_s = banded_align_cuda(q, qlens, win, params, DP_D,
                                          score_only=True, qpen=qp)
                got_f = banded_align_cuda(qf, qlf, wf, params, DP_D,
                                          qpen=qpf)
                tag = f"L={L} {pname} qpen={int(use_qpen)}"
                _equal(f"{tag} score-only", ref, got_s, SCORE_ONLY_KEYS)
                _equal(f"{tag} full", ref, got_f, ref.keys(), DP_P_FULL)
                n_cmp += 2
                if use_qpen != params.qual_scaled:
                    continue    # time the mode the profilers run
                t_ks = timed(lambda: banded_align_cuda(
                    q, qlens, win, params, DP_D, score_only=True, qpen=qp))
                t_ps = timed(lambda: banded_align(q, qlens, win, params,
                                                  DP_D, qpen=qp))
                t_kf = timed(lambda: banded_align_cuda(qf, qlf, wf, params,
                                                       DP_D, qpen=qpf))
                t_pf = timed(lambda: banded_align(qf, qlf, wf, params,
                                                  DP_D, qpen=qpf))
                log(f"(b) {tag}: score-only P={DP_P_SCORE} kernel "
                    f"{t_ks * 1e3:.4f} ms, XLA jnp {t_ps * 1e3:.4f} ms; "
                    f"full P={DP_P_FULL} kernel {t_kf * 1e3:.4f} ms, "
                    f"XLA jnp {t_pf * 1e3:.4f} ms [{CARD}]")
    log(f"(b) {n_cmp} kernel runs bit-equal to banded_align "
        f"(D={DP_D}, L in {DP_LENS}, P={DP_P_SCORE}/{DP_P_FULL}; "
        f"tolerance 0)")


# --------------------------------------------------------------------------
# (c) the three legs at a realistic size
# --------------------------------------------------------------------------

def simulate(work: str, db_size: dict, n_pairs: int, community,
             read_len: int = 150):
    """Database + paired FASTQ of the community (host only)."""
    from midas_tpu.testkit import simulate_db, simulate_paired_reads

    comm = simulate_db(os.path.join(work, "db"), **db_size)
    rng = np.random.default_rng(1)
    ab = np.zeros(len(comm.species))
    ab[community] = rng.uniform(0.75, 1.25, len(community))
    r1, r2 = (os.path.join(work, f"reads_{m}.fq.gz") for m in (1, 2))
    simulate_paired_reads(comm, r1, r2, n_pairs=n_pairs, read_len=read_len,
                          frag_range=(300, 500), abundances=list(ab),
                          indel_rate=0.01, seed=2)
    return comm, r1, r2


def read_profile(outdir: str) -> dict:
    from midas_tpu.io.seqio import parse_file

    return {r["species_id"]: int(r["count_reads"]) for r in
            parse_file(os.path.join(outdir, "species/species_profile.txt"))}


def output_species(outdir: str, program: str) -> set:
    suffix = f".{program}.gz"
    d = os.path.join(outdir, program, "output")
    return {f[: -len(suffix)] for f in os.listdir(d) if f.endswith(suffix)}


def run_legs(db_dir: str, r1: str, r2, outdir: str, species_cov: str,
             clock=None, device=None) -> dict:
    """run_midas species, genes, snps in this process; per-leg stats."""
    from midas_tpu.cli.run_midas import main as run_midas

    reads = ["-1", r1] + (["-2", r2] if r2 else [])
    stats = {}
    for program in ("species", "genes", "snps"):
        argv = [program, outdir] + reads + ["-d", db_dir]
        if program != "species":
            argv += ["--species_cov", species_cov]
        if clock:
            clock.reset()
        t0 = time.perf_counter()
        run_midas(argv)
        st = dict(wall=time.perf_counter() - t0)
        if clock:
            st["compile"] = clock.total
        if device is not None:
            st["peak_bytes"] = device.memory_stats()["peak_bytes_in_use"]
        stats[program] = st
    return stats


def time_species_step(db_dir: str, r1: str, batch: int = 8192):
    """species_update over one batch of 150 bp reads, with the CUDA
    kernel and with the jnp DP in its place."""
    import jax

    from midas_tpu.align import pipeline
    from midas_tpu.db import Database
    from midas_tpu.io.batch import load_read_batches
    from midas_tpu.profile import device_steps as ds
    from midas_tpu.profile.species import SpeciesProfiler

    prof = SpeciesProfiler(Database(db_dir), max_read_len=160)
    al = prof.aligner
    b = next(iter(load_read_batches([r1], batch_size=batch, max_len=160)))
    n_species = len(prof.species_order)
    args = (al.index_arrays, al.pack_arrays,
            jax.numpy.asarray(prof.seq_species),
            jax.numpy.asarray(prof.seq_cutoff), jax.numpy.asarray(b.codes),
            jax.numpy.asarray(b.lengths), np.int32(b.n_reads), np.int32(0))
    kw = dict(scoring=al.scoring, seed_params=al.seed_params,
              max_len=al.max_read_len, aln_cov=prof.aln_cov,
              n_species=n_species, dblen=float(prof.pack.total_len))

    def run(reps: int):
        state = ds.species_init(n_species, al.seed_params.num_cands, 65536)
        t0 = time.perf_counter()
        state = ds.species_update(state, *args, **kw)
        jax.block_until_ready(state)
        first = time.perf_counter() - t0
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            state = ds.species_update(state, *args, **kw)
            jax.block_until_ready(state)
            ts.append(time.perf_counter() - t0)
        return first, float(np.median(ts)), ds.species_state_host(state)

    k_first, k_step, k_state = run(10)
    chosen = pipeline.dp_for_platform
    pipeline.dp_for_platform = lambda platform: pipeline.plain_banded_align
    jax.clear_caches()
    try:
        p_first, p_step, p_state = run(10)
    finally:
        pipeline.dp_for_platform = chosen
        jax.clear_caches()
    for k in ("uniq_count", "uniq_bp", "amb_sp", "total_alns"):
        if not np.array_equal(k_state[k], p_state[k]):
            raise AssertionError(f"(c) species_update {k}: kernel and "
                                 f"jnp DP disagree")
    log(f"(c) species_update, {batch} reads x 8 candidates, L=160: CUDA "
        f"kernel {k_step * 1e3:.4f} ms/step (first call {k_first:.3f} s), "
        f"jnp DP in the fused jit {p_step * 1e3:.4f} ms/step (first call, "
        f"compile included, {p_first:.3f} s); same state [{CARD}]")


def phase_legs(work: str, device, clock):
    from midas_tpu.io.native import load_native

    t0 = time.perf_counter()
    comm, r1, r2 = simulate(work, DB_SIZE, N_PAIRS, COMMUNITY)
    log(f"(c) simulated {len(comm.species)} species x "
        f"{DB_SIZE['genome_len']} bp, {N_PAIRS} read pairs x 150 bp in "
        f"{time.perf_counter() - t0:.3f} s (host set-up) [{CARD}]")
    want = {comm.species[i].species_id for i in COMMUNITY}
    out = os.path.join(work, "out")
    stats = run_legs(comm.db_dir, r1, r2, out, SPECIES_COV, clock, device)
    native = load_native() is not None
    for program, st in stats.items():
        log(f"(c) {program}: wall {st['wall']:.3f} s, compile "
            f"{st['compile']:.3f} s, peak_bytes_in_use {st['peak_bytes']}, "
            f"native FASTQ reader {'yes' if native else 'NO'} [{CARD}]")
    prof = read_profile(out)
    found = {s for s, n in prof.items() if n > 0}
    if found != want:
        raise AssertionError(f"(c) species: missed {sorted(want - found)}, "
                             f"spurious {sorted(found - want)}")
    for program in ("genes", "snps"):
        got = output_species(out, program)
        if got != want:
            raise AssertionError(f"(c) {program}: profiled {sorted(got)}, "
                                 f"community is {sorted(want)}")
    log(f"(c) species found {len(found)}/{len(want)} community species and "
        f"no other; genes and snps profiled exactly those")
    time_species_step(comm.db_dir, r1)


# --------------------------------------------------------------------------
# (d) GPU against CPU at the hermetic size
# --------------------------------------------------------------------------

HERMETIC_DB = dict(n_species=3, genome_len=12000, gene_len=600,
                   n_extra_genes=4, related_pairs=1, divergence=0.03, seed=0)

_CPU_CHILD = """
import sys
from chip_smoke import run_legs
run_legs(sys.argv[1], sys.argv[2], None, sys.argv[3], "0.1")
"""


def outputs(outdir: str, programs=("species", "genes", "snps")) -> dict:
    """{relative path: decompressed bytes} of the legs' output files."""
    files = []
    if "species" in programs:
        files.append("species/species_profile.txt")
    for program in programs:
        if program != "species":
            d = os.path.join(outdir, program, "output")
            files += [f"{program}/output/{f}" for f in sorted(os.listdir(d))]
    got = {}
    for rel in files:
        path = os.path.join(outdir, rel)
        with (gzip.open if path.endswith(".gz") else open)(path, "rb") as fh:
            got[rel] = fh.read()
    return got


def phase_cpu_identity(work: str):
    from midas_tpu.testkit import simulate_db, simulate_reads

    comm = simulate_db(os.path.join(work, "hdb"), **HERMETIC_DB)
    fq = os.path.join(work, "hreads.fq.gz")
    simulate_reads(comm, fq, n_reads=800, read_len=100,
                   abundances=[0.5, 0.3, 0.15, 0.05], error_rate=0.005,
                   seed=1)
    gpu_out, cpu_out = (os.path.join(work, d) for d in ("hgpu", "hcpu"))
    run_legs(comm.db_dir, fq, None, gpu_out, "0.1")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    child = subprocess.run(
        [sys.executable, "-c", _CPU_CHILD, comm.db_dir, fq, cpu_out],
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=900)
    if child.returncode != 0:
        raise RuntimeError(f"(d) CPU child failed:\n{child.stderr[-4000:]}")
    g, c = outputs(gpu_out), outputs(cpu_out)
    if g.keys() != c.keys():
        raise AssertionError(f"(d) output files differ: {sorted(g)} vs "
                             f"{sorted(c)}")
    diff = [k for k in g if g[k] != c[k]]
    if diff:
        raise AssertionError(f"(d) GPU and CPU outputs differ: {diff}")
    log(f"(d) {len(g)} output files of species/genes/snps byte-identical "
        f"(decompressed) between the GPU and a CPU-only child process")


# --------------------------------------------------------------------------
# --four: the multi-card drivers against the one-card run
# --------------------------------------------------------------------------

def phase_four(work: str):
    import jax

    from midas_tpu.dist.driver import (run_genes_multihost,
                                       run_snps_multihost,
                                       run_species_multihost)

    t0 = time.perf_counter()
    comm, r1, r2 = simulate(work, DB_SIZE, N_PAIRS, COMMUNITY)
    log(f"(4) simulated in {time.perf_counter() - t0:.3f} s (host set-up) "
        f"[{CARD}]")
    one = os.path.join(work, "one")
    stats = run_legs(comm.db_dir, r1, r2, one, SPECIES_COV)
    want = outputs(one)
    selected = sorted(output_species(one, "genes"))
    log(f"(4) one card: " + ", ".join(
        f"{p} {s['wall']:.3f} s" for p, s in stats.items())
        + f"; {len(selected)} species selected [{CARD}]")
    # the drivers with run_midas's defaults (cli/run_midas.py)
    kw = dict(paired=True, mapid=94.0, readq=20, aln_cov=0.75,
              max_read_len=160)
    legs = (("genes", run_genes_multihost, dict(mapq=0, mode="local")),
            ("snps", run_snps_multihost,
             dict(mapq=20, baseq=30, mode="global")))
    runs = [("species", "dp=4 x tp=1", lambda o: run_species_multihost(
        comm.db_dir, [r1, r2], outdir=o, tp=1, max_read_len=160))]
    for tp in (2, 4):
        for program, fn, own in legs:
            runs.append((program, f"dp={4 // tp} x tp={tp}",
                         lambda o, fn=fn, tp=tp, own=own: fn(
                             comm.db_dir, [r1, r2], selected, outdir=o,
                             tp=tp, **kw, **own)))
    for i, (program, mesh, fn) in enumerate(runs):
        out = os.path.join(work, f"four{i}")
        t0 = time.perf_counter()
        fn(out)
        wall = time.perf_counter() - t0
        got = outputs(out, (program,))
        ref = {k: v for k, v in want.items() if k.startswith(program)}
        if got != ref:
            raise AssertionError(f"(4) {program} at {mesh} differs from "
                                 f"the one-card run")
        log(f"(4) {program} over {len(jax.devices())} cards at {mesh}: "
            f"{len(got)} files byte-identical to one card; wall "
            f"{wall:.3f} s [{CARD}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-card drivers on four cards "
                         "and the one-card run they are compared with")
    args = ap.parse_args(argv)

    import jax

    from midas_tpu.runtime import setup_compile_cache

    setup_compile_cache()
    n = 4 if args.four else 1
    device = phase_device(n)
    work = tempfile.mkdtemp(prefix="midas_smoke_")
    try:
        if args.four:
            phase_four(work)
        else:
            clock = CompileClock()
            phase_dp()
            phase_legs(work, device, clock)
            phase_cpu_identity(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    d = jax.devices()[0]
    log(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
