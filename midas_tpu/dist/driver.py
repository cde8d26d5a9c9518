"""Multi-host data-parallel driving.

The reference never leaves one host (its concurrency is fork pools +
unix pipes, midas/utility.py:81-107); reads, though, are embarrassingly
parallel, so the multi-host design is pure DP over the read stream:

- every process joins the job via jax.distributed.initialize;
- each host streams a disjoint shard of the input FASTQ(s) — whole
  files round-robin when several files are given, batch striding over
  one file otherwise — and profiles it on its LOCAL chips (optionally
  with a local tp axis via DistributedSpeciesProfiler);
- the tiny per-species accumulators (unique counts/bp) and the
  ambiguous-read spill rows merge across hosts with one
  process_allgather at end of stream;
- the ambiguous-read RNG assignment then runs identically on every
  host (same seed, same merged row order: process-major, stream order
  within a process), so every host computes the same profile and rank
  0 writes it.

This keeps the per-batch path free of cross-host (DCN) traffic — the
only inter-host bytes are the end-of-stream accumulator merge.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize wrapper; no-op for single-process runs.
    Pass coordinator_address ("host:port"), num_processes and
    process_id explicitly where no cluster manager provides them."""
    import jax

    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address, num_processes, process_id)


def shard_read_paths(paths: Sequence[str], process_index: int,
                     process_count: int) -> List[str]:
    """Round-robin whole input files across hosts. With fewer files than
    hosts, callers should fall back to batch striding (stride_batches)."""
    paths = list(paths)
    if process_count <= 1 or len(paths) < process_count:
        return paths
    return paths[process_index::process_count]


def stride_batches(batches, process_index: int, process_count: int):
    """Every host parses the shared stream but keeps batch i where
    i % process_count == process_index (the native reader parses at
    ~1.3M reads/s, far above per-chip align throughput, so redundant
    parsing does not bound scaling until ~dozens of hosts; beyond that,
    split the input into per-host files). Each kept batch is tagged
    with its GLOBAL stream index — the ambiguous-read merge sorts
    spill rows back into single-process stream order with it."""
    for i, b in enumerate(batches):
        if i % process_count == process_index:
            try:
                b.global_index = i
            except AttributeError:   # non-batch items (unit tests)
                pass
            yield b


def merge_species_accumulators(
    unique_count: np.ndarray, unique_bp: np.ndarray,
    ambiguous: List, stats: Dict[str, int],
):
    """Cross-host merge of one host's species-classifier results.

    Uses jax.experimental.multihost_utils.process_allgather; a
    single-process run short-circuits to the inputs. Each ambiguous row
    carries its global stream rank (4th element) — the RNG assignment
    (SpeciesProfiler.assign_and_normalize) sorts the merged rows back
    into single-process stream order with it, so the sequential draws
    land on the same reads as a single-host run (byte-identity by
    construction; reference draw order: midas/run/species.py:104-119)."""
    import jax

    if jax.process_count() == 1:
        return unique_count, unique_bp, ambiguous, stats

    from jax.experimental import multihost_utils as mh

    g_count = np.asarray(mh.process_allgather(unique_count)).sum(axis=0)
    g_bp = np.asarray(mh.process_allgather(unique_bp)).sum(axis=0)
    # pack this host's ambiguous (seq, species, aln, ord) rows into
    # padded arrays
    n = len(ambiguous)
    width = max([len(t[1]) for t in ambiguous], default=1)
    n_max = int(np.asarray(mh.process_allgather(np.int64(n))).max())
    w_max = int(np.asarray(mh.process_allgather(np.int64(width))).max())
    sp = np.full((max(n_max, 1), w_max), -1, dtype=np.int64)
    bp = np.zeros((max(n_max, 1), w_max), dtype=np.float64)
    sq = np.zeros((max(n_max, 1), w_max), dtype=np.int64)
    od = np.zeros(max(n_max, 1), dtype=np.int64)
    for r, t in enumerate(ambiguous):
        q, s, a = t[0], t[1], t[2]
        sq[r, : len(q)] = q
        sp[r, : len(s)] = s
        bp[r, : len(a)] = a
        od[r] = t[3] if len(t) > 3 else r
    counts = np.asarray(mh.process_allgather(np.int64(n)))
    g_sp = np.asarray(mh.process_allgather(sp))    # [P, n_max, w]
    g_abp = np.asarray(mh.process_allgather(bp))
    g_sq = np.asarray(mh.process_allgather(sq))
    g_od = np.asarray(mh.process_allgather(od))
    merged = []
    for p in range(g_sp.shape[0]):
        for r in range(int(counts[p])):
            cols = np.flatnonzero(g_sp[p, r] >= 0)
            merged.append((g_sq[p, r, cols], g_sp[p, r, cols],
                           g_abp[p, r, cols], int(g_od[p, r])))
    g_stats = {
        k: int(np.asarray(mh.process_allgather(np.int64(v))).sum())
        for k, v in stats.items()
    }
    return g_count, g_bp, merged, g_stats


def _allgather_sum(x: np.ndarray) -> np.ndarray:
    """Elementwise sum of one per-host array across all processes."""
    from jax.experimental import multihost_utils as mh

    return np.asarray(mh.process_allgather(np.asarray(x))).sum(axis=0)


def _allgather_rows(rows: np.ndarray) -> np.ndarray:
    """Concatenate per-host row blocks process-major (rank 0's rows
    first), padding ragged counts — the cross-host twin of the gapped
    spill's stream-order append."""
    from jax.experimental import multihost_utils as mh

    n = rows.shape[0]
    counts = np.asarray(mh.process_allgather(np.int64(n)))
    n_max = int(counts.max())
    pad = np.zeros((max(n_max, 1),) + rows.shape[1:], dtype=rows.dtype)
    pad[:n] = rows
    g = np.asarray(mh.process_allgather(pad))   # [P, n_max, ...]
    return np.concatenate([g[p, : int(counts[p])] for p in range(len(counts))])


def _barrier(tag: str) -> None:
    """Cross-host barrier AFTER rank 0 writes outputs: without it a
    later pipeline stage on another rank can race the write on a shared
    filesystem (read a missing or torn species profile) while rank 0
    blocks in that stage's first collective."""
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils as mh

        mh.sync_global_devices(tag)


def _make_local_profiler(cls_single, cls_dist, db, species_ids, tp, kw):
    import jax

    if tp > 1 or len(jax.local_devices()) > 1:
        from midas_tpu.dist.sharded import make_mesh

        mesh = make_mesh(len(jax.local_devices()), tp=tp)
        return cls_dist(db, species_ids, mesh=mesh, **kw)
    return cls_single(db, species_ids, **kw)


def _stride_setup(prof, read_paths, pid, pcount, paired: bool = False,
                  max_reads=None, force_stride: bool = False):
    """Pick the per-host input sharding. File-granular sharding is only
    safe when the run is unpaired, uncapped, and has at least one file
    per host: paired inputs must never split (m1, m2) across ranks
    (each rank would then mispair consecutive reads of ONE mate file),
    and max_reads must cap the SHARED stream before striding (per-file
    caps would process up to pcount*max_reads reads and diverge from a
    single-process run). Everything else batch-strides the shared
    stream. force_stride skips file sharding entirely — species runs
    need every batch's GLOBAL stream index for the ambiguous-read
    stream-order merge, and with whole files per host batches do not
    align to any shared stream."""
    if (pcount > 1 and not paired and max_reads is None and not force_stride
            and len(read_paths) >= pcount):
        return shard_read_paths(read_paths, pid, pcount)
    if pcount > 1:
        prof._batch_filter = lambda bs: stride_batches(bs, pid, pcount)
    return list(read_paths)


def run_genes_multihost(
    db, read_paths, species_ids, outdir: Optional[str] = None,
    tp: int = 1, batch_size: int = 8192, max_reads: Optional[int] = None,
    trim: int = 0, paired: bool = False, interleaved: bool = False,
    read_length: Optional[int] = None,
    **profiler_kw,
) -> Dict:
    """Multi-host CNV profiling: every host streams a disjoint shard of
    the reads onto its local dp x tp mesh, then the tiny [G+1]
    aligned/mapped/bp accumulators merge with one end-of-stream
    process_allgather sum (the cross-host analogue of the reference's
    fork-pool reduction, midas/utility.py:81-107) — no per-batch DCN
    traffic. Every host computes the same results; rank 0 writes
    genes/output/*.genes.gz + summary.txt when outdir is given."""
    import jax

    from midas_tpu.db.layout import Database
    from midas_tpu.dist.profilers import DistributedGenesProfiler
    from midas_tpu.profile.genes import GenesProfiler

    if not isinstance(db, Database):
        db = Database(db)
    pid, pcount = jax.process_index(), jax.process_count()
    if isinstance(read_paths, str):
        read_paths = [read_paths]
    prof = _make_local_profiler(GenesProfiler, DistributedGenesProfiler,
                                db, species_ids, tp, profiler_kw)
    my_paths = _stride_setup(prof, read_paths, pid, pcount,
                             paired=paired, max_reads=max_reads)
    host = prof._accumulate(my_paths, max_reads, trim, batch_size,
                            paired=paired, interleaved=interleaved,
                            read_length=read_length)
    if pcount > 1:
        host = {k: _allgather_sum(v) for k, v in host.items()}
    results = prof._finalize(host)
    if outdir is not None and pid == 0:
        prof.write_results(outdir)
    _barrier("genes-outputs")
    return results


def run_snps_multihost(
    db, read_paths, species_ids, outdir: Optional[str] = None,
    tp: int = 1, batch_size: int = 8192, max_reads: Optional[int] = None,
    trim: int = 0, paired: bool = False, interleaved: bool = False,
    read_length: Optional[int] = None,
    **profiler_kw,
) -> Dict:
    """Multi-host SNP pileup: hosts stream disjoint read shards; at end
    of stream the [4 x G] count tensor and per-species counters merge
    with a process_allgather sum and the rare gapped-read spill rows
    concatenate process-major (scatter-adds commute, so row order only
    needs to be deterministic). Matches the reference's line-range
    shard merge (midas/merge/snps.py:366-386) with collectives instead
    of temp files. Rank 0 writes snps/output/*.snps.gz + summary.txt."""
    import jax

    from midas_tpu.db.layout import Database
    from midas_tpu.dist.profilers import DistributedSnpsProfiler
    from midas_tpu.profile.snps import SnpsProfiler

    if not isinstance(db, Database):
        db = Database(db)
    pid, pcount = jax.process_index(), jax.process_count()
    if isinstance(read_paths, str):
        read_paths = [read_paths]
    prof = _make_local_profiler(SnpsProfiler, DistributedSnpsProfiler,
                                db, species_ids, tp, profiler_kw)
    my_paths = _stride_setup(prof, read_paths, pid, pcount,
                             paired=paired, max_reads=max_reads)
    host = prof._accumulate(my_paths, max_reads, trim, batch_size,
                            paired=paired, interleaved=interleaved,
                            read_length=read_length)
    if pcount > 1:
        from midas_tpu.profile.device_steps import resolve_counts

        merged = dict(
            counts=_allgather_sum(resolve_counts(host["counts"])),
            aligned_reads=_allgather_sum(host["aligned_reads"]),
            mapped_reads=_allgather_sum(host["mapped_reads"]),
            gap_codes=_allgather_rows(host["gap_codes"]),
            gap_quals=_allgather_rows(host["gap_quals"]),
            gap_meta=_allgather_rows(host["gap_meta"]),
        )
        merged["gap_n"] = np.int64(merged["gap_codes"].shape[0])
        host = merged
    results = prof._finalize(host)
    if outdir is not None and pid == 0:
        prof.write_results(outdir)
    _barrier("snps-outputs")
    return results


def run_species_multihost(
    db, read_paths, outdir: Optional[str] = None,
    tp: int = 1, batch_size: int = 8192,
    read_length: Optional[int] = None, max_reads: Optional[int] = None,
    seed: int = 42, checkpoint_path: Optional[str] = None, **profiler_kw,
) -> Dict:
    """Species profile over every host's local chips; returns the
    abundance dict (identical on all hosts). Rank 0 writes
    species_profile.txt when outdir is given."""
    import jax

    from midas_tpu.db.layout import Database
    from midas_tpu.io.batch import load_read_batches
    from midas_tpu.profile.species import SpeciesProfiler, write_abundance

    if not isinstance(db, Database):
        db = Database(db)
    pid, pcount = jax.process_index(), jax.process_count()
    if isinstance(read_paths, str):
        read_paths = [read_paths]

    if tp > 1 or len(jax.local_devices()) > 1:
        # use every LOCAL chip (dp over the host's devices), not just
        # one — mirrors _make_local_profiler for genes/snps
        from midas_tpu.dist.sharded import make_mesh
        from midas_tpu.dist.species import DistributedSpeciesProfiler

        mesh = make_mesh(len(jax.local_devices()), tp=tp)
        prof = DistributedSpeciesProfiler(db, mesh=mesh, seed=seed,
                                          **profiler_kw)
    else:
        prof = SpeciesProfiler(db, seed=seed, **profiler_kw)

    my_paths = _stride_setup(prof, read_paths, pid, pcount,
                             max_reads=max_reads, force_stride=True)

    unique_count, unique_bp, ambiguous = prof._run_device(
        my_paths, read_length, max_reads, batch_size,
        checkpoint_path=checkpoint_path)
    unique_count, unique_bp, ambiguous, prof.stats = (
        merge_species_accumulators(unique_count, unique_bp, ambiguous,
                                   prof.stats))
    abundance = prof.assign_and_normalize(unique_count, unique_bp, ambiguous)
    if outdir is not None and jax.process_index() == 0:
        os.makedirs(os.path.join(outdir, "species/temp"), exist_ok=True)
        write_abundance(
            os.path.join(outdir, "species/species_profile.txt"), abundance)
        with open(os.path.join(outdir, "species/temp/read_count.txt"),
                  "w") as f:
            f.write(f"{prof.stats['total_reads']}\t"
                    f"{prof.stats['total_bp']}")
    _barrier("species-outputs")
    return abundance
