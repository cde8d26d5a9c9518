"""SNP pileup profiling — the device version of midas/run/snps.py.

Reads are aligned end-to-end (glocal) against a per-run pack of the
selected species' representative genomes (replacing build_genome_db +
bowtie2 global mode + samtools sort at snps.py:69-128). The pysam
count_coverage pileup (:164-216) becomes a vectorized scatter-add of
base counts: each kept read contributes its bases at the reference
positions given by its alignment column map, masked by base quality
>= baseq. Gapless reads (the overwhelming majority) have a closed-form
column map; gapped reads fall back to the exact oracle traceback.

Output contract: per-species <outdir>/snps/output/<sp>.snps.gz with one
row per genomic position (ref_id, ref_pos 1-based, ref_allele, depth,
count_a, count_c, count_g, count_t) over contigs in sorted id order,
plus snps/summary.txt (snps_summary :247-262).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from midas_tpu.align.oracle import align_oracle_batch
from midas_tpu.align.params import GLOBAL_SCORING, LOCAL_SCORING
from midas_tpu.align.pipeline import Aligner
from midas_tpu.align.seed import SeedParams
from midas_tpu.db.index import build_seed_index
from midas_tpu.db.layout import Database
from midas_tpu.db.refpack import pack_from_fasta
from midas_tpu.io.batch import load_read_batches
from midas_tpu.io.seqio import CODE_TO_BASE, iopen
from midas_tpu.profile.common import resolve_species_list, select_batches


class SnpsProfiler:
    def __init__(
        self,
        db: Database,
        species_ids: List[str],
        mapid: float = 94.0,
        readq: float = 20.0,
        mapq: int = 20,
        baseq: int = 30,
        aln_cov: float = 0.75,
        seed_params: Optional[SeedParams] = None,
        max_read_len: int = 128,
        mode: str = "global",
    ):
        self.db = db
        self.species_ids = list(species_ids)
        self.mapid, self.readq, self.mapq = mapid, readq, mapq
        # the reference's -m global/local flag (global default for
        # rep-genome SNP mapping, midas/run/snps.py:97-128)
        self.mode = mode
        self.baseq, self.aln_cov = baseq, aln_cov
        self.pack = pack_from_fasta([db.rep_genome_fasta(s) for s in self.species_ids])
        # contig -> species from per-file contig counts
        self.contig_species = np.zeros(self.pack.num_seqs, dtype=np.int32)
        cursor = 0
        for si, s in enumerate(self.species_ids):
            n = _count_fasta_records(db.rep_genome_fasta(s))
            self.contig_species[cursor: cursor + n] = si
            cursor += n
        assert cursor == self.pack.num_seqs
        sp = seed_params or SeedParams(num_cands=4)
        self.index = build_seed_index(self.pack, k=sp.k)
        scoring = GLOBAL_SCORING if mode == "global" else LOCAL_SCORING
        self.aligner = Aligner(self.pack, self.index, scoring, sp,
                               max_read_len=max_read_len)

    def run(self, read_paths, max_reads=None, trim=0, batch_size: int = 8192,
            gap_cap: Optional[int] = None, checkpoint_path=None,
            align_only: bool = False, paired: bool = False,
            interleaved: bool = False, read_length=None) -> Dict:
        """Device-resident pileup: gapless kept reads scatter-add their
        base one-hots into a [4, G] device count tensor
        (profile.device_steps.snps_update, donated each batch); the rare
        gapped reads spill to a device buffer and get the exact oracle
        traceback on host once, after the stream ends. Batches
        parse+upload in a background thread; with checkpoint_path the
        state persists periodically (crash recovery + the reference's
        --align / --pileup stage split)."""
        host = self._accumulate(read_paths, max_reads, trim, batch_size,
                                gap_cap, checkpoint_path, paired=paired,
                                interleaved=interleaved,
                                read_length=read_length)
        if align_only:
            return None
        return self._finalize(host)

    def _accumulate(self, read_paths, max_reads, trim, batch_size,
                    gap_cap=None, checkpoint_path=None,
                    checkpoint_every: int = 64, paired: bool = False,
                    interleaved: bool = False, read_length=None) -> Dict:
        import dataclasses as _dc

        import jax.numpy as jnp

        from midas_tpu.io.prefetch import prefetch_device_batches
        from midas_tpu.profile import checkpoint as ckpt
        from midas_tpu.profile import device_steps as ds

        G = self.pack.total_len
        S = len(self.species_ids)
        al = self.aligner
        L = al.max_read_len
        # STAGING capacity, not a hard cap: the gapped-read buffer
        # drains to host whenever the worst-case row count since the
        # last drain approaches it (same policy as the species
        # ambiguous spill), so any number of gapped reads completes
        # without tuning MIDAS_TPU_GAP_CAP
        cap = gap_cap or int(os.environ.get("MIDAS_TPU_GAP_CAP", "131072"))
        cap = max(cap, 2 * batch_size)   # a drain must always fit a batch
        state = ds.snps_init(G, S, cap, L)
        contig_species = jnp.asarray(self.contig_species)
        skip = 0
        fp = None
        drained: List[Dict[str, np.ndarray]] = []   # host gap rows

        def drain(state):
            spill, n = ds.sliced_spill_host(
                dict(gap_codes=state.gap_codes, gap_quals=state.gap_quals,
                     gap_meta=state.gap_meta), state.gap_n, cap)
            if n > cap:
                raise RuntimeError(
                    f"gapped spill staging overflow ({n} > {cap}); "
                    "cap must exceed the per-drain row bound")
            if n:
                drained.append(spill)
            return _dc.replace(state, gap_n=jnp.zeros((), jnp.int32))

        def gap_rows() -> Dict[str, np.ndarray]:
            if not drained:
                return dict(gap_codes=np.full((0, L), 4, np.int8),
                            gap_quals=np.zeros((0, L), np.int8),
                            gap_meta=np.zeros((0, 4), np.int32))
            return {k: np.concatenate([d[k] for d in drained])
                    for k in ("gap_codes", "gap_quals", "gap_meta")}

        if checkpoint_path:
            fp = ckpt.fingerprint(
                kind="snps", schema=2,  # 2: quality-scaled --mp/--np
                paths=list(map(str, np.atleast_1d(read_paths))),
                max_reads=max_reads, trim=trim, batch_size=batch_size,
                mapid=self.mapid, readq=self.readq, mapq=self.mapq,
                baseq=self.baseq, aln_cov=self.aln_cov, cap=cap,
                species=self.species_ids, paired=paired,
                interleaved=interleaved, read_length=read_length)
            got = ckpt.load(checkpoint_path, fp)
            if got is not None:
                arrays, meta = got
                # counters/counts restore to device; checkpointed gap
                # rows stay HOST-side (they may exceed the staging
                # capacity), exactly like the species amb restore
                st0 = ds.snps_init(G, S, cap, L)
                state = _dc.replace(
                    st0,
                    counts=jnp.asarray(arrays["counts"]),
                    aligned_reads=jnp.asarray(arrays["aligned_reads"]),
                    mapped_reads=jnp.asarray(arrays["mapped_reads"]))
                if arrays["gap_codes"].shape[0]:
                    drained.append({k: arrays[k] for k in
                                    ("gap_codes", "gap_quals", "gap_meta")})
                skip = int(meta["batches_done"])

        last_index = skip - 1
        rows_bound = 0   # worst-case spill rows since the last drain
        batches = select_batches(read_paths, batch_size, L, max_reads,
                                 paired, interleaved,
                                 read_length=read_length)
        if getattr(self, "_batch_filter", None):
            batches = self._batch_filter(batches)  # multi-host striding
        for db in prefetch_device_batches(
                batches, ("codes", "quals", "lengths", "mean_qual"),
                trim=trim, skip_batches=skip):
            last_index = db.index
            codes, quals, lengths, mean_qual, n_reads = db.arrays
            state = ds.snps_update(
                state, al.index_arrays, al.pack_arrays,
                contig_species, codes, quals, lengths, mean_qual, n_reads,
                scoring=al.scoring, seed_params=al.seed_params,
                max_len=L, mapid=float(self.mapid), readq=float(self.readq),
                min_mapq=int(self.mapq), baseq=int(self.baseq),
                aln_cov=float(self.aln_cov), paired=bool(paired))
            rows_bound += db.n_reads
            if rows_bound > cap - batch_size:
                state = drain(state)
                rows_bound = 0
            if checkpoint_path and (db.index + 1) % checkpoint_every == 0:
                state = drain(state)
                rows_bound = 0
                h = ds.snps_state_host(state)
                rows = gap_rows()
                h.update(rows)
                h["gap_n"] = np.int64(rows["gap_codes"].shape[0])
                ckpt.save(checkpoint_path, h,
                          dict(fingerprint=fp, batches_done=db.index + 1,
                               guard=self._guard()))
        # end-of-stream snapshot: the counts transfer rides a background
        # thread so _finalize's host oracle work overlaps it
        state = drain(state)
        host = ds.snps_state_host(state, counts_async=True)
        rows = gap_rows()
        host.update(rows)
        host["gap_n"] = np.int64(rows["gap_codes"].shape[0])
        if checkpoint_path:
            host["counts"] = ds.resolve_counts(host["counts"])
            ckpt.save(checkpoint_path, host,
                      dict(fingerprint=fp, batches_done=last_index + 1,
                           guard=self._guard()))
        return host

    def _guard(self) -> Dict:
        """Finalize-relevant params persisted in checkpoint meta (see
        checkpoint.load_guarded)."""
        return dict(kind="snps", mapid=self.mapid, readq=self.readq,
                    mapq=self.mapq, baseq=self.baseq, aln_cov=self.aln_cov,
                    mode=self.mode,
                    species=list(self.species_ids),
                    total_len=int(self.pack.total_len))

    def finalize_from_checkpoint(self, checkpoint_path,
                                 force: bool = False) -> Dict:
        """--pileup without --align (the reference's equivalent reads
        temp/genomes.bam, scripts/run_midas.py:567-604), erroring when
        the state was written under different filter params / species /
        pack geometry."""
        from midas_tpu.profile import checkpoint as ckpt

        got = ckpt.load_guarded(checkpoint_path, self._guard(), force=force)
        if got is None:
            sys.exit(f"\nError: no usable alignment state at {checkpoint_path}\n"
                     "Run with --align first\n")
        return self._finalize(got[0])

    def _finalize(self, host: Dict) -> Dict:
        from midas_tpu.profile import device_steps as ds

        G = self.pack.total_len
        S = len(self.species_ids)
        aligned_reads = np.asarray(host["aligned_reads"][:S]).astype(np.int64)
        mapped_reads = np.asarray(host["mapped_reads"][:S]).astype(np.int64)

        # exact host traceback for the spilled gapped reads — batched
        # wavefront oracle (align_oracle_batch): the scalar per-read DP
        # costs ~25 ms each and dominated end-of-stream time. Runs
        # BEFORE resolving the counts transfer so the oracle DP
        # overlaps the (possibly still in-flight) D2H pull.
        n_gapped = int(host["gap_n"])
        gap_codes = np.asarray(host["gap_codes"])
        gap_quals = np.asarray(host["gap_quals"])
        gap_meta = np.asarray(host["gap_meta"])
        queries, windows, los, qpens = [], [], [], []
        scoring = self.aligner.scoring
        for r in range(gap_codes.shape[0]):
            ci, tstart, tend, qlen = (int(x) for x in gap_meta[r])
            seq_lo = int(self.pack.offsets[ci])
            lo = max(seq_lo + tstart - 8, 0)
            hi = min(seq_lo + tend + 8, G)
            queries.append(gap_codes[r, :qlen])
            windows.append(self.pack.codes[lo:hi])
            los.append(lo)
            if scoring.qual_scaled:
                # the spilled quals are already strand-adjusted like the
                # codes; same --mp table the device DP scored with
                q = np.minimum(gap_quals[r, :qlen].astype(np.int64), 40)
                mx, mn = -scoring.mismatch, scoring.mm_min
                qpens.append(mn + ((mx - mn) * q) // 40)
        adds = []
        for r, a in enumerate(align_oracle_batch(
                queries, windows, scoring,
                qpens=qpens if scoring.qual_scaled else None)):
            qlen = len(queries[r])
            m = a.qpos_to_tpos(qlen)
            qpos = np.flatnonzero(m >= 0)
            tpos = los[r] + m[qpos]
            base = gap_codes[r, qpos]
            mask = (gap_quals[r, qpos] >= self.baseq) & (base < 4)
            adds.append((base[mask], tpos[mask]))
        counts = ds.resolve_counts(host["counts"])
        counts = counts.reshape(4, G + 1)[:, :G].copy()
        for base, tpos in adds:
            np.add.at(counts, (base, tpos), 1)

        self.counts = counts
        self.stats = dict(aligned_reads=aligned_reads, mapped_reads=mapped_reads,
                          n_gapped=n_gapped)
        return dict(counts=counts, **self.stats)

    def write_results(self, outdir: str) -> Dict[str, dict]:
        """Per-species .snps.gz over every genomic site + summary.txt."""
        os.makedirs(os.path.join(outdir, "snps/output"), exist_ok=True)
        depth_all = self.counts.sum(axis=0)
        summaries = {}
        for si, sid in enumerate(self.species_ids):
            path = os.path.join(outdir, f"snps/output/{sid}.snps.gz")
            genome_length = covered = total_depth = 0
            with iopen(path, "wt") as f:
                f.write("\t".join(["ref_id", "ref_pos", "ref_allele", "depth",
                                   "count_a", "count_c", "count_g", "count_t"]) + "\n")
                contig_ids = [ci for ci in range(self.pack.num_seqs)
                              if self.contig_species[ci] == si]
                # reference iterates contigs in sorted id order (snps.py:185)
                contig_ids.sort(key=lambda ci: self.pack.names[ci])
                for ci in contig_ids:
                    lo, hi = int(self.pack.offsets[ci]), int(self.pack.offsets[ci + 1])
                    name = self.pack.names[ci]
                    alleles = CODE_TO_BASE[self.pack.codes[lo:hi].astype(np.int64)]
                    d = depth_all[lo:hi]
                    a, cc, g, t = (self.counts[j, lo:hi] for j in range(4))
                    rows = "\n".join(
                        f"{name}\t{p + 1}\t{chr(alleles[p])}\t{d[p]}\t{a[p]}\t{cc[p]}\t{g[p]}\t{t[p]}"
                        for p in range(hi - lo)
                    )
                    if hi > lo:
                        f.write(rows + "\n")
                    genome_length += hi - lo
                    covered += int((d > 0).sum())
                    total_depth += int(d.sum())
            summaries[sid] = dict(
                genome_length=genome_length,
                covered_bases=covered,
                fraction_covered=covered / float(genome_length) if genome_length else 0,
                mean_coverage=total_depth / float(covered) if covered else 0,
                aligned_reads=int(self.stats["aligned_reads"][si]),
                mapped_reads=int(self.stats["mapped_reads"][si]),
            )
        with open(os.path.join(outdir, "snps/summary.txt"), "w") as f:
            fields = ["species_id", "genome_length", "covered_bases",
                      "fraction_covered", "mean_coverage", "aligned_reads",
                      "mapped_reads"]
            f.write("\t".join(fields) + "\n")
            for sid in self.species_ids:
                s = summaries[sid]
                f.write("\t".join(str(x) for x in [
                    sid, s["genome_length"], s["covered_bases"],
                    s["fraction_covered"], s["mean_coverage"],
                    s["aligned_reads"], s["mapped_reads"]]) + "\n")
        return summaries


def _count_fasta_records(path: str) -> int:
    from midas_tpu.io.seqio import read_fastx
    with iopen(path) as fp:
        return sum(1 for _ in read_fastx(fp))


def run_snps(args: Dict) -> SnpsProfiler:
    """Pipeline driver with the reference output layout and per-stage
    timing/memory prints (snps.py:268-305)."""
    from midas_tpu.utils import stage_timer

    outdir = args["outdir"]
    log = args.get("log")
    os.makedirs(os.path.join(outdir, "snps/temp"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "snps/output"), exist_ok=True)
    db = Database(args["db"])
    species_ids = resolve_species_list(args, db, "snps")
    if not species_ids:
        sys.exit("\nError: no species satisfied your selection criteria.\n"
                 "Try running with more lenient parameters "
                 "(e.g. --species_cov, --species_topn, or --species_id)")
    if args.get("build_db") and not (args.get("align") or args.get("call")):
        return None
    from midas_tpu.io.batch import detect_max_read_len

    state_path = os.path.join(outdir, "snps/temp/state.npz")
    scan_paths = [p for p in (args.get("m1"), args.get("m2")) if p]

    import jax

    if jax.process_count() > 1:
        # multi-host job: the distributed driver always runs the FULL
        # align+pileup pipeline; stage splits / checkpoints are
        # single-host features and partial invocations error out
        if not (args.get("build_db") and args.get("align")
                and args.get("call")):
            sys.exit("\nError: multi-host snps runs the full pipeline; "
                     "--build_db/--align/--pileup stage splits are "
                     "single-host features\n")
        from midas_tpu.dist.driver import run_snps_multihost

        paired = bool(args.get("m2")) or bool(args.get("interleaved"))
        with stage_timer(
                f"Pileup over {jax.process_count()} hosts", log):
            run_snps_multihost(
                db, scan_paths, species_ids, outdir=outdir,
                max_reads=args.get("max_reads"), trim=args.get("trim", 0),
                paired=paired, interleaved=bool(args.get("interleaved")),
                read_length=args.get("read_length"),
                mapid=args.get("mapid", 94.0), readq=args.get("readq", 20.0),
                mapq=args.get("mapq", 20), baseq=args.get("baseq", 30),
                aln_cov=args.get("aln_cov", 0.75),
                mode=args.get("mode", "global"),
                max_read_len=detect_max_read_len(scan_paths,
                                                 args.get("read_length")))
        return None

    with stage_timer("Building genome database", log):
        profiler = SnpsProfiler(
            db, species_ids,
            mapid=args.get("mapid", 94.0), readq=args.get("readq", 20.0),
            mapq=args.get("mapq", 20), baseq=args.get("baseq", 30),
            aln_cov=args.get("aln_cov", 0.75),
            mode=args.get("mode", "global"),
            max_read_len=detect_max_read_len(scan_paths,
                                             args.get("read_length"))
            if scan_paths else 128,
        )
    if args.get("align") or args.get("build_db"):
        paths = [args["m1"]]
        if args.get("m2"):
            paths.append(args["m2"])
        paired = bool(args.get("m2")) or bool(args.get("interleaved"))
        with stage_timer("Aligning reads to representative genomes", log):
            profiler.run(paths, max_reads=args.get("max_reads"),
                         trim=args.get("trim", 0),
                         paired=paired,
                         interleaved=bool(args.get("interleaved")),
                         read_length=args.get("read_length"),
                         checkpoint_path=state_path,
                         align_only=not args.get("call"))
        if not args.get("call"):
            return profiler
        with stage_timer("Counting alleles", log):
            profiler.write_results(outdir)
    elif args.get("call"):
        with stage_timer("Counting alleles", log):
            profiler.finalize_from_checkpoint(state_path, force=bool(args.get("force")))
            profiler.write_results(outdir)
    if args.get("remove_temp"):
        import shutil
        shutil.rmtree(os.path.join(outdir, "snps/temp"))
    return profiler
