"""Split FASTQ/FASTA input into per-host shard files.

Multi-host batch striding re-parses the WHOLE stream on every host
(dist/driver.stride_batches — fine at a few hosts, where the native
parser outruns each host's device), so beyond that the inputs should be
split into one file per host and passed host-locally. This utility is
that escape hatch, kept record-exact:

    python -m midas_tpu.cli.split_reads reads.fq.gz -n 16 -o shards/

writes shards/reads.part00.fq.gz ... part15.fq.gz with records dealt
round-robin (record i -> shard i % n, matching stride_batches' batch
round-robin at batch_size 1 — the species stream-order merge keys on
the GLOBAL index either way, so sharded runs stay byte-identical).
Paired runs must split -1 and -2 with the same -n so mates stay
aligned; --paired splits an interleaved file by PAIRS."""

from __future__ import annotations

import argparse
import gzip
import os
import sys
from typing import IO, List


def _opener(path: str, mode: str) -> IO:
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode)


def _records(fp: IO):
    """Raw record blocks (header line + body lines), byte-preserving:
    FASTQ 4-line records or FASTA multi-line records."""
    first = fp.readline()
    if not first:
        return
    if first.startswith("@"):
        while first:
            lines = [first, fp.readline(), fp.readline(), fp.readline()]
            if not lines[3]:
                raise ValueError("truncated FASTQ record at end of file")
            yield "".join(lines)
            first = fp.readline()
    elif first.startswith(">"):
        header, body = first, []
        for line in fp:
            if line.startswith(">"):
                yield header + "".join(body)
                header, body = line, []
            else:
                body.append(line)
        yield header + "".join(body)
    else:
        raise ValueError("input is neither FASTQ (@) nor FASTA (>)")


def split_reads(path: str, n: int, outdir: str,
                paired: bool = False) -> List[str]:
    os.makedirs(outdir, exist_ok=True)
    base = os.path.basename(path)
    for ext in (".gz", ".fq", ".fastq", ".fa", ".fasta"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    suffix = ".fq.gz" if (".fq" in path or ".fastq" in path
                          or path.endswith(".gz")) else ".fa"
    outs = [os.path.join(outdir, f"{base}.part{i:02d}{suffix}")
            for i in range(n)]
    sinks = [_opener(p, "w") for p in outs]
    group = 2 if paired else 1
    try:
        with _opener(path, "r") as fp:
            for i, rec in enumerate(_records(fp)):
                sinks[(i // group) % n].write(rec)
    finally:
        for s in sinks:
            s.close()
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="split_reads",
        description="Split FASTQ/FASTA into per-host shards (round-robin "
                    "records) for multi-host runs beyond the batch-striding "
                    "sweet spot.")
    ap.add_argument("input", help="FASTQ/FASTA file, optionally .gz")
    ap.add_argument("-n", type=int, required=True, help="number of shards")
    ap.add_argument("-o", "--outdir", default=".", help="output directory")
    ap.add_argument("--paired", action="store_true",
                    help="input is interleaved; keep mate pairs together")
    args = ap.parse_args(argv)
    outs = split_reads(args.input, args.n, args.outdir, paired=args.paired)
    for p in outs:
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
