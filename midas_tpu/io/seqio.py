"""Sequence IO: FASTA/FASTQ streaming and 2-bit-style base encoding.

The replacement for the reference's read streamer
(/root/reference/midas/run/stream_seqs.py:10-65, a subprocess that
re-writes FASTQ to renamed FASTA on a unix pipe) and for
utility.iopen/parse_file (/root/reference/midas/utility.py:194-216).
Instead of piping text between processes, reads are parsed straight
into packed numpy arrays ready for device upload.

Base code convention used throughout the framework:
    A=0, C=1, G=2, T=3, anything else (N, IUPAC ambiguity)=4.
Code 4 is a sentinel that never matches during alignment and is also
used to pad both reads and reference sequences.
"""

from __future__ import annotations

import bz2 as _bz2
import gzip as _gzip
import io as _io
import os
from typing import IO, Iterator, Optional, Tuple

import numpy as np

N_CODE = 5  # alphabet size including sentinel
PAD_CODE = 4  # sentinel: never equal to any real base nor to itself in scoring

# Host-side translation tables (vectorized via np.frombuffer + take).
BASE_TO_CODE = np.full(256, PAD_CODE, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    BASE_TO_CODE[ord(_b)] = _i
    BASE_TO_CODE[ord(_b.lower())] = _i
CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# code -> complement code (sentinel maps to itself)
COMP_CODE = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def iopen(path: str, mode: str = "rt") -> IO:
    """Transparently open plain, .gz, or .bz2 files (utility.py:194-206)."""
    if path.endswith(".gz"):
        return _gzip.open(path, mode)
    if path.endswith(".bz2"):
        return _bz2.open(path, mode)
    return open(path, mode)


def parse_file(path: str) -> Iterator[dict]:
    """Yield dict per row of a tab-delimited file with a header line
    (utility.py:208-216)."""
    with iopen(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        for line in f:
            yield dict(zip(header, line.rstrip("\n").split("\t")))


def read_fastx(fp: IO) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Stream (name, seq, qual) records from FASTA or FASTQ.

    Same grammar as the lh3 readfq parser the reference embeds
    (stream_seqs.py:10-41): multi-line FASTA, 4-line or multi-line
    FASTQ, qual=None for FASTA. One deliberate divergence: readfq's
    blind `line[:-1]` drops the last base of a final line with no
    trailing newline; here (and in the native reader) the full line is
    kept — the newline-strip is explicit.
    """
    last = None
    while True:
        if not last:
            for line in fp:
                if line and line[0] in ">@":
                    last = line.rstrip("\n")
                    break
        if not last:
            break
        name, _, _ = last[1:].partition(" ")
        seqs, last = [], None
        for line in fp:
            if line and line[0] in "@+>":
                last = line.rstrip("\n")
                break
            seqs.append(line.rstrip("\n"))
        if not last or last[0] != "+":
            yield name, "".join(seqs), None
            if not last:
                break
        else:
            seq, leng, quals = "".join(seqs), 0, []
            for line in fp:
                q = line.rstrip("\n")
                quals.append(q)
                leng += len(q)
                if leng >= len(seq):
                    last = None
                    yield name, seq, "".join(quals)
                    break
            if last:
                yield name, seq, None
                break


def stream_reads(
    paths,
    read_length: Optional[int] = None,
    max_reads: Optional[int] = None,
) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Stream reads from one or more FASTA/FASTQ files, applying the
    reference's trim/filter semantics (stream_seqs.py:43-65):

    - if read_length is set, drop reads shorter than it and truncate
      longer reads to exactly read_length;
    - stop after max_reads reads total (across files).
    """
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    emitted = 0
    for path in paths:
        with iopen(str(path)) as fp:
            for name, seq, qual in read_fastx(fp):
                if read_length is not None:
                    if len(seq) < read_length:
                        continue
                    seq = seq[:read_length]
                    if qual is not None:
                        qual = qual[:read_length]
                yield name, seq, qual
                emitted += 1
                if max_reads is not None and emitted >= max_reads:
                    return


def encode_seq(seq: str) -> np.ndarray:
    """Encode an ASCII sequence into int8 codes (A0 C1 G2 T3 other 4)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return BASE_TO_CODE[raw]


def decode_seq(codes: np.ndarray) -> str:
    """Decode int8 codes back to an ASCII string (4 -> 'N')."""
    return CODE_TO_BASE[np.asarray(codes, dtype=np.int64)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space (utility.py:302-304 equivalent)."""
    return COMP_CODE[np.asarray(codes, dtype=np.int64)][::-1]


def qual_to_phred(qual: Optional[str], n: int) -> np.ndarray:
    """ASCII qual string -> phred scores (offset 33); FASTA reads get a
    high default so they pass all quality filters (matching how the
    reference treats FASTA input: no qualities -> no quality filtering)."""
    if qual is None:
        return np.full(n, 40, dtype=np.int8)
    raw = np.frombuffer(qual.encode("ascii"), dtype=np.uint8)
    return (raw.astype(np.int16) - 33).astype(np.int8)
