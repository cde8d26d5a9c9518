"""K-mer seed index: bucketed hash tables that replace the FM-indexes of
bowtie2-build and `hs-blastn index` (reference invocation sites:
midas/run/genes.py:108-114, midas/run/snps.py:89-95,
midas/build/build_db.py:449-456).

Design, driven by gather economics (an XLA row gather of a 2D array
costs about the same as ONE element gather per row, for narrow rows):

- **Bucketed hash table.** 8 slots per bucket; a bucket row packs
  [keys x8 | start_row x8 | count x8] into 24 int32 columns, so one
  row gather returns everything needed to resolve a k-mer. Keys that
  overflow their bucket go to a second-level table with a re-salted
  hash (queried with one more row gather); second-level overflow
  doubles that table and rebuilds (rare: level-1 load is 4/8).
- **Row-aligned position runs.** Each k-mer's positions are laid out
  starting at an 8-element row boundary of a [rows, 8] array, so the
  query side gathers whole rows of hits instead of single positions
  (8x fewer gathers, identical information; pad waste is < 7 slots per
  distinct k-mer).

Build is host-side vectorized numpy (no Python per-kmer loops).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from midas_tpu.db.refpack import ReferencePack

EMPTY_KEY = np.uint32(0xFFFFFFFF)
BUCKET_SLOTS = 8
ROW = 8              # positions2d row width (ROW=16 measured: no
#                      gather speedup — the cost scales with gathered
#                      elements, not rows — and ~30% more index padding)
LEVEL2_SALT = np.uint32(0x9E3779B9)


def fmix32(h: np.ndarray) -> np.ndarray:
    """MurmurHash3 32-bit finalizer (public-domain mixing constants)."""
    h = np.asarray(h, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return h


@dataclasses.dataclass
class SeedIndex:
    """Two-level bucketed k-mer hash table over a ReferencePack.

    bucket rows: [NB, 24] int32 — columns 0-7 keys (EMPTY_KEY where
    unoccupied, stored bit-cast to int32), 8-15 start rows into
    positions2d, 16-23 position counts."""

    k: int
    bucket1: np.ndarray      # [NB1, 24] int32
    bucket2: np.ndarray      # [NB2, 24] int32
    positions2d: np.ndarray  # [R, ROW] int32, k-mer runs row-aligned

    @property
    def table_size(self) -> int:
        return (len(self.bucket1) + len(self.bucket2)) * BUCKET_SLOTS

    @property
    def positions(self) -> np.ndarray:
        """All indexed positions (host-side, for tests/debugging)."""
        out = []
        for tbl in (self.bucket1, self.bucket2):
            keys = tbl[:, :BUCKET_SLOTS].reshape(-1).view(np.uint32)
            srow = tbl[:, BUCKET_SLOTS:2 * BUCKET_SLOTS].reshape(-1)
            cnt = tbl[:, 2 * BUCKET_SLOTS:].reshape(-1)
            for s, c in zip(srow[keys != EMPTY_KEY], cnt[keys != EMPTY_KEY]):
                out.append(self.positions2d.reshape(-1)[s * ROW: s * ROW + c])
        if not out:
            return np.zeros(0, dtype=np.int32)
        return np.concatenate(out)

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, k=self.k, bucket1=self.bucket1, bucket2=self.bucket2,
            positions2d=self.positions2d,
        )

    @staticmethod
    def load(path: str) -> "SeedIndex":
        z = np.load(path)
        return SeedIndex(k=int(z["k"]), bucket1=z["bucket1"],
                         bucket2=z["bucket2"], positions2d=z["positions2d"])


def pack_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """2-bit pack every k-mer starting position: [len(codes)-k+1] uint32.

    Positions whose window contains a sentinel base are set to EMPTY_KEY.
    """
    codes = np.asarray(codes)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    kmers = np.zeros(n, dtype=np.uint32)
    valid = np.ones(n, dtype=bool)
    for i in range(k):
        c = codes[i: i + n]
        kmers = (kmers << np.uint32(2)) | (c.astype(np.uint32) & np.uint32(3))
        valid &= c < 4
    kmers[~valid] = EMPTY_KEY
    return kmers


def _fill_buckets(
    keys: np.ndarray, start_row: np.ndarray, count: np.ndarray,
    nb: int, salt: np.uint32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Place keys into an [nb, 24] bucket table; returns (table,
    overflow mask of keys that did not fit their bucket)."""
    table = np.empty((nb, 3 * BUCKET_SLOTS), dtype=np.int32)
    table[:, :BUCKET_SLOTS] = np.int32(-1)  # EMPTY_KEY bit pattern
    table[:, BUCKET_SLOTS:] = 0
    if not len(keys):
        return table, np.zeros(0, dtype=bool)
    with np.errstate(over="ignore"):
        b = (fmix32(keys ^ salt) & np.uint32(nb - 1)).astype(np.int64)
    order = np.argsort(b, kind="stable")
    bs = b[order]
    first = np.searchsorted(bs, bs, side="left")
    rank = np.arange(len(bs)) - first
    fits = rank < BUCKET_SLOTS
    bi = bs[fits]
    ri = rank[fits]
    src = order[fits]
    table[bi, ri] = keys[src].view(np.int32)
    table[bi, BUCKET_SLOTS + ri] = start_row[src]
    table[bi, 2 * BUCKET_SLOTS + ri] = count[src]
    overflow = np.zeros(len(keys), dtype=bool)
    overflow[order[~fits]] = True
    return table, overflow


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(x, 1)))))


def build_seed_index(
    pack: ReferencePack,
    k: int = 14,
    max_occ: int = 256,
    min_table_size: int = 64,
    min_buckets2: int = 8,
) -> SeedIndex:
    """Build the bucketed index from a ReferencePack.

    max_occ caps hits per k-mer (repetitive-seed masking, same idea as
    minimap2's repeat filtering): positions beyond the cap are dropped at
    build time so query-side gather counts stay bounded.
    """
    if not 4 <= k <= 15:
        raise ValueError("k must be in [4, 15] so kmers fit uint32 below EMPTY_KEY")
    if pack.total_len >= 2**31:
        raise ValueError("pack too large for int32 positions; shard it first")
    kmers = pack_kmers(pack.codes[: pack.total_len], k)
    # Mask windows that cross sequence boundaries.
    ends = pack.offsets[1:]
    pos = np.arange(len(kmers), dtype=np.int64)
    seq_idx = np.searchsorted(pack.offsets, pos, side="right") - 1
    in_seq = pos + k <= ends[seq_idx]
    del seq_idx, ends
    valid = (kmers != EMPTY_KEY) & in_seq
    vpos = pos[valid].astype(np.int32)
    vkmers = kmers[valid]
    # Sort positions by kmer; ties keep ascending position (stable).
    order = np.argsort(vkmers, kind="stable")
    vkmers = vkmers[order]
    vpos = vpos[order]
    uniq, start, count = np.unique(vkmers, return_index=True, return_counts=True)
    count = np.minimum(count, max_occ).astype(np.int32)

    # Row-aligned positions layout: run i occupies rows
    # [start_row[i], start_row[i] + ceil(count[i]/ROW)).
    U = len(uniq)
    nrows_per = -(-count // ROW)
    start_row = np.zeros(U, dtype=np.int64)
    np.cumsum(nrows_per[:-1], out=start_row[1:])
    total_rows = int(start_row[-1] + nrows_per[-1]) if U else 0
    if total_rows * ROW >= 2**31:
        raise ValueError("position table too large for int32 rows; shard it")
    flat = np.zeros(max(total_rows, 1) * ROW, dtype=np.int32)
    if U:
        cnt_off = np.zeros(U + 1, dtype=np.int64)
        np.cumsum(count, out=cnt_off[1:])
        within = (np.arange(cnt_off[-1], dtype=np.int64)
                  - np.repeat(cnt_off[:-1], count))     # [0, count_i) per run
        src = np.repeat(start, count) + within           # first count_i of each
        dest = np.repeat(start_row, count) * ROW + within
        flat[dest] = vpos[src]
    positions2d = flat.reshape(-1, ROW)

    # Level 1 at average load 4/8; overflow to level 2, which doubles
    # until every overflow key fits.
    nb1 = max(_pow2_at_least(-(-U // 4)),
              _pow2_at_least(-(-min_table_size // BUCKET_SLOTS)))
    bucket1, over = _fill_buckets(
        uniq, start_row.astype(np.int32), count, nb1, np.uint32(0))
    k2 = uniq[over]
    s2 = start_row.astype(np.int32)[over]
    c2 = count[over]
    nb2 = max(min_buckets2, _pow2_at_least(-(-max(len(k2), 1) // 2)))
    while True:
        bucket2, over2 = _fill_buckets(k2, s2, c2, nb2, LEVEL2_SALT)
        if not over2.any():
            break
        nb2 *= 2
    return SeedIndex(k=k, bucket1=bucket1, bucket2=bucket2,
                     positions2d=positions2d)


def lookup_host(index: SeedIndex, kmer: int) -> np.ndarray:
    """Host-side single-kmer lookup (tests / debugging)."""
    km = np.uint32(kmer)
    flat = index.positions2d.reshape(-1)
    for tbl, salt in ((index.bucket1, np.uint32(0)),
                      (index.bucket2, LEVEL2_SALT)):
        nb = len(tbl)
        with np.errstate(over="ignore"):
            b = int(fmix32(km ^ salt) & np.uint32(nb - 1))
        row = tbl[b]
        for s in range(BUCKET_SLOTS):
            if np.uint32(row[s]) == km:
                sr, c = row[BUCKET_SLOTS + s], row[2 * BUCKET_SLOTS + s]
                return flat[sr * ROW: sr * ROW + c]
    return np.zeros(0, dtype=np.int32)
