"""Seed-and-vote candidate generation (pure JAX, runs under jit).

Replaces the seeding half of bowtie2 / hs-blastn: query k-mers at a
fixed stride are looked up in the hashed SeedIndex (db/index.py), every
hit votes for an alignment diagonal (ref_pos - query_pos), and the
top-C diagonals per read by vote count become banded-extension
candidates. Both strands are searched by seeding the reverse-complement
read (the reference gets this from the aligner binaries implicitly).

Layout notes (the design choices; whether each still pays on the GPU
against the plain gather or sort is open, see ROADMAP.md):

- Hash probing is ONE parallel gather of all PROBE_WINDOW candidate
  slots (the index build bounds displacement), not a sequential probe
  loop of dependent, memory-latency-bound gathers.
- Hits are packed per read with an inverse-CDF trick before the
  positions gather: seeds are sorted by ascending hit count (so unique,
  informative seeds survive truncation), hit m of a read maps to
  (seed, within-seed offset) via comparisons against the exclusive
  cumsum of counts — all elementwise ops — and ONE [B, max_read_hits]
  gather pulls exactly the real hits. The naive [B, S, max_hits]
  gather moves ~17x more elements, nearly all padding.
- Vote counting sorts the packed [B, 2*max_read_hits] diagonal keys and
  run-length-counts via a log-doubling suffix min; top-C selection is C
  rounds of argmax + neighborhood masking. No data-dependent shapes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from midas_tpu.db.index import (BUCKET_SLOTS, EMPTY_KEY, LEVEL2_SALT, ROW,
                                SeedIndex)

# plain ints: jnp constants at module level would initialize the JAX
# backend on import, before the caller has chosen a platform
INVALID_KEY = 2**31 - 1
STRAND_OFFSET = 2**30  # keys: strand * STRAND_OFFSET + diag + L


@dataclasses.dataclass(frozen=True)
class SeedParams:
    k: int = 14
    stride: int = 7          # query seed stride
    max_hits: int = 16       # hits gathered per seed
    num_cands: int = 4       # banded-extension candidates per read
    band_width: int = 16     # D of the banded DP
    max_read_hits: int = 128  # per-read per-strand packed hit budget


def fmix32_jnp(h: jnp.ndarray) -> jnp.ndarray:
    h = h.astype(jnp.uint32)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _shift_left_rows(x: jnp.ndarray, shifts: jnp.ndarray,
                     fill) -> jnp.ndarray:
    """out[i, j] = x[i, j + shifts[i]] (fill beyond L), by binary
    decomposition of the per-row shift: log2(L) select-between-static-
    slices passes: elementwise selects instead of a take_along_axis row
    gather over small-dtype elements."""
    B, L = x.shape
    fill = x.dtype.type(fill)
    bit = 1
    while bit <= L:    # shifts reach L itself (empty read: qlen 0)
        shifted = jnp.concatenate(
            [x[:, bit:], jnp.full((B, min(bit, L)), fill, x.dtype)],
            axis=1)[:, :L]
        take = (shifts & bit) != 0
        x = jnp.where(take[:, None], shifted, x)
        bit <<= 1
    return x


def revcomp_batch(codes: jnp.ndarray, qlens: jnp.ndarray) -> jnp.ndarray:
    """Per-read reverse complement, keeping reads left-aligned.
    codes [B, L] int8 (4 = pad); rc[i, j] = comp(codes[i, qlen_i-1-j]).

    Computed as a STATIC flip plus a per-row left shift by L - qlen
    (_shift_left_rows): flip[i, j] = codes[i, L-1-j], so
    flip[i, j + (L-qlen)] = codes[i, qlen-1-j] — gather-free."""
    B, L = codes.shape
    flipped = codes[:, ::-1]
    comp = jnp.where(flipped < 4, 3 - flipped, 4).astype(jnp.int8)
    return _shift_left_rows(comp, (L - qlens).astype(jnp.int32), 4)


def reverse_batch(x: jnp.ndarray, qlens: jnp.ndarray,
                  fill: int = 0) -> jnp.ndarray:
    """Per-read reversal without complement (quality / penalty planes
    riding alongside revcomp_batch'ed codes), keeping rows left-aligned:
    out[i, j] = x[i, qlen_i-1-j], `fill` beyond the read. Same
    flip + shift-ladder construction as revcomp_batch."""
    B, L = x.shape
    return _shift_left_rows(x[:, ::-1], (L - qlens).astype(jnp.int32), fill)


def _query_kmers(codes: jnp.ndarray, qlens: jnp.ndarray, k: int, stride: int,
                 max_len: int) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """K-mers at stride positions. Returns (kmers [B,S] uint32,
    qpos [S] int32, valid [B,S] bool).

    Built from S STATIC strided slices stacked [B, S, k] and a k-step
    Horner accumulation over tiny [B, S] planes. (The earlier version
    accumulated k-mers at EVERY read position then kept 1-in-stride —
    k full-width shifted passes over [B, L], ~7.5x the arithmetic and
    memory traffic for identical values; and the slices are static so
    no [B, S, k] index gather is needed.)"""
    B, L = codes.shape
    n_seeds = max(1, (max_len - k) // stride + 1)
    assert (n_seeds - 1) * stride + k <= L, (n_seeds, stride, k, L)
    qpos = jnp.arange(n_seeds, dtype=jnp.int32) * stride  # [S]
    wins = jnp.stack([codes[:, p: p + k]
                      for p in range(0, n_seeds * stride, stride)],
                     axis=1)                               # [B, S, k] int8
    cu = wins.astype(jnp.uint32)
    km = jnp.zeros((B, n_seeds), jnp.uint32)
    valid = jnp.ones((B, n_seeds), jnp.bool_)
    for i in range(k):
        ci = cu[:, :, i]
        km = (km << 2) | (ci & 3)
        valid &= ci < 4
    valid &= qpos[None, :] + k <= qlens[:, None]
    return km, qpos, valid


def _bucket_lookup(index_arrays: Dict[str, jnp.ndarray], kmers: jnp.ndarray
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-level bucket lookup: ONE row gather per level returns the 8
    candidate keys plus their start rows and counts ([.., 24] int32 rows;
    see db/index.py). kmers [...] uint32; returns (start_row, count)
    int32, count 0 when absent."""
    km_i32 = kmers.astype(jnp.int32)   # k <= 15 so kmers < 2^30
    start_row = jnp.zeros(kmers.shape, jnp.int32)
    count = jnp.zeros(kmers.shape, jnp.int32)
    for name, salt in (("bucket1", 0), ("bucket2", int(LEVEL2_SALT))):
        tbl = index_arrays[name]
        nb = tbl.shape[0]
        b = (fmix32_jnp(kmers ^ jnp.uint32(salt))
             & jnp.uint32(nb - 1)).astype(jnp.int32)
        rows = tbl[b]                                   # [..., 24] row gather
        match = rows[..., :BUCKET_SLOTS] == km_i32[..., None]
        start_row += jnp.sum(
            jnp.where(match, rows[..., BUCKET_SLOTS:2 * BUCKET_SLOTS], 0), axis=-1)
        count += jnp.sum(
            jnp.where(match, rows[..., 2 * BUCKET_SLOTS:], 0), axis=-1)
    return start_row, count


def _packed_strand_keys(
    index_arrays: Dict[str, jnp.ndarray],
    strand_codes: jnp.ndarray,   # [B, L] int8
    qlens: jnp.ndarray,
    strand: int,
    sp: "SeedParams",
    max_len: int,
) -> jnp.ndarray:
    """Diagonal vote keys for one strand, packed to [B, max_read_hits].

    Position runs are row-aligned (db/index.py), so hits are pulled as
    whole [ROW]-wide rows: the inverse CDF runs over per-seed ROW
    counts and ONE [B, R] row gather fetches up to R*ROW positions.
    Invalid slots carry INVALID_KEY."""
    B, L = strand_codes.shape
    positions2d = index_arrays["positions2d"]
    km, qpos, valid = _query_kmers(strand_codes, qlens, sp.k, sp.stride, max_len)
    S = km.shape[1]
    start_row, count = _bucket_lookup(index_arrays, km)           # [B, S]
    c = jnp.where(valid, jnp.minimum(count, sp.max_hits), 0)

    # sort seeds by ascending hit count: unique (informative) seeds pack
    # first, repeat-heavy seeds are truncated preferentially. S is tiny
    # (~17), so the stable rank is computed by O(S^2) counting and the
    # permutation applied with a one-hot contraction — identical to a
    # stable argsort + 3 take_along_axis gathers, but elementwise work
    # only
    lt = (c[:, None, :] < c[:, :, None])                     # c_j < c_i
    eq_lo = ((c[:, None, :] == c[:, :, None])
             & (jnp.arange(S)[None, None, :] < jnp.arange(S)[None, :, None]))
    rank = jnp.sum((lt | eq_lo).astype(jnp.int32), axis=2)   # [B, S]
    # perm[s] = index with rank s, as a one-hot plane
    onehot_r = (rank[:, None, :] == jnp.arange(S, dtype=jnp.int32)[None, :, None])

    def permute(v):
        return jnp.sum(jnp.where(onehot_r, v[:, None, :], 0), axis=2)

    c_s = permute(c)
    sr_s = permute(start_row)
    qpos_s = permute(jnp.broadcast_to(qpos[None, :], (B, S)))

    r_s = (c_s + ROW - 1) // ROW                                   # rows per seed
    roffs = jnp.cumsum(r_s, axis=1) - r_s                          # [B, S] exclusive
    rtotal = roffs[:, -1] + r_s[:, -1]                             # [B]
    R = max(1, sp.max_read_hits // ROW)
    j = jnp.arange(R, dtype=jnp.int32)[None, :]                    # [1, R]
    # inverse CDF: row j belongs to seed sid = max{s : roffs[s] <= j};
    # one-hot select of that seed's attributes is elementwise work
    le = roffs[:, None, :] <= j[:, :, None]                        # [B, R, S]
    sid = jnp.sum(le.astype(jnp.int32), axis=2) - 1                # [B, R]
    onehot = (jnp.arange(S, dtype=jnp.int32)[None, None, :]
              == sid[:, :, None])                                  # [B, R, S]
    sr_of = jnp.sum(jnp.where(onehot, sr_s[:, None, :], 0), axis=2)
    roffs_of = jnp.sum(jnp.where(onehot, roffs[:, None, :], 0), axis=2)
    qpos_of = jnp.sum(jnp.where(onehot, qpos_s[:, None, :], 0), axis=2)
    c_of = jnp.sum(jnp.where(onehot, c_s[:, None, :], 0), axis=2)
    rwi = j - roffs_of                                             # row within seed
    row_idx = sr_of + rwi
    jvalid = j < jnp.minimum(rtotal, R)[:, None]
    prow = positions2d[jnp.clip(row_idx, 0, positions2d.shape[0] - 1)]  # [B,R,ROW]
    e = jnp.arange(ROW, dtype=jnp.int32)[None, None, :]
    elem_valid = (jvalid[:, :, None]
                  & ((rwi[:, :, None] * ROW + e) < c_of[:, :, None]))
    diag = prow - qpos_of[:, :, None]
    key = jnp.int32(strand * STRAND_OFFSET) + diag + jnp.int32(L)
    return jnp.where(elem_valid, key, INVALID_KEY).reshape(B, R * ROW)


@functools.partial(jax.jit, static_argnames=("sp", "max_len"))
def find_candidates(
    index_arrays: Dict[str, jnp.ndarray],
    codes: jnp.ndarray,   # [B, L] int8
    qlens: jnp.ndarray,   # [B] int32
    sp: SeedParams,
    max_len: int,
) -> Dict[str, jnp.ndarray]:
    """Top-C (diagonal, strand) candidates per read by seed votes.

    Returns dict with [B, C] arrays: diag (ref_pos - query_pos in pack
    coords), strand (0 fwd / 1 rc), votes (seed hits on that diagonal),
    valid (bool) — plus rc [B, L], the reverse-complement reads (reused
    by the extension stage so it is computed once per batch).
    """
    B, L = codes.shape
    rc = revcomp_batch(codes, qlens)

    keys = jnp.concatenate(
        [_packed_strand_keys(index_arrays, sc, qlens, strand, sp, max_len)
         for strand, sc in enumerate((codes, rc))], axis=1)  # [B, 2*M]

    # optimization_barriers between the pipeline phases: letting XLA
    # fuse the hit-packing producers into the sort/vote consumers
    # recomputes the [B, R, S] intermediates per consumer
    keys = jax.lax.optimization_barrier(keys)
    keys = jnp.sort(keys, axis=1)
    keys = jax.lax.optimization_barrier(keys)
    # votes per run of equal keys, via prefix scans (a vmapped
    # searchsorted lowers to per-element while loops)
    M = keys.shape[1]
    j_idx = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32)[None, :], (B, M))
    is_start = jnp.concatenate(
        [jnp.ones((B, 1), jnp.bool_), keys[:, 1:] != keys[:, :-1]], axis=1)
    # index of the next run start strictly after j (reverse exclusive
    # cumulative min of start positions), computed as an explicit
    # log-doubling suffix min: lax.associative_scan here made XLA
    # compile superlinearly in B*M when composed with the hit-gather
    # producer above; the unrolled doubling computes the identical
    # result
    start_pos = jnp.where(is_start, j_idx, M)
    next_start = jnp.concatenate(
        [start_pos[:, 1:], jnp.full((B, 1), M, jnp.int32)], axis=1)
    shift = 1
    while shift < M:
        shifted = jnp.concatenate(
            [next_start[:, shift:], jnp.full((B, shift), M, jnp.int32)],
            axis=1)
        next_start = jnp.minimum(next_start, shifted)
        shift *= 2
    votes = next_start - j_idx  # valid at run starts
    eligible = is_start & (keys != INVALID_KEY)
    score = jax.lax.optimization_barrier(jnp.where(eligible, votes, -1))

    # C rounds of argmax + neighborhood masking (dedup near-diagonals)
    tol = sp.band_width // 2
    cand_key = []
    cand_votes = []
    for _ in range(sp.num_cands):
        best_j = jnp.argmax(score, axis=1)  # ties -> smallest index = smallest key
        bvotes = jnp.take_along_axis(score, best_j[:, None], axis=1)[:, 0]
        bkey = jnp.take_along_axis(keys, best_j[:, None], axis=1)[:, 0]
        cand_key.append(bkey)
        cand_votes.append(bvotes)
        near = jnp.abs(keys - bkey[:, None]) <= tol
        score = jnp.where(near, -1, score)
    cand_key = jnp.stack(cand_key, axis=1)    # [B, C]
    cand_votes = jnp.stack(cand_votes, axis=1)
    valid = cand_votes > 0
    strand = (cand_key // STRAND_OFFSET).astype(jnp.int32)
    diag = cand_key - strand * STRAND_OFFSET - jnp.int32(L)
    return dict(diag=diag, strand=strand, votes=cand_votes, valid=valid, rc=rc)


@functools.partial(jax.jit, static_argnames=("window_len",))
def gather_windows(
    pack_codes: jnp.ndarray,   # [G] int8
    pack_offsets: jnp.ndarray, # [S+1] int64/int32
    winstart: jnp.ndarray,     # [B, C] int32 global pack coords
    window_len: int,
    center: jnp.ndarray = None,  # see gather_windows_packed
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gather reference windows, masking outside the target sequence so
    alignments never cross packed-sequence boundaries.

    Element-gather version (used by dist/sharded); the profilers use
    gather_windows_packed below.

    Returns (ref_win [B, C, W] int8, seq_idx [B, C] int32)."""
    W = window_len
    seq_idx, seq_lo, seq_hi = _window_seq_bounds(pack_offsets, winstart, W,
                                                 center=center)
    w = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    pos = winstart[:, :, None] + w
    in_seq = (pos >= seq_lo[:, :, None]) & (pos < seq_hi[:, :, None])
    gathered = pack_codes[jnp.clip(pos, 0, pack_codes.shape[0] - 1)]
    ref_win = jnp.where(in_seq, gathered, jnp.int8(4))
    return ref_win, seq_idx


def _window_seq_bounds(pack_offsets, winstart, W, center=None):
    """Target sequence owning each window, by its expected ALIGNMENT
    midpoint. `center` defaults to the window midpoint, which is only
    right when the read fills the window: a short read near the end of
    a sequence has its window mostly PAST the sequence, the midpoint
    lands in the next sequence, and the in-seq mask then blanks the
    true hit (a perfect 40 bp read in a 128 bucket scored 0 — caught by
    the 40 bp golden test). Callers pass center = alignment midpoint
    (diag + qlen // 2)."""
    if center is None:
        center = winstart + W // 2
    seq_idx = (
        jnp.searchsorted(pack_offsets, center.astype(pack_offsets.dtype), side="right") - 1
    ).astype(jnp.int32)
    seq_idx = jnp.clip(seq_idx, 0, pack_offsets.shape[0] - 2)
    seq_lo = pack_offsets[seq_idx].astype(jnp.int32)
    seq_hi = pack_offsets[seq_idx + 1].astype(jnp.int32)
    return seq_idx, seq_lo, seq_hi


BASES_PER_WORD = 16  # 2-bit codes packed into uint32 words


@functools.partial(jax.jit, static_argnames=("window_len",))
def gather_windows_packed(
    pack_words: jnp.ndarray,   # [NW] uint32, 16 bases/word 2-bit packed
    pack_nmask: jnp.ndarray,   # [NW] uint32, bit j = base j is a sentinel
    pack_offsets: jnp.ndarray, # [S+1] int32/int64
    winstart: jnp.ndarray,     # [B, C] int32 global pack coords
    window_len: int,
    center: jnp.ndarray = None,  # [B, C] expected alignment midpoint
    #                              (diag + qlen//2); default = window mid
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Word-packed window gather.

    An int8 element gather moves one base per (memory-latency-bound)
    gathered element; packing 16 bases into each uint32 word cuts the
    gathered element count 16x. The sub-word realignment (winstart mod
    16) happens in WORD space with per-window variable bit shifts — a
    handful of uint32 ops on [B, C, NWIN] (an earlier 16-way
    static-slice select burned 32 elementwise passes over the unpacked
    [B, C, W] planes).

    Returns (ref_win [B, C, W] int8, seq_idx [B, C] int32)."""
    W = window_len
    NWIN = (W + BASES_PER_WORD - 1) // BASES_PER_WORD + 1
    seq_idx, seq_lo, seq_hi = _window_seq_bounds(pack_offsets, winstart, W,
                                                 center=center)

    w0 = jnp.floor_divide(winstart, BASES_PER_WORD)           # [B, C]
    off = winstart - w0 * BASES_PER_WORD                       # in [0, 16)
    # Fetch the NWIN+1 consecutive words per window as WHOLE 16-word
    # ROWS of a [*, 16] view plus a word-granular shift ladder: an
    # element gather of B*C*(NWIN+1) individual words becomes 2-3 row
    # gathers per window, and the ladder is elementwise work.
    WPR = 16
    NW = pack_words.shape[0]
    rows_n = -(-NW // WPR)
    pad = rows_n * WPR - NW
    w2d = jnp.concatenate(
        [pack_words, jnp.zeros(pad, jnp.uint32)]).reshape(rows_n, WPR)
    n2d = jnp.concatenate(
        [pack_nmask, jnp.zeros(pad, jnp.uint32)]).reshape(rows_n, WPR)
    R2 = -(-(WPR - 1 + NWIN + 1) // WPR)      # rows covering any offset
    row0 = w0 // WPR                          # floor; may be -1 at pack
    col0 = w0 - row0 * WPR                    # start (clip elementwise
    ridx = jnp.clip(row0[:, :, None] + jnp.arange(R2, dtype=jnp.int32),
                    0, rows_n - 1)            # below, like the old
    #                                           widx clip: out-of-pack
    #                                           words read garbage that
    #                                           the in_seq mask blanks)
    wrows = w2d[ridx].reshape(*w0.shape, R2 * WPR)     # [B, C, R2*16]
    nrows = n2d[ridx].reshape(*w0.shape, R2 * WPR)

    def _align_cols(x):
        # shift left along the last axis by col0 (binary ladder)
        bit = 1
        while bit < WPR:
            shifted = jnp.concatenate(
                [x[..., bit:], jnp.zeros((*x.shape[:-1], bit), x.dtype)],
                axis=-1)
            x = jnp.where(((col0 & bit) != 0)[:, :, None], shifted, x)
            bit <<= 1
        return x

    words = _align_cols(wrows)[..., : NWIN + 1]
    nwords = _align_cols(nrows)[..., : NWIN + 1]

    # word-space realignment: aligned[i] spans bases [winstart + 16i,
    # winstart + 16i + 16); low bits from word i, high bits from i+1
    sh = (2 * off.astype(jnp.uint32))[:, :, None]              # [B, C, 1]
    lo = words[..., :NWIN] >> sh
    hi = jnp.where(sh > 0, words[..., 1:] << (32 - sh), jnp.uint32(0))
    aligned = lo | hi                                          # [B, C, NWIN]
    nsh = off.astype(jnp.uint32)[:, :, None]
    nlo = nwords[..., :NWIN] >> nsh
    nhi = jnp.where(nsh > 0, nwords[..., 1:] << (16 - nsh), jnp.uint32(0))
    naligned = (nlo | nhi) & jnp.uint32(0xFFFF)

    shifts = jnp.arange(BASES_PER_WORD, dtype=jnp.uint32) * 2  # [16]
    res = ((aligned[..., None] >> shifts) & jnp.uint32(3)).astype(jnp.int8)
    res = res.reshape(*res.shape[:-2], NWIN * BASES_PER_WORD)[..., :W]
    nshift = jnp.arange(BASES_PER_WORD, dtype=jnp.uint32)
    nres = ((naligned[..., None] >> nshift) & jnp.uint32(1)).astype(jnp.bool_)
    nres = nres.reshape(*nres.shape[:-2], NWIN * BASES_PER_WORD)[..., :W]

    w = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    pos = winstart[:, :, None] + w
    in_seq = (pos >= seq_lo[:, :, None]) & (pos < seq_hi[:, :, None])
    ref_win = jnp.where(in_seq & ~nres, res, jnp.int8(4))
    return ref_win, seq_idx


def pack_words_host(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side 2-bit packing of a reference code array.

    Returns (words [ceil(G/16)+1] uint32 with 16 bases/word, nmask of the
    same shape with bit j set where base j is a sentinel). One guard word
    is appended so clipped gathers near the end stay in range."""
    codes = np.asarray(codes, dtype=np.int8)
    G = len(codes)
    nw = (G + BASES_PER_WORD - 1) // BASES_PER_WORD
    padded = np.full(nw * BASES_PER_WORD, 4, dtype=np.int8)
    padded[:G] = codes
    grid = padded.reshape(nw, BASES_PER_WORD).astype(np.uint32)
    shifts = (np.arange(BASES_PER_WORD, dtype=np.uint32) * 2)[None, :]
    words = ((grid & 3) << shifts).sum(axis=1, dtype=np.uint32)
    nmask = ((grid >= 4).astype(np.uint32)
             << np.arange(BASES_PER_WORD, dtype=np.uint32)[None, :]).sum(
                 axis=1, dtype=np.uint32)
    guard_word = np.zeros(1, np.uint32)
    guard_mask = np.full(1, 0xFFFF, np.uint32)  # all-sentinel guard
    return (np.concatenate([words, guard_word]),
            np.concatenate([nmask, guard_mask]))
