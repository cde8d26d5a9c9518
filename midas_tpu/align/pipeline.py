"""Full seed-and-extend aligner over a packed reference.

Composes db/index.py (hashed seed tables) + align/seed.py (seed-and-
vote candidates) + align/banded.py (banded affine DP with stat
propagation) into the device-resident equivalent of one bowtie2 /
hs-blastn invocation (reference call sites: midas/run/species.py:29-49,
genes.py:116-145, snps.py:97-128). Alignments never leave the device
as text: downstream profilers consume the [B, C] result arrays
directly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from midas_tpu.align.banded import banded_align
from midas_tpu.align.banded_cuda import SCORE_ROWS, banded_align_cuda
from midas_tpu.align.params import ScoringParams
from midas_tpu.align.seed import (SeedParams, find_candidates,
                                  gather_windows_packed, pack_words_host,
                                  revcomp_batch, reverse_batch)
from midas_tpu.db.index import SeedIndex
from midas_tpu.db.refpack import ReferencePack
from midas_tpu.io.batch import ReadBatch


def quality_penalties(quals: jnp.ndarray,
                      scoring: ScoringParams) -> jnp.ndarray:
    """Per-base positive mismatch penalties from Phred qualities —
    bowtie2's --mp MX,MN table in exact integer arithmetic:
    MN + ((MX - MN) * min(Q, 40)) // 40 (ScoringParams.mismatch_penalty,
    vectorized). quals [B, L] int8 -> [B, L] int8."""
    mx = -scoring.mismatch
    mn = scoring.mm_min
    q = jnp.minimum(quals.astype(jnp.int32), 40)
    return (mn + ((mx - mn) * q) // 40).astype(jnp.int8)


@dataclasses.dataclass
class AlignmentResult:
    """Host-side view of one aligned batch. All arrays [B, C] unless
    noted; coordinates are local to the hit sequence (0-based,
    half-open), query coordinates are in the aligned strand's frame."""

    names: list                 # [B'] read names
    n_reads: int
    valid: np.ndarray           # bool: candidate produced an alignment
    score: np.ndarray           # raw DP score
    seq_idx: np.ndarray         # target sequence index into pack.names
    strand: np.ndarray          # 0 fwd, 1 rc
    tstart: np.ndarray
    tend: np.ndarray
    qstart: np.ndarray
    qend: np.ndarray
    matches: np.ndarray
    mismatches: np.ndarray
    gap_cols: np.ndarray
    gap_opens: np.ndarray

    @property
    def aln_cols(self) -> np.ndarray:
        return self.matches + self.mismatches + self.gap_cols

    @property
    def nm(self) -> np.ndarray:
        return self.mismatches + self.gap_cols

    @property
    def blast_pid(self) -> np.ndarray:
        return 100.0 * self.matches / np.maximum(self.aln_cols, 1)

    @property
    def aligned_qlen(self) -> np.ndarray:
        return self.qend - self.qstart

    @property
    def bowtie_pid(self) -> np.ndarray:
        alen = np.maximum(self.aligned_qlen, 1)
        return 100.0 * (alen - self.nm) / alen


SCORE_ONLY_KEYS = ("score",) + SCORE_ROWS


def plain_banded_align(q_pair, qlens_pair, win_pair, params, band_width,
                       score_only=False, qpen=None):
    """The jnp DP (banded.banded_align) behind the kernel's signature:
    full statistics always, subset to SCORE_ONLY_KEYS for score_only."""
    out = banded_align(q_pair, qlens_pair, win_pair, params=params,
                       band_width=band_width, qpen=qpen)
    if score_only:
        out = {k: out[k] for k in SCORE_ONLY_KEYS}
    return out


def dp_for_platform(platform: str):
    """The banded-DP implementation for a JAX platform: the CUDA kernel
    on "gpu", the jnp scan on "cpu". Any other platform has none."""
    if platform == "cpu":
        return plain_banded_align
    if platform == "gpu":
        return banded_align_cuda
    raise NotImplementedError(
        f"no banded-DP implementation for platform {platform!r}")


def dispatch_banded_align(q_pair, qlens_pair, win_pair, scoring, band_width,
                          score_only: bool = False, qpen_pair=None):
    """The banded DP on the default backend (dp_for_platform).
    score_only=True returns score/qend/wstart/wend only (pass 1 of the
    two-pass alignment; the kernel then carries one statistics plane).
    qpen_pair ([P, L] int8 positive penalties) enables the bowtie2
    quality-scaled mismatch model. Both implementations give the same
    bits."""
    dp = dp_for_platform(jax.default_backend())
    return dp(q_pair, qlens_pair, win_pair, scoring, band_width,
              score_only=score_only, qpen=qpen_pair)


@functools.partial(jax.jit, static_argnames=("num_cands",))
def _prepare_pairs(
    codes: jnp.ndarray,
    qlens: jnp.ndarray,
    strand: jnp.ndarray,   # [B, C]
    num_cands: int,
    rc: Optional[jnp.ndarray] = None,  # [B, L] precomputed reverse complement
    qpen: Optional[jnp.ndarray] = None,  # [B, L] mismatch penalties (fwd)
) -> tuple:
    """Per-candidate strand-selected queries, flattened to [B*C, L];
    with qpen, the penalty plane rides along (reversed for rc-strand
    candidates, since penalties follow the read base they qualify).
    Returns (q_pair, qlens_pair, qpen_pair-or-None)."""
    B, L = codes.shape
    C = num_cands
    if rc is None:
        rc = revcomp_batch(codes, qlens)
    q_pair = jnp.where(strand[:, :, None] == 1, rc[:, None, :], codes[:, None, :])
    q_pair = jnp.broadcast_to(q_pair, (B, C, L)).reshape(B * C, L)
    qlens_pair = jnp.broadcast_to(qlens[:, None], (B, C)).reshape(B * C)
    qpen_pair = None
    if qpen is not None:
        rpen = reverse_batch(qpen, qlens)
        qpen_pair = jnp.where(strand[:, :, None] == 1, rpen[:, None, :],
                              qpen[:, None, :])
        qpen_pair = jnp.broadcast_to(qpen_pair, (B, C, L)).reshape(B * C, L)
    return q_pair, qlens_pair, qpen_pair


@jax.jit
def _postprocess(
    out: Dict[str, jnp.ndarray],     # [B, C] banded outputs
    cands: Dict[str, jnp.ndarray],
    winstart: jnp.ndarray,
    seq_idx: jnp.ndarray,
    seq_lo: jnp.ndarray,
) -> Dict[str, jnp.ndarray]:
    tstart = winstart + out["wstart"] - seq_lo
    tend = winstart + out["wend"] - seq_lo
    valid = cands["valid"]
    # drop duplicate alignments: same (seq, strand, tstart) found via two
    # nearby candidate diagonals — keep the first (candidates are emitted
    # in decreasing vote order). One [B, C, C] comparison, C is tiny.
    C = valid.shape[1]
    same = ((seq_idx[:, :, None] == seq_idx[:, None, :])
            & (cands["strand"][:, :, None] == cands["strand"][:, None, :])
            & (tstart[:, :, None] == tstart[:, None, :]))
    c_iota = jnp.arange(C, dtype=jnp.int32)
    earlier = c_iota[None, :, None] > c_iota[None, None, :]
    dup = jnp.any(same & earlier & valid[:, None, :], axis=2)
    valid = valid & ~dup
    return dict(
        valid=valid,
        score=out["score"],
        seq_idx=seq_idx,
        strand=cands["strand"],
        tstart=tstart,
        tend=tend,
        qstart=out["qstart"],
        qend=out["qend"],
        matches=out["matches"],
        mismatches=out["mismatches"],
        gap_cols=out["gap_cols"],
        gap_opens=out["gap_opens"],
    )


def _align_batch_stages(
    index_arrays, pack_arrays, codes, qlens,
    scoring: ScoringParams, seed_params: SeedParams, max_len: int,
    quals: Optional[jnp.ndarray] = None,
) -> Dict[str, jnp.ndarray]:
    B, L = codes.shape
    C = seed_params.num_cands
    D = seed_params.band_width
    W = L + D - 1
    pack_offsets = pack_arrays["offsets"]
    # static args must go by keyword: a positional static arg to a
    # nested jit gets traced instead
    cands = find_candidates(index_arrays, codes, qlens,
                            sp=seed_params, max_len=max_len)
    winstart = cands["diag"] - D // 2
    ref_win, seq_idx = gather_windows_packed(
        pack_arrays["words"], pack_arrays["nmask"], pack_offsets, winstart,
        window_len=W, center=cands["diag"] + qlens[:, None] // 2)
    qpen = (quality_penalties(quals, scoring)
            if scoring.qual_scaled and quals is not None else None)
    q_pair, qlens_pair, qpen_pair = _prepare_pairs(
        codes, qlens, cands["strand"], num_cands=C, rc=cands["rc"],
        qpen=qpen)
    out = dispatch_banded_align(q_pair, qlens_pair, ref_win.reshape(B * C, W),
                                scoring, D, qpen_pair=qpen_pair)
    out = {k: v.reshape(B, C) for k, v in out.items()}
    seq_lo = pack_offsets[seq_idx].astype(jnp.int32)
    return _postprocess(out, cands, winstart, seq_idx, seq_lo)


_align_batch_fused = jax.jit(
    _align_batch_stages, static_argnames=("scoring", "seed_params", "max_len"))


def _align_batch_device(
    index_arrays: Dict[str, jnp.ndarray],
    pack_arrays: Dict[str, jnp.ndarray],
    codes: jnp.ndarray,
    qlens: jnp.ndarray,
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    quals: Optional[jnp.ndarray] = None,
) -> Dict[str, jnp.ndarray]:
    """Seed -> window gather -> banded extension -> postprocess.

    On an accelerator the whole chain is ONE jit (one host->device
    dispatch; the DP runs as a kernel inside it). On CPU the stages
    keep separate jit boundaries with syncs between them: there the DP
    is a lowered 128-step jnp scan, and fusing the gather producers
    into it blows compile time up ~50x (observed on the CPU backend),
    while dispatching a stage during the previous stage's compile hits
    a jax-0.9 async slow path.
    """
    if jax.default_backend() not in ("cpu",):
        return _align_batch_fused(
            index_arrays, pack_arrays, codes, qlens,
            scoring=scoring, seed_params=seed_params, max_len=max_len,
            quals=quals)
    pack_offsets = pack_arrays["offsets"]
    cands = find_candidates(index_arrays, codes, qlens, seed_params, max_len)
    cands = jax.block_until_ready(cands)
    D = seed_params.band_width
    W = codes.shape[1] + D - 1
    winstart = cands["diag"] - D // 2
    ref_win, seq_idx = gather_windows_packed(
        pack_arrays["words"], pack_arrays["nmask"], pack_offsets, winstart, W,
        center=cands["diag"] + qlens[:, None] // 2)
    ref_win = jax.block_until_ready(ref_win)
    qpen = (quality_penalties(quals, scoring)
            if scoring.qual_scaled and quals is not None else None)
    q_pair, qlens_pair, qpen_pair = _prepare_pairs(
        codes, qlens, cands["strand"], seed_params.num_cands, rc=cands["rc"],
        qpen=qpen)
    B, C = codes.shape[0], seed_params.num_cands
    out = dispatch_banded_align(q_pair, qlens_pair, ref_win.reshape(B * C, W),
                                scoring, D, qpen_pair=qpen_pair)
    out = jax.block_until_ready(out)
    out = {k: v.reshape(B, C) for k, v in out.items()}
    seq_lo = pack_offsets[seq_idx].astype(jnp.int32)
    return _postprocess(out, cands, winstart, seq_idx, seq_lo)


@jax.jit
def _pack_result(out: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """Stack the 12 [B, C] result planes into one int32 [12, B, C]
    array so host readback is a single transfer. DP scores are
    integer-valued (integer match/mismatch/gap parameters), so the
    int32 round-trip is exact."""
    planes = [out["valid"].astype(jnp.int32),
              jnp.round(out["score"]).astype(jnp.int32)]
    planes += [out[k].astype(jnp.int32) for k in Aligner._PACK_FIELDS[2:]]
    return jnp.stack(planes)


class Aligner:
    """Device-resident aligner bound to one ReferencePack + SeedIndex."""

    def __init__(
        self,
        pack: ReferencePack,
        index: SeedIndex,
        scoring: ScoringParams,
        seed_params: Optional[SeedParams] = None,
        max_read_len: int = 128,
    ):
        self.pack = pack
        self.scoring = scoring
        self.seed_params = seed_params or SeedParams()
        self.max_read_len = max_read_len
        self.index_arrays = dict(
            bucket1=jnp.asarray(index.bucket1),
            bucket2=jnp.asarray(index.bucket2),
            positions2d=jnp.asarray(index.positions2d),
        )
        self.pack_codes = jnp.asarray(pack.codes)
        # x64 is disabled under jit; packs are asserted < 2 GiB at index
        # build time so int32 offsets are exact
        self.pack_offsets = jnp.asarray(pack.offsets.astype(np.int32))
        words, nmask = pack_words_host(pack.codes)
        self.pack_arrays = dict(
            words=jnp.asarray(words), nmask=jnp.asarray(nmask),
            offsets=self.pack_offsets)

    _PACK_FIELDS = ("valid", "score", "seq_idx", "strand", "tstart", "tend",
                    "qstart", "qend", "matches", "mismatches", "gap_cols",
                    "gap_opens")

    def align_batch(self, batch: ReadBatch) -> AlignmentResult:
        quals = (jnp.asarray(batch.quals) if self.scoring.qual_scaled
                 else None)
        dev = _pack_result(self.align_batch_device(
            jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
            quals=quals))
        # ONE packed device->host transfer instead of 12 [B, C] pulls
        packed = np.asarray(jax.device_get(dev))
        host = {}
        for i, k in enumerate(self._PACK_FIELDS):
            arr = packed[i]
            if k == "valid":
                arr = arr.astype(bool)
            elif k == "score":
                arr = arr.astype(np.float32)
            host[k] = arr
        # mask out padding rows
        host["valid"][batch.n_reads:] = False
        return AlignmentResult(names=batch.names, n_reads=batch.n_reads, **host)

    def align_batch_device(self, codes: jnp.ndarray, qlens: jnp.ndarray,
                           quals: Optional[jnp.ndarray] = None):
        return _align_batch_device(
            self.index_arrays, self.pack_arrays,
            codes, qlens, self.scoring, self.seed_params, self.max_read_len,
            quals=quals,
        )


def align_candidates_score(
    index_arrays, pack_arrays, codes, qlens,
    scoring: ScoringParams, seed_params: SeedParams, max_len: int,
    quals: Optional[jnp.ndarray] = None,
):
    """Pass 1 of the two-pass alignment: seed + score-only banded DP over
    every candidate. Returns (out1, aux):

    out1 — [B, C] planes sufficient for best-hit selection, MAPQ,
    duplicate-drop, and pairing: valid, score, seq_idx, strand,
    tstart, tend, qend.
    aux  — what pass 2 (align_chosen_full) needs to re-align just the
    chosen candidate with full statistics: winstart, rc, strand.

    Scores are identical to _align_batch_stages' (same DP, fewer stat
    planes — tested), so selection is bit-equal; the full-stat DP then
    runs over B rows instead of B*C."""
    B, L = codes.shape
    C = seed_params.num_cands
    D = seed_params.band_width
    W = L + D - 1
    pack_offsets = pack_arrays["offsets"]
    cands = find_candidates(index_arrays, codes, qlens,
                            sp=seed_params, max_len=max_len)
    winstart = cands["diag"] - D // 2
    ref_win, seq_idx = gather_windows_packed(
        pack_arrays["words"], pack_arrays["nmask"], pack_offsets, winstart,
        window_len=W, center=cands["diag"] + qlens[:, None] // 2)
    qpen = (quality_penalties(quals, scoring)
            if scoring.qual_scaled and quals is not None else None)
    q_pair, qlens_pair, qpen_pair = _prepare_pairs(
        codes, qlens, cands["strand"], num_cands=C, rc=cands["rc"],
        qpen=qpen)
    out = dispatch_banded_align(q_pair, qlens_pair, ref_win.reshape(B * C, W),
                                scoring, D, score_only=True,
                                qpen_pair=qpen_pair)
    out = {k: v.reshape(B, C) for k, v in out.items()}
    seq_lo = pack_offsets[seq_idx].astype(jnp.int32)
    tstart = winstart + out["wstart"] - seq_lo
    tend = winstart + out["wend"] - seq_lo
    valid = cands["valid"]
    # duplicate-alignment drop, exactly as _postprocess
    same = ((seq_idx[:, :, None] == seq_idx[:, None, :])
            & (cands["strand"][:, :, None] == cands["strand"][:, None, :])
            & (tstart[:, :, None] == tstart[:, None, :]))
    c_iota = jnp.arange(C, dtype=jnp.int32)
    earlier = c_iota[None, :, None] > c_iota[None, None, :]
    dup = jnp.any(same & earlier & valid[:, None, :], axis=2)
    valid = valid & ~dup
    out1 = dict(valid=valid, score=out["score"], seq_idx=seq_idx,
                strand=cands["strand"], tstart=tstart, tend=tend,
                qend=out["qend"])
    aux = dict(winstart=winstart, rc=cands["rc"], strand=cands["strand"],
               qpen=qpen)
    return out1, aux


def align_chosen_full(
    pack_arrays, aux, codes, qlens, best_col,
    scoring: ScoringParams, seed_params: SeedParams,
):
    """Pass 2: full-statistics banded DP over each read's CHOSEN
    candidate only ([B] rows — num_cands times less DP work than the
    single-pass path). Returns [B] planes: score, qstart, qend,
    matches, mismatches, gap_cols, gap_opens, tstart, tend."""
    B, L = codes.shape
    D = seed_params.band_width
    W = L + D - 1
    pack_offsets = pack_arrays["offsets"]
    winstart_b = jnp.take_along_axis(aux["winstart"], best_col[:, None],
                                     axis=1)           # [B, 1]
    strand_b = jnp.take_along_axis(aux["strand"], best_col[:, None],
                                   axis=1)[:, 0]       # [B]
    ref_win, seq_idx = gather_windows_packed(
        pack_arrays["words"], pack_arrays["nmask"], pack_offsets, winstart_b,
        window_len=W,
        center=winstart_b + D // 2 + qlens[:, None] // 2)  # [B,1,W], [B,1]
    q_best = jnp.where(strand_b[:, None] == 1, aux["rc"], codes)
    qpen_best = None
    if aux.get("qpen") is not None:
        qpen_best = jnp.where(strand_b[:, None] == 1,
                              reverse_batch(aux["qpen"], qlens), aux["qpen"])
    out = dispatch_banded_align(q_best, qlens, ref_win.reshape(B, W),
                                scoring, D, qpen_pair=qpen_best)
    seq_lo = pack_offsets[seq_idx[:, 0]].astype(jnp.int32)
    out["tstart"] = winstart_b[:, 0] + out["wstart"] - seq_lo
    out["tend"] = winstart_b[:, 0] + out["wend"] - seq_lo
    return out
