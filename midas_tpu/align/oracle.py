"""NumPy gold-standard aligner: full (unbanded) affine-gap DP with
traceback. Slow, exact, and the semantic contract every device DP is
tested against. Replaces the role the reference's black-box binaries
played as "source of truth" (bowtie2 / hs-blastn, SURVEY.md §2.2) with
an explicit, testable specification.

Conventions shared with the device kernels:
- base codes 0-3 = ACGT; code 4 is a sentinel that never matches
  (scores as a mismatch).
- modes: 'local' = Smith-Waterman (free query + ref ends);
  'glocal' = whole query aligned, free ref ends (bowtie2 end-to-end
  analogue for reads inside a long reference).
- tie-break priority in the DP and traceback: diagonal > deletion
  (ref-consuming gap) > insertion (query-consuming gap); among equal
  end cells: smallest query end, then smallest ref end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from midas_tpu.align.params import ScoringParams

NEG = -10**9


@dataclasses.dataclass
class OracleAlignment:
    score: float
    qstart: int       # 0-based, half-open span of aligned query
    qend: int
    tstart: int       # 0-based, half-open span of aligned target
    tend: int
    matches: int
    mismatches: int
    gap_opens: int
    gap_cols: int     # total gap columns (insertions + deletions)
    col_qpos: np.ndarray  # per-column query pos or -1 (deletion)
    col_tpos: np.ndarray  # per-column target pos or -1 (insertion)

    @property
    def aln_cols(self) -> int:
        return self.matches + self.mismatches + self.gap_cols

    @property
    def nm(self) -> int:
        """Edit distance over the aligned span (SAM NM analogue)."""
        return self.mismatches + self.gap_cols

    @property
    def blast_pid(self) -> float:
        """%identity as BLAST m8 reports it: matches / alignment columns."""
        return 100.0 * self.matches / max(self.aln_cols, 1)

    @property
    def aligned_qlen(self) -> int:
        """len(query_alignment_sequence) analogue (genes.py:154)."""
        return self.qend - self.qstart

    @property
    def bowtie_pid(self) -> float:
        """100*(align_len-NM)/align_len with align_len = aligned query
        length, exactly as keep_read computes it (genes.py:157)."""
        alen = max(self.aligned_qlen, 1)
        return 100.0 * (alen - self.nm) / alen

    def qpos_to_tpos(self, qlen: int) -> np.ndarray:
        """[qlen] target position per query base, -1 where soft-clipped
        or inserted — the pileup contract (snps.py:186-199 analogue)."""
        out = np.full(qlen, -1, dtype=np.int64)
        for qp, tp in zip(self.col_qpos, self.col_tpos):
            if qp >= 0 and tp >= 0:
                out[qp] = tp
        return out


def align_oracle(
    query: np.ndarray,
    target: np.ndarray,
    params: ScoringParams,
    qpen: Optional[np.ndarray] = None,
) -> Optional[OracleAlignment]:
    """Full DP alignment of query vs target codes. Returns None when no
    positive-score local alignment exists (local mode only).

    qpen: optional [len(query)] positive per-base mismatch penalties
    (bowtie2 --mp quality scaling, params.mismatch_penalty); a read-N
    column costs params.n_pen and a ref code-4 column -params.mismatch
    (same rules as the device kernels — ScoringParams docstring)."""
    q = np.asarray(query, dtype=np.int64)
    t = np.asarray(target, dtype=np.int64)
    n, m = len(q), len(t)
    local = params.mode == "local"
    ma, mi = params.match, params.mismatch
    go, ge = params.gap_open, params.gap_extend
    npen = params.n_pen

    H = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int64)  # del: consumes target
    F = np.full((n + 1, m + 1), NEG, dtype=np.int64)  # ins: consumes query
    # direction codes: 0 diag, 1 del(E), 2 ins(F), 3 origin/stop
    Hdir = np.full((n + 1, m + 1), 3, dtype=np.int8)
    Edir = np.zeros((n + 1, m + 1), dtype=np.int8)  # 1 if extending E else opened from H
    Fdir = np.zeros((n + 1, m + 1), dtype=np.int8)

    H[0, :] = 0  # free ref prefix in both modes
    if not local:
        # query prefix consumed by insertion (rare; penalized)
        for i in range(1, n + 1):
            F[i, 0] = -(go + i * ge)
            H[i, 0] = F[i, 0]
            Hdir[i, 0] = 2
            Fdir[i, 0] = 1
    else:
        H[:, 0] = 0

    for i in range(1, n + 1):
        for j in range(1, m + 1):
            if q[i - 1] == t[j - 1] and q[i - 1] < 4 and t[j - 1] < 4:
                sub = ma
            elif qpen is None:
                sub = mi
            elif q[i - 1] >= 4:
                sub = -npen
            elif t[j - 1] >= 4:
                sub = mi
            else:
                sub = -int(qpen[i - 1])
            diag = H[i - 1, j - 1] + sub
            # E: gap consuming target (deletion), from the left
            e_ext = E[i, j - 1] - ge
            e_open = H[i, j - 1] - go - ge
            if e_ext >= e_open:
                E[i, j], Edir[i, j] = e_ext, 1
            else:
                E[i, j], Edir[i, j] = e_open, 0
            # F: gap consuming query (insertion), from above
            f_ext = F[i - 1, j] - ge
            f_open = H[i - 1, j] - go - ge
            if f_ext >= f_open:
                F[i, j], Fdir[i, j] = f_ext, 1
            else:
                F[i, j], Fdir[i, j] = f_open, 0
            # H: priority diag > del > ins
            best, d = diag, 0
            if E[i, j] > best:
                best, d = E[i, j], 1
            if F[i, j] > best:
                best, d = F[i, j], 2
            if local and best <= 0:
                best, d = 0, 3
            H[i, j], Hdir[i, j] = best, d

    return _finish(q, t, H, Hdir, Edir, Fdir, local)


def _finish(q, t, H, Hdir, Edir, Fdir, local) -> Optional[OracleAlignment]:
    """End-cell selection + traceback + column stats, shared by the
    scalar and batched fills (identical tie semantics: smallest query
    end then smallest ref end; diag > del > ins during traceback)."""
    n, m = len(q), len(t)
    if local:
        score = int(H.max())
        if score <= 0:
            return None
        ends = np.argwhere(H == score)
        ei, ej = ends[0]  # smallest i then j
    else:
        score = int(H[n, :].max())
        ej = int(np.argmin(np.where(H[n, :] == score, np.arange(m + 1), m + 2)))
        ei = n

    # traceback
    cols_q, cols_t = [], []
    i, j = int(ei), int(ej)
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            d = Hdir[i, j]
            if d == 3:
                break
            if d == 0:
                cols_q.append(i - 1)
                cols_t.append(j - 1)
                i, j = i - 1, j - 1
                if local and H[i, j] == 0 and Hdir[i, j] == 3:
                    break
            elif d == 1:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            cols_q.append(-1)
            cols_t.append(j - 1)
            prev = Edir[i, j]
            j -= 1
            state = "E" if prev == 1 else "H"
        else:  # F
            cols_q.append(i - 1)
            cols_t.append(-1)
            prev = Fdir[i, j]
            i -= 1
            state = "F" if prev == 1 else "H"
        if not local and i == 0:
            break
    cols_q.reverse()
    cols_t.reverse()
    col_qpos = np.asarray(cols_q, dtype=np.int64)
    col_tpos = np.asarray(cols_t, dtype=np.int64)

    matches = mismatches = gap_cols = gap_opens = 0
    in_gap = False
    for qp, tp in zip(col_qpos, col_tpos):
        if qp < 0 or tp < 0:
            gap_cols += 1
            if not in_gap:
                gap_opens += 1
                in_gap = True
        else:
            in_gap = False
            if q[qp] == t[tp] and q[qp] < 4:
                matches += 1
            else:
                mismatches += 1

    qcols = col_qpos[col_qpos >= 0]
    tcols = col_tpos[col_tpos >= 0]
    return OracleAlignment(
        score=float(score),
        qstart=int(qcols.min()) if len(qcols) else 0,
        qend=int(qcols.max()) + 1 if len(qcols) else 0,
        tstart=int(tcols.min()) if len(tcols) else 0,
        tend=int(tcols.max()) + 1 if len(tcols) else 0,
        matches=matches,
        mismatches=mismatches,
        gap_opens=gap_opens,
        gap_cols=gap_cols,
        col_qpos=col_qpos,
        col_tpos=col_tpos,
    )


def align_oracle_batch(queries, targets, params: ScoringParams,
                       qpens=None):
    """Batched oracle: identical semantics to align_oracle for every
    (query, target) pair, with the DP fill vectorized across the batch
    and along anti-diagonal wavefronts (the per-cell Python loop above
    costs ~25 ms per 100x116 problem; the SNP pipeline's end-of-stream
    gapped-read traceback feeds hundreds of reads through here, so the
    fill is the hot path — tested cell-equivalent in
    tests/test_oracle.py::test_batch_oracle_matches_scalar).

    queries/targets: sequences of int8 code arrays (ragged).
    qpens: optional sequence of per-query positive mismatch-penalty
    arrays (align_oracle's qpen, same N rules).
    Returns a list of Optional[OracleAlignment], one per pair."""
    R = len(queries)
    if R == 0:
        return []
    local = params.mode == "local"
    ma, mi = params.match, params.mismatch
    go, ge = params.gap_open, params.gap_extend
    npen = params.n_pen
    ns = np.array([len(q) for q in queries])
    ms = np.array([len(t) for t in targets])
    N, M = int(ns.max()), int(ms.max())
    qpad = np.full((R, N), 4, dtype=np.int64)
    tpad = np.full((R, M), 4, dtype=np.int64)
    qpen_pad = None
    if qpens is not None:
        qpen_pad = np.full((R, N), -mi, dtype=np.int64)
        for r, qp in enumerate(qpens):
            qpen_pad[r, : len(qp)] = np.asarray(qp, dtype=np.int64)
    for r, (q, t) in enumerate(zip(queries, targets)):
        qpad[r, : len(q)] = np.asarray(q, dtype=np.int64)
        tpad[r, : len(t)] = np.asarray(t, dtype=np.int64)

    H = np.full((R, N + 1, M + 1), NEG, dtype=np.int64)
    E = np.full((R, N + 1, M + 1), NEG, dtype=np.int64)
    F = np.full((R, N + 1, M + 1), NEG, dtype=np.int64)
    Hdir = np.full((R, N + 1, M + 1), 3, dtype=np.int8)
    Edir = np.zeros((R, N + 1, M + 1), dtype=np.int8)
    Fdir = np.zeros((R, N + 1, M + 1), dtype=np.int8)

    H[:, 0, :] = 0
    if not local:
        ii = np.arange(1, N + 1)
        F[:, ii, 0] = -(go + ii * ge)
        H[:, ii, 0] = F[:, ii, 0]
        Hdir[:, ii, 0] = 2
        Fdir[:, ii, 0] = 1
    else:
        H[:, :, 0] = 0

    # anti-diagonal wavefront: every cell (i, j) with i + j == d depends
    # only on cells at d-1 / d-2, so each diagonal fills in one shot.
    # Cells beyond a pair's true (n, m) compute garbage that the finish
    # step never reads (dependencies only flow toward larger i, j).
    for d in range(2, N + M + 1):
        i = np.arange(max(1, d - M), min(N, d - 1) + 1)
        if len(i) == 0:
            continue
        j = d - i
        sub = np.where(
            (qpad[:, i - 1] == tpad[:, j - 1]) & (qpad[:, i - 1] < 4),
            ma, mi)
        diag = H[:, i - 1, j - 1] + sub
        e_ext = E[:, i, j - 1] - ge
        e_open = H[:, i, j - 1] - go - ge
        e_take_ext = e_ext >= e_open
        Ev = np.where(e_take_ext, e_ext, e_open)
        E[:, i, j] = Ev
        Edir[:, i, j] = e_take_ext.astype(np.int8)
        f_ext = F[:, i - 1, j] - ge
        f_open = H[:, i - 1, j] - go - ge
        f_take_ext = f_ext >= f_open
        Fv = np.where(f_take_ext, f_ext, f_open)
        F[:, i, j] = Fv
        Fdir[:, i, j] = f_take_ext.astype(np.int8)
        best = diag
        dcode = np.zeros_like(sub, dtype=np.int8)
        m1 = Ev > best
        best = np.where(m1, Ev, best)
        dcode = np.where(m1, np.int8(1), dcode)
        m2 = Fv > best
        best = np.where(m2, Fv, best)
        dcode = np.where(m2, np.int8(2), dcode)
        if local:
            m3 = best <= 0
            best = np.where(m3, 0, best)
            dcode = np.where(m3, np.int8(3), dcode)
        H[:, i, j] = best
        Hdir[:, i, j] = dcode

    out = []
    for r in range(R):
        n, m = int(ns[r]), int(ms[r])
        out.append(_finish(
            qpad[r, :n], tpad[r, :m],
            H[r, : n + 1, : m + 1], Hdir[r, : n + 1, : m + 1],
            Edir[r, : n + 1, : m + 1], Fdir[r, : n + 1, : m + 1], local))
    return out
