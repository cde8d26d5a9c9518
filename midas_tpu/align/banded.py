"""Banded affine-gap alignment, vectorized over (read, candidate) pairs.

This is the device replacement for the seed-extension inner loops of
bowtie2 and hs-blastn (reference hot loops: SURVEY.md §3.1-3.3). The DP
runs in diagonal-offset coordinates: for query row i, band offset
d ∈ [0, D) addresses reference position winstart + i + d, so the
diagonal predecessor keeps the same offset, the insertion predecessor is
offset d+1 in the previous row, and deletions become an intra-row
prefix-max scan (exact closed form of Gotoh's E recurrence — no lazy-F
iteration needed):

    D[d] = max_{d'<d} ( H_noD[d'] - gap_open - (d-d')*gap_extend )

which is a Kogge-Stone max-scan over A[d'] = H_noD[d'] + d'*gap_extend.

Alignment statistics (matches, mismatches, gap columns, gap opens,
start coordinates) are propagated along the argmax path as one stacked
[S, P, D] tensor — every selection is a single `where` with a broadcast
condition, keeping the scan body small enough for fast XLA compiles.
It is the plain reference for the CUDA kernel (align/banded_dp.cu),
which keeps the same state in registers and must match it bit for
bit.

Tie-break priority matches align/oracle.py: diagonal > deletion >
insertion; earliest row, then smallest offset, for equal best cells.

Stat plane order: 0 matches, 1 mismatches, 2 gap_cols, 3 gap_opens,
4 qstart row, 5 window-start column.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp

from midas_tpu.align.params import ScoringParams

NEG = -1e9
N_STATS = 6


def _shift_d(x: jnp.ndarray, shift: int, fill: float) -> jnp.ndarray:
    """Shift along the last (band) axis; positive shift moves data toward
    lower d (x_out[..., d] = x[..., d + shift])."""
    if shift == 0:
        return x
    pad_shape = x.shape[:-1] + (abs(shift),)
    pad = jnp.full(pad_shape, fill, x.dtype)
    if shift > 0:
        return jnp.concatenate([x[..., shift:], pad], axis=-1)
    return jnp.concatenate([pad, x[..., :shift]], axis=-1)


@functools.partial(jax.jit, static_argnames=("params", "band_width"))
def banded_align(
    query: jnp.ndarray,    # [P, L] int8 codes (4 = pad/sentinel)
    qlens: jnp.ndarray,    # [P] int32
    ref_win: jnp.ndarray,  # [P, W] int8 codes, W = L + band_width - 1
    params: ScoringParams,
    band_width: int = 16,
    qpen: jnp.ndarray = None,  # [P, L] positive per-base mismatch
    #                            penalties (bowtie2 --mp quality table,
    #                            params.mismatch_penalty); None = flat
) -> Dict[str, jnp.ndarray]:
    """Align each query against its reference window inside a band.

    Returns per-pair arrays: score, qstart, qend, wstart, wend (window
    coords), matches, mismatches, gap_cols, gap_opens. For pairs where
    no alignment exists (local mode, all-negative), score stays <= 0.

    With qpen, mismatch columns cost the per-query-base quality-scaled
    penalty; a read-N column (query code >= 4) costs params.n_pen and a
    ref code-4 column costs -params.mismatch (see ScoringParams
    docstring for the bowtie2 --mp/--np semantics and the ref-N
    deviation).
    """
    P, L = query.shape
    D = band_width
    assert ref_win.shape == (P, L + D - 1), (query.shape, ref_win.shape)
    local = params.mode == "local"
    ma, mi = float(params.match), float(params.mismatch)
    go_c, ge = float(params.gap_open), float(params.gap_extend)
    npen = float(params.n_pen)

    d_row = jnp.arange(D, dtype=jnp.float32)[None, :]           # [1, D]
    d_full = jnp.broadcast_to(d_row, (P, D))
    zeros_pd = jnp.zeros((P, D), jnp.float32)
    zeros_4pd = jnp.zeros((4, P, D), jnp.float32)
    qlens_f = qlens.astype(jnp.float32)

    init = (
        zeros_pd,                                   # H
        jnp.ones((P, D), jnp.bool_),                # H_fresh
        jnp.zeros((N_STATS, P, D), jnp.float32),    # H_st
        jnp.full((P, D), NEG, jnp.float32),         # I
        jnp.zeros((N_STATS, P, D), jnp.float32),    # I_st
        jnp.full((P,), NEG, jnp.float32),           # best
        jnp.zeros((P,), jnp.float32),               # best_i
        jnp.zeros((P,), jnp.float32),               # best_d
        jnp.zeros((N_STATS, P), jnp.float32),       # best_st
    )

    def step(state, i):
        Hp, Hp_fresh, Hp_st, Ip, Ip_st, best, best_i, best_d, best_st = state
        fi = i.astype(jnp.float32)
        q_i = jax.lax.dynamic_slice_in_dim(query, i, 1, axis=1)      # [P,1]
        r_i = jax.lax.dynamic_slice_in_dim(ref_win, i, D, axis=1)    # [P,D]
        is_match = ((q_i == r_i) & (q_i < 4) & (r_i < 4)).astype(jnp.float32)
        if qpen is None:
            sub = jnp.where(is_match > 0, ma, mi)
        else:
            qp_i = jax.lax.dynamic_slice_in_dim(
                qpen, i, 1, axis=1).astype(jnp.float32)              # [P,1]
            pen = jnp.where(q_i >= 4, npen,
                            jnp.where(r_i >= 4, -mi, qp_i))
            sub = jnp.where(is_match > 0, ma, -pen)

        # stats of a path starting with a diagonal move at row i, offset d
        fresh_st = jnp.concatenate([
            zeros_4pd,
            jnp.full((1, P, D), fi),            # qstart = i
            (fi + d_full)[None],                # wstart = i + d
        ])
        base_st = jnp.where(Hp_fresh[None], fresh_st, Hp_st)

        # --- diagonal move -------------------------------------------------
        T1 = Hp + sub
        T1_st = base_st + jnp.concatenate([
            is_match[None], (1.0 - is_match)[None],
            jnp.zeros((4, P, D), jnp.float32)])

        # --- insertion (consumes query; predecessor offset d+1, prev row) --
        Hp_shift = _shift_d(Hp, 1, NEG)
        Hp_fresh_shift = _shift_d(Hp_fresh, 1, False)
        Hp_st_shift = _shift_d(Hp_st, 1, 0.0)
        fresh_ins = jnp.concatenate([
            zeros_4pd,
            jnp.full((1, P, D), fi),            # qstart = i (the insertion)
            (fi + 1.0 + d_full)[None],          # first target col = i+1+d
        ])
        open_st = jnp.where(Hp_fresh_shift[None], fresh_ins, Hp_st_shift)
        Ip_shift = _shift_d(Ip, 1, NEG)
        Ip_st_shift = _shift_d(Ip_st, 1, 0.0)
        i_ext = Ip_shift - ge
        i_open = Hp_shift - go_c - ge
        take_ext = i_ext >= i_open
        I = jnp.where(take_ext, i_ext, i_open)
        I_st = jnp.where(take_ext[None], Ip_st_shift, open_st)
        gap_delta = jnp.concatenate([
            jnp.zeros((2, P, D), jnp.float32),
            jnp.ones((1, P, D), jnp.float32),                    # gc + 1
            jnp.where(take_ext, 0.0, 1.0)[None],                  # go + open
            jnp.zeros((2, P, D), jnp.float32)])
        I_st = I_st + gap_delta

        # --- pre-deletion best (scan input); diag wins ties over ins -------
        take_I = I > T1
        H_noD = jnp.where(take_I, I, T1)
        H_noD_st = jnp.where(take_I[None], I_st, T1_st)
        if local:
            clamp = H_noD <= 0.0
            H_noD = jnp.where(clamp, 0.0, H_noD)
            H_noD_st = jnp.where(clamp[None], 0.0, H_noD_st)
            scan_key = jnp.where(clamp, NEG, H_noD + d_row * ge)
        else:
            scan_key = H_noD + d_row * ge

        # --- deletion via exclusive prefix-max scan over the band ----------
        # payload: stats + origin offset d'
        pay = jnp.concatenate([H_noD_st, d_full[None]])
        A = scan_key
        shift = 1
        while shift < D:
            sA = _shift_d(A, -shift, NEG)
            sp = _shift_d(pay, -shift, 0.0)
            take = sA > A
            pay = jnp.where(take[None], sp, pay)
            A = jnp.where(take, sA, A)
            shift *= 2
        excl_A = _shift_d(A, -1, NEG)
        excl_p = _shift_d(pay, -1, 0.0)
        D_val = excl_A - go_c - d_row * ge
        gap_len = d_full - excl_p[N_STATS]
        D_st = excl_p[:N_STATS] + jnp.concatenate([
            jnp.zeros((2, P, D), jnp.float32),
            gap_len[None],
            jnp.ones((1, P, D), jnp.float32),
            jnp.zeros((2, P, D), jnp.float32)])

        # --- final H: priority diag > del > ins ----------------------------
        take_D = D_val > T1
        H = jnp.where(take_D, D_val, T1)
        H_st = jnp.where(take_D[None], D_st, T1_st)
        take_I2 = I > H
        H = jnp.where(take_I2, I, H)
        H_st = jnp.where(take_I2[None], I_st, H_st)
        if local:
            clamp = H <= 0.0
            H = jnp.where(clamp, 0.0, H)
            H_st = jnp.where(clamp[None], 0.0, H_st)
            H_fresh = clamp
        else:
            H_fresh = jnp.zeros((P, D), jnp.bool_)

        # --- track best ----------------------------------------------------
        if local:
            active = fi < qlens_f
            H_masked = jnp.where(active[:, None], H, NEG)
            row_best_d = jnp.argmax(H_masked, axis=1)
            row_best = jnp.max(H_masked, axis=1)
            improve = row_best > best
        else:
            row_best_d = jnp.argmax(H, axis=1)
            row_best = jnp.max(H, axis=1)
            improve = fi == (qlens_f - 1.0)
        picked = jnp.take_along_axis(
            H_st, row_best_d[None, :, None], axis=2)[:, :, 0]   # [S, P]
        best = jnp.where(improve, row_best, best)
        best_i = jnp.where(improve, fi, best_i)
        best_d = jnp.where(improve, row_best_d.astype(jnp.float32), best_d)
        best_st = jnp.where(improve[None], picked, best_st)

        return (H, H_fresh, H_st, I, I_st, best, best_i, best_d, best_st), None

    state, _ = jax.lax.scan(step, init, jnp.arange(L))
    _H, _Hf, _Hst, _I, _Ist, best, best_i, best_d, best_st = state

    return dict(
        score=best,
        qstart=best_st[4].astype(jnp.int32),
        qend=(best_i + 1.0).astype(jnp.int32),
        wstart=best_st[5].astype(jnp.int32),
        wend=(best_i + best_d + 1.0).astype(jnp.int32),
        matches=best_st[0].astype(jnp.int32),
        mismatches=best_st[1].astype(jnp.int32),
        gap_cols=best_st[2].astype(jnp.int32),
        gap_opens=best_st[3].astype(jnp.int32),
    )
