"""Sparse device->host readback of the [4 x G] pileup count tensor.

The reference streams each species' pileup rows to disk as it goes
(midas/run/snps.py:164-216: count_coverage per contig, then a Python
row loop), so it never materializes a genome-scale transfer. Our
accumulator lives on device, and at Mb-scale genomes the end-of-stream
device->host pull can dominate the SNP pipeline wherever that link is
slow (a 50 MB genome is a 200 MB dense readback). Whether the encoding
still pays over the H100's PCIe link against the plain dense pull is
open (ROADMAP.md).

Shotgun pileups are sparse and nearly pure: most positions have depth
0; covered positions overwhelmingly have ALL reads agreeing on one
allele (disagreement needs a sequencing error or a SNP at depth >= 2).
The encoder exploits both:

- covered positions are transferred as RUNS (start, length) -- reads
  cover contiguous ~100 bp stretches, so runs number ~reads, not bases;
- each covered position contributes one allele byte (0-3, or the
  sentinel 4 when >1 allele has counts) and one depth value in the
  narrowest exact dtype;
- the rare impure positions spill (position, 4 counts) rows.

Compile-cost design: every XLA program here has a shape that depends
ONLY on the genome length G, never on the data. Phase A compacts the
covered/impure/run indices into G-sized buffers (hand-rolled
cumsum+scatter -- jnp.nonzero(size=n) lowers through a flat cumsum
whose compile time grows with G; the 2-level chunked scan compiles
fast); the host then pulls fixed-size PIECES of each stream with
dynamic_slice windows, so a new sample never triggers a recompile and
pieces transfer concurrently.

Decode is exact: byte-identical to the dense readback (tested in
tests/test_sparse_counts.py). When the encoding would not beat the
dense tiered transfer (deep or disagreement-heavy coverage of a small
genome), the dense path is used instead -- decided from phase A's
6-scalar stats readback.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

PIECE_COV = 1 << 19    # covered-position stream: 512k rows -> ~1 MB/piece
PIECE_IMP = 1 << 16    # impure rows: 64k x (pos + 4 counts)
PIECE_RUN = 1 << 15    # run (start, end) rows


def _cumsum_chunked(x: jnp.ndarray, chunk: int = 4096) -> jnp.ndarray:
    """Inclusive 1-D int32 cumsum as a two-level chunked scan (see
    module docstring: ~8x faster XLA compile than the flat scan at
    multi-million element counts, identical results)."""
    n = x.shape[0]
    nc = n // chunk
    if nc < 2:
        return jnp.cumsum(x)
    main = x[: nc * chunk].reshape(nc, chunk)
    within = jnp.cumsum(main, axis=1)
    totals = within[:, -1]
    offs = jnp.cumsum(totals) - totals
    out = (within + offs[:, None]).reshape(-1)
    if nc * chunk == n:
        return out
    tail = jnp.cumsum(x[nc * chunk:]) + out[-1]
    return jnp.concatenate([out, tail])


def _compact_full(mask: jnp.ndarray, pad: int, fill: int) -> jnp.ndarray:
    """Ascending positions of True, in a [n + pad] buffer padded with
    `fill` (pad rows keep dynamic_slice piece windows in bounds)."""
    n = mask.shape[0]
    rank = _cumsum_chunked(mask.astype(jnp.int32)) - 1
    dest = jnp.where(mask, rank, n + pad)
    out = jnp.full(n + pad + 1, fill, jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    return out[: n + pad]


@functools.partial(jax.jit, static_argnames=("G", "pads"))
def _phase_a(counts: jnp.ndarray, G: int,
             pads: tuple = (PIECE_COV, PIECE_IMP, PIECE_RUN),
             ) -> Dict[str, jnp.ndarray]:
    """One pass over the counts; every output shape depends only on G.

    stats: [6] i32 = (n_covered, n_impure, n_runs, max_depth,
    max_count, 0)."""
    c = counts.reshape(4, G + 1)[:, :G]
    depth = c.sum(axis=0)
    covered = depth > 0
    n_alleles = (c > 0).sum(axis=0)
    pure = n_alleles <= 1
    amax = jnp.argmax(c, axis=0).astype(jnp.uint8)
    allele = jnp.where(pure, amax, jnp.uint8(4))
    prev = jnp.concatenate([jnp.zeros(1, jnp.bool_), covered[:-1]])
    nxt = jnp.concatenate([covered[1:], jnp.zeros(1, jnp.bool_)])
    stats = jnp.stack([
        covered.sum(dtype=jnp.int32),
        (n_alleles > 1).sum(dtype=jnp.int32),
        (covered & ~prev).sum(dtype=jnp.int32),
        depth.max(),
        c.max(),
        jnp.zeros((), jnp.int32),
    ]).astype(jnp.int32)
    pc, pi, pr = pads
    return dict(
        depth=depth.astype(jnp.int32),
        allele=allele,
        cov_idx=_compact_full(covered, pc, fill=G),
        imp_idx=_compact_full(n_alleles > 1, pi, fill=G),
        run_start=_compact_full(covered & ~prev, pr, fill=G),
        run_end=_compact_full(covered & ~nxt, pr, fill=G - 1),
        stats=stats,
    )


@functools.partial(jax.jit, static_argnames=("ddt", "piece"))
def _piece_cov(depth, allele, cov_idx, start, ddt, piece: int):
    idx = jax.lax.dynamic_slice_in_dim(cov_idx, start, piece)
    gi = jnp.minimum(idx, depth.shape[0] - 1)
    return depth[gi].astype(ddt), allele[gi]


@functools.partial(jax.jit, static_argnames=("G", "idt", "piece"))
def _piece_imp(counts, imp_idx, start, G: int, idt, piece: int):
    c = counts.reshape(4, G + 1)[:, :G]
    idx = jax.lax.dynamic_slice_in_dim(imp_idx, start, piece)
    gi = jnp.minimum(idx, G - 1)
    return idx, c[:, gi].T.astype(idt)


@functools.partial(jax.jit, static_argnames=("piece",))
def _piece_run(run_start, run_end, start, piece: int):
    s = jax.lax.dynamic_slice_in_dim(run_start, start, piece)
    e = jax.lax.dynamic_slice_in_dim(run_end, start, piece)
    return s, e


def _val_dtype(mx: int):
    if mx < 2 ** 8:
        return jnp.uint8
    if mx < 2 ** 15:
        return jnp.int16
    return jnp.int32


def _expand_runs(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Covered-run (start, len) pairs -> flat position vector."""
    cum = np.concatenate([[0], np.cumsum(lens)])
    total = int(cum[-1])
    return (np.arange(total, dtype=np.int64)
            + np.repeat(starts.astype(np.int64) - cum[:-1], lens))


def _dense_host(counts: jnp.ndarray, G: int, mx: int) -> np.ndarray:
    dt = _val_dtype(mx)
    counts = counts.at[G].set(0)   # dump slot would defeat the tiering
    h = jax.device_get(counts.astype(dt) if dt != jnp.int32 else counts)
    return np.asarray(h).astype(np.int32)


def counts_host_sparse(counts: jnp.ndarray, G: int,
                       concurrency: int = 8,
                       pieces: Tuple[int, int, int] = (PIECE_COV, PIECE_IMP,
                                                      PIECE_RUN),
                       ) -> np.ndarray:
    """Pull a flat [4*(G+1)] pileup count tensor to host through the
    cheapest exact route (sparse piece streams or the dense tiered
    transfer; one stats readback decides). The dump column (flat index
    G) is zero in the result either way."""
    if G == 0:
        return np.zeros(4, np.int32)
    pc, pi, pr = pieces
    pa = _phase_a(counts, G, pads=pieces)
    stats = np.asarray(jax.device_get(pa["stats"]))
    n_cov, n_imp, n_runs, max_depth, max_cnt = (int(x) for x in stats[:5])
    mx = max(max_depth, max_cnt)
    if n_cov == 0:
        return np.zeros(4 * (G + 1), np.int32)

    ddt = _val_dtype(max_depth)
    idt = _val_dtype(max_cnt)
    d_size = np.dtype(ddt).itemsize
    i_size = np.dtype(idt).itemsize

    def npieces(n, piece):
        return -(-n // piece)

    sparse_bytes = (npieces(n_cov, pc) * pc * (1 + d_size)
                    + npieces(n_runs, pr) * pr * 8
                    + npieces(n_imp, pi) * pi * (4 + 4 * i_size))
    dense_bytes = 4 * (G + 1) * np.dtype(_val_dtype(mx)).itemsize
    if sparse_bytes >= dense_bytes:
        return _dense_host(counts, G, mx)

    # dispatch every piece (async), then pull them concurrently
    jobs: List[Tuple[str, int, tuple]] = []
    for s in range(0, n_cov, pc):
        jobs.append(("cov", s, _piece_cov(pa["depth"], pa["allele"],
                                          pa["cov_idx"], s, ddt, pc)))
    for s in range(0, n_imp, pi):
        jobs.append(("imp", s, _piece_imp(counts, pa["imp_idx"], s, G,
                                          idt, pi)))
    for s in range(0, n_runs, pr):
        jobs.append(("run", s, _piece_run(pa["run_start"], pa["run_end"],
                                          s, pr)))

    with ThreadPoolExecutor(min(concurrency, len(jobs))) as ex:
        pulled = list(ex.map(
            lambda j: tuple(np.asarray(x) for x in jax.device_get(j[2])),
            jobs))

    depth = np.empty(n_cov, np.int32)
    allele = np.empty(n_cov, np.uint8)
    imp_pos = np.empty(n_imp, np.int64)
    imp_vals = np.empty((n_imp, 4), np.int32)
    starts = np.empty(n_runs, np.int64)
    ends = np.empty(n_runs, np.int64)
    for (kind, s, _), arrs in zip(jobs, pulled):
        if kind == "cov":
            k = min(pc, n_cov - s)
            depth[s:s + k] = arrs[0][:k]
            allele[s:s + k] = arrs[1][:k]
        elif kind == "imp":
            k = min(pi, n_imp - s)
            imp_pos[s:s + k] = arrs[0][:k]
            imp_vals[s:s + k] = arrs[1][:k]
        else:
            k = min(pr, n_runs - s)
            starts[s:s + k] = arrs[0][:k]
            ends[s:s + k] = arrs[1][:k]

    out = np.zeros((4, G + 1), np.int32)
    pos = _expand_runs(starts, ends - starts + 1)
    assert pos.shape[0] == n_cov, (pos.shape[0], n_cov)
    m = allele < 4
    out[allele[m].astype(np.int64), pos[m]] = depth[m]
    if n_imp:
        out[:, imp_pos] = imp_vals.T
    return out.reshape(-1)
