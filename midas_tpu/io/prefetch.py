"""Host->device input pipeline: parse + upload overlapped with compute.

The reference overlaps stages with unix pipes between processes
(stream_seqs | hs-blastn, midas/run/species.py:29-49). The device
equivalent is a producer thread that parses FASTQ batches and issues
jax.device_put while the main thread's previous update step is still
executing on device — double/triple buffering bounded by a small queue.
jax dispatch is async, so the consumer only ever blocks on genuinely
missing input, and H2D for batch k+1 rides under compute for batch k.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


class DeviceBatch:
    """One uploaded batch: device arrays + the host-side bookkeeping the
    profilers need (counts for totals; names stay host-only).

    index is the batch's position in THIS consumer's stream (checkpoint
    bookkeeping counts consumed batches); global_index is its position
    in the SHARED single-process stream — they differ only under
    multi-host batch striding (dist/driver.stride_batches tags it), and
    it keys the ambiguous-read stream-order merge."""

    __slots__ = ("n_reads", "total_bp", "arrays", "index", "global_index")

    def __init__(self, n_reads: int, total_bp: int, arrays: tuple, index: int,
                 global_index: int = None):
        self.n_reads = n_reads
        self.total_bp = total_bp
        self.arrays = arrays
        self.index = index
        self.global_index = index if global_index is None else global_index


def prefetch_device_batches(
    batches: Iterator,
    fields: Sequence[str] = ("codes", "lengths"),
    prefetch: int = 3,
    trim: int = 0,
    skip_batches: int = 0,
) -> Iterator[DeviceBatch]:
    """Parse + device_put in a background thread, `prefetch` batches deep.

    fields: ReadBatch attributes to upload, in order (e.g. ("codes",
    "quals", "lengths", "mean_qual")). trim applies the reference's
    --trim3 semantics (genes.py:122) before upload. skip_batches parses
    and discards the first k batches without uploading (checkpoint
    resume: the stream is deterministic, so batch k+1 onward reproduce
    the original run exactly).

    Exceptions in the producer re-raise in the consumer. If the
    consumer abandons the generator early (break, or an exception in
    the consuming loop), the producer notices via a stop flag and
    terminates instead of blocking forever on a full queue."""
    import jax

    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for bi, batch in enumerate(batches):
                if stop.is_set():
                    return
                if bi < skip_batches:
                    continue
                if trim:
                    batch.lengths = np.maximum(
                        batch.lengths - trim, 0).astype(np.int32)
                    L = batch.codes.shape[1]
                    keep = np.arange(L)[None, :] < batch.lengths[:, None]
                    batch.codes[~keep] = 4
                    # the readq filter's mean quality is over the read
                    # as aligned (reference np.mean(aln.query_qualities)
                    # AFTER --trim3, midas/run/genes.py:122,160) — drop
                    # the trimmed bases' quals from the mean
                    qs = np.where(keep, batch.quals, 0).astype(np.float64)
                    n = np.maximum(batch.lengths, 1).astype(np.float64)
                    batch.mean_qual = (qs.sum(axis=1) / n).astype(np.float32)
                arrays = tuple(
                    jax.device_put(getattr(batch, f)) for f in fields
                ) + (jax.device_put(np.int32(batch.n_reads)),)
                total_bp = int(batch.lengths[: batch.n_reads].sum())
                if not _put(DeviceBatch(batch.n_reads, total_bp, arrays, bi,
                                        getattr(batch, "global_index", bi))):
                    return
            _put(END)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            _put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
