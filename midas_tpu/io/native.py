"""ctypes binding for the native batch reader (io/_native/midas_io.cpp).

The shared library is compiled on first use with g++ (-O3, linked
against zlib) into the checkout's build directory (runtime.build_dir()).
Callers must treat
availability as optional: `load_native()` returns None when no
compiler/zlib is present, and io.batch falls back to the pure-Python
parser (seqio.read_fastx).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Iterator, List, Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "_native", "midas_io.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[str]:
    from midas_tpu.runtime import build_dir

    so = os.path.join(build_dir(), "libmidas_io.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    tmp = so + f".tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError) as e:
        err = getattr(e, "stderr", b"")
        print(f"midas_tpu: native IO build failed ({e}; {err[-500:]}); "
              "using Python parser", file=sys.stderr)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def load_native() -> Optional[ctypes.CDLL]:
    """Compile (once) and dlopen the native reader; None on failure.
    MIDAS_TPU_NO_NATIVE_IO=1 disables it (tests / fallback exercise)."""
    global _LIB, _TRIED
    if os.environ.get("MIDAS_TPU_NO_NATIVE_IO"):
        return None
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.mio_open.restype = ctypes.c_void_p
        lib.mio_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_long]
        lib.mio_next_batch.restype = ctypes.c_long
        lib.mio_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mio_close.restype = None
        lib.mio_close.argtypes = [ctypes.c_void_p]
        lib.mio_truncated.restype = ctypes.c_long
        lib.mio_truncated.argtypes = [ctypes.c_void_p]
        lib.mio_max_read_len.restype = ctypes.c_long
        lib.mio_max_read_len.argtypes = [ctypes.c_char_p]
        _LIB = lib
        return _LIB


def native_max_read_len(paths) -> Optional[int]:
    """Longest read across the given files via a full native scan
    (mio_max_read_len); None when the native reader is unavailable or
    any file fails to parse (callers fall back to head sampling)."""
    lib = load_native()
    if lib is None:
        return None
    mx = 0
    for p in paths:
        n = lib.mio_max_read_len(str(p).encode())
        if n < 0:
            return None
        mx = max(mx, int(n))
    return mx


class NativeBatcher:
    """Stream fixed-shape batches from one or more FASTA/FASTQ files.

    Yields the same tuple contents as io.batch.batch_reads fills:
    (names, codes, lengths, quals, mean_qual, n_reads). The caller owns
    the arrays (fresh per batch — they are handed to jnp.asarray / kept
    by ReadBatch)."""

    def __init__(self, lib: ctypes.CDLL, paths: List[str],
                 batch_size: int, max_len: int,
                 read_length: Optional[int], max_reads: Optional[int]):
        self._lib = lib
        self._paths = list(paths)
        self._B = batch_size
        self._L = max_len
        self._rl = int(read_length or 0)
        self._remaining = -1 if max_reads is None else int(max_reads)
        self._h = None
        self._names_cap = batch_size * 256
        self.truncated = 0   # reads longer than max_len (counted in C)

    def _open_next(self) -> bool:
        while self._paths:
            p = self._paths.pop(0)
            h = self._lib.mio_open(p.encode(), self._rl,
                                   -1 if self._remaining < 0 else self._remaining)
            if not h:
                raise FileNotFoundError(p)
            self._h = h
            return True
        return False

    def close(self):
        if self._h:
            self.truncated += int(self._lib.mio_truncated(self._h))
            self._lib.mio_close(self._h)
            self._h = None

    def __iter__(self):
        try:
            if not self._open_next():
                return
            done = False
            while not done:
                codes = np.empty((self._B, self._L), dtype=np.int8)
                quals = np.empty((self._B, self._L), dtype=np.int8)
                lengths = np.empty(self._B, dtype=np.int32)
                mean_qual = np.empty(self._B, dtype=np.float32)
                filled = 0
                names: List[str] = []
                status = ctypes.c_int32(0)
                while filled < self._B:
                    want = self._B - filled
                    names_buf = ctypes.create_string_buffer(self._names_cap)
                    n = self._lib.mio_next_batch(
                        self._h, want, self._L,
                        codes.ctypes.data + filled * self._L,
                        quals.ctypes.data + filled * self._L,
                        lengths.ctypes.data + filled * 4,
                        mean_qual.ctypes.data + filled * 4,
                        names_buf, self._names_cap, ctypes.byref(status))
                    if n == -2:  # one name larger than the whole buffer
                        self._names_cap *= 4
                        continue
                    if n < 0:
                        raise IOError("native reader failed")
                    if n > 0:
                        names.extend(names_buf.value.decode().split("\n"))
                        filled += n
                        if self._remaining > 0:
                            self._remaining = max(self._remaining - n, 0)
                    if self._remaining == 0:
                        done = True
                        break
                    if status.value == 1:  # this file is exhausted
                        self.truncated += int(self._lib.mio_truncated(self._h))
                        self._lib.mio_close(self._h)
                        self._h = None
                        if not self._open_next():
                            done = True
                            break
                    # status 2 (names filled): loop again with a fresh
                    # names buffer; the pending record is emitted first
                if filled == 0:
                    return
                if filled < self._B:
                    codes[filled:] = 4
                    quals[filled:] = 0
                    lengths[filled:] = 0
                    mean_qual[filled:] = 0.0
                yield names, codes, lengths, quals, mean_qual, filled
        finally:
            self.close()
