"""The banded affine-gap DP as a CUDA kernel for NVIDIA Hopper, called
through the XLA FFI (source: align/banded_dp.cu).

Drop-in for align/banded.py:banded_align on the GPU, bit-equal to it
(same float arithmetic and tie-breaks). The shared library is compiled
with nvcc for sm_90a on first use, into the checkout's build directory
(runtime.build_dir()); `python -m midas_tpu.align.banded_cuda` builds it
ahead of time. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from midas_tpu.align.params import ScoringParams

_SRC = os.path.join(os.path.dirname(__file__), "banded_dp.cu")
TARGET = "midas_banded_dp"
BAND_WIDTHS = (16,)          # band widths the library is compiled for
FULL_ROWS = ("qstart", "qend", "wstart", "wend", "matches", "mismatches",
             "gap_cols", "gap_opens")
SCORE_ROWS = ("qend", "wstart", "wend")
_LOCK = threading.Lock()
_REGISTERED = False


def _nvcc() -> str:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cuda}/bin and on PATH): the banded "
            "DP kernel cannot be built")
    return found


def build() -> str:
    """Compile banded_dp.cu into the build directory (skipped while the
    library is newer than its source) and return the library's path."""
    from midas_tpu.runtime import build_dir

    so = os.path.join(build_dir(), "libmidas_banded_dp.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "--fmad=false", "-shared",
           "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
           "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def register() -> None:
    """Build (once) and register the FFI target for the CUDA platform."""
    global _REGISTERED
    with _LOCK:
        if _REGISTERED:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.MidasBandedDp), platform="CUDA")
        _REGISTERED = True


def ffi_banded(query, qlens, ref_win, qpen, params: ScoringParams,
               band_width: int, score_only: bool):
    """The FFI call itself (no build, no registration): returns
    (score [P] f32, stats [len(rows), P] i32), the rows named by
    SCORE_ROWS in score-only mode and FULL_ROWS otherwise."""
    P, L = query.shape
    if band_width not in BAND_WIDTHS:
        raise ValueError(f"band_width={band_width}: the CUDA banded DP is "
                         f"compiled for {BAND_WIDTHS}")
    if ref_win.shape != (P, L + band_width - 1):
        raise ValueError(f"window shape {ref_win.shape} != "
                         f"{(P, L + band_width - 1)}")
    qual_pen = qpen is not None
    if qual_pen:
        if qpen.shape != (P, L):
            raise ValueError(f"qpen shape {qpen.shape} != {(P, L)}")
        qpen = qpen.astype(jnp.int8)
    else:
        qpen = jnp.zeros((1,), jnp.int8)
    rows = SCORE_ROWS if score_only else FULL_ROWS
    call = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((P,), jnp.float32),
         jax.ShapeDtypeStruct((len(rows), P), jnp.int32)))
    return call(
        query.astype(jnp.int8), qlens.astype(jnp.int32),
        ref_win.astype(jnp.int8), qpen,
        match=np.float32(params.match), mismatch=np.float32(params.mismatch),
        gap_open=np.float32(params.gap_open),
        gap_extend=np.float32(params.gap_extend),
        n_pen=np.float32(params.n_pen), band_width=np.int32(band_width),
        local=np.int32(params.mode == "local"),
        score_only=np.int32(score_only), qual_pen=np.int32(qual_pen))


def unpack(score, stats, score_only: bool) -> Dict[str, jnp.ndarray]:
    """(score, stats) of ffi_banded -> banded_align's dict of [P] arrays
    (its subset score/qend/wstart/wend in score-only mode)."""
    rows = SCORE_ROWS if score_only else FULL_ROWS
    out = {"score": score}
    out.update({k: stats[i] for i, k in enumerate(rows)})
    return out


@functools.partial(jax.jit, static_argnames=("params", "band_width",
                                             "score_only"))
def banded_align_cuda(query, qlens, ref_win, params: ScoringParams,
                      band_width: int = 16, score_only: bool = False,
                      qpen=None) -> Dict[str, jnp.ndarray]:
    """banded_align on the GPU: same arguments and outputs (only
    score/qend/wstart/wend with score_only=True)."""
    register()
    score, stats = ffi_banded(query, qlens, ref_win, qpen, params,
                              band_width, score_only)
    return unpack(score, stats, score_only)


if __name__ == "__main__":
    print(build())
