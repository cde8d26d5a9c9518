"""Process set-up shared by every entry point: where compiled programs
and built native libraries live, and the GPU check (with the card's
name and power limit) that measurements and on-card checks start with.

Both live inside the checkout (directories listed in .gitignore), at
fixed paths: JAX's persistent compilation cache is keyed on its
directory, so a path that moved between runs would never hit.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_dir() -> str:
    """Directory for shared libraries compiled from this package's C++
    and CUDA sources (io/_native, align/banded_dp.cu)."""
    d = os.path.join(CHECKOUT, ".build")
    os.makedirs(d, exist_ok=True)
    return d


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return it. JAX_COMPILATION_CACHE_DIR, when set, is used as it is
    and nothing else is set; otherwise the cache is <checkout>/.jax_cache."""
    import jax

    d = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
         or os.path.join(CHECKOUT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", d)
    return d


def card_info() -> str:
    """`name, power.limit` of the first GPU, as nvidia-smi reports them
    (a child process; JAX is not involved)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require_gpu(n_devices: int = 1):
    """JAX's default device, which must be a GPU (with at least
    n_devices of them); exits the process otherwise. Measurements and
    on-card checks call this instead of falling back to the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    if len(devs) < n_devices:
        raise SystemExit(f"need {n_devices} GPUs, JAX sees {len(devs)}")
    return devs[0]
