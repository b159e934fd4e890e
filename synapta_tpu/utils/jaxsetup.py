"""JAX runtime setup: the persistent compilation cache.

Call once at process start (pipeline, CLI, tests, bench) so repeated runs
never repay XLA compile time. Platform selection is JAX's own
(``JAX_PLATFORMS``); nothing here overrides it.
"""
from __future__ import annotations

import hashlib
import os
from typing import Mapping, Optional

_DONE = False

# fixed default: the cache key includes the directory, so it must not move
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def _host_fingerprint() -> str:
    """CPU model + flags of this host. CPU-backend cache entries are AOT
    code for the machine that wrote them; XLA derives scheduling features
    from the CPU model, so two hosts with identical flags but different
    models still produce incompatible entries."""
    try:
        with open("/proc/cpuinfo") as f:
            keep = ("flags", "model", "cpu family", "stepping", "vendor_id")
            lines = []
            for ln in f:
                if ln.startswith(keep):
                    lines.append(ln)
                if ln.strip() == "":
                    break  # first processor block is enough
            info = "".join(lines) or "unknown"
    except OSError:
        info = "unknown"
    return hashlib.sha256(info.encode()).hexdigest()[:12]


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """Where compiled programs persist: ``JAX_COMPILATION_CACHE_DIR`` when
    set (JAX reads it itself), else ``.jax_cache/`` in the checkout, with
    a per-host subdirectory for CPU-backend entries."""
    env = os.environ if environ is None else environ
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return env["JAX_COMPILATION_CACHE_DIR"]
    if env.get("JAX_PLATFORMS", "").startswith("cpu"):
        return os.path.join(DEFAULT_CACHE_DIR, f"cpu-{_host_fingerprint()}")
    return DEFAULT_CACHE_DIR


def setup_jax() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # the caller chose the cache: leave every setting to JAX
    import jax

    cache_dir = compile_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
