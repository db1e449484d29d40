"""Process set-up shared by the entry points: the persistent compile
cache, and the description of the device a measurement ran on."""

from __future__ import annotations

import os
import shutil
import subprocess

# <checkout>/.jax_cache: a fixed path, because the path is part of the
# cache key and a directory that moves never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compilation_cache_dir():
    """Where compiled programs persist, or None when caching is off.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself);
    ``JAX_ENABLE_COMPILATION_CACHE=false`` turns the cache off; otherwise
    the checkout's ``.jax_cache``."""
    if os.environ.get("JAX_ENABLE_COMPILATION_CACHE", "").lower() in (
            "false", "0", "no"):
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def configure_from_env() -> None:
    """Point JAX's persistent compilation cache at
    :func:`compilation_cache_dir`. Entry points call this before their
    first compile."""
    cache_dir = compilation_cache_dir()
    if cache_dir is None:
        return
    import jax

    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, or
    "not available" where there is no ``nvidia-smi``. Runs as a child
    process that stays off JAX."""
    if shutil.which("nvidia-smi") is None:
        return "not available"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def device_report() -> dict:
    """The device a result was measured on, as JAX and nvidia-smi see it."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "count": len(devices),
        "name_power_limit": gpu_name_and_power_limit(),
    }
