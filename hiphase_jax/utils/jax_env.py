"""Process-wide JAX settings for the device engine: where compiled programs
are cached, and which backend the device engine may run on."""

from __future__ import annotations

import os

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
# A fixed path: the directory is part of each cache entry's key, so a path
# that moved between runs would never hit.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def configure_compile_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and is
    the only cache; otherwise the cache lives at the fixed in-checkout
    ``DEFAULT_COMPILE_CACHE_DIR``."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)
    return DEFAULT_COMPILE_CACHE_DIR


def cpu_requested() -> bool:
    """True when the CPU backend was asked for explicitly, through
    ``JAX_PLATFORMS=cpu`` or ``jax.config.update("jax_platforms", "cpu")``."""
    import jax
    return (os.environ.get("JAX_PLATFORMS") == "cpu"
            or jax.config.jax_platforms == "cpu")


def require_accelerator() -> str:
    """Return JAX's default backend for the device engine. Raise
    ``SystemExit`` when it is the CPU and the CPU was not asked for, so a
    missing accelerator ends the run instead of running the device engine
    on the host unannounced."""
    import jax
    platform = jax.default_backend()
    if platform == "cpu" and not cpu_requested():
        raise SystemExit(
            "--engine device: JAX found no accelerator (default backend: "
            f"{platform!r}, devices: {jax.devices()}). Set JAX_PLATFORMS=cpu "
            "to run the device engine on the CPU on purpose.")
    return platform
