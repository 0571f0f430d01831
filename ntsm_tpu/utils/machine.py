"""Machine signature for ISA-specialized build/cache artifacts.

Two artifact classes are specialized to the building machine's vector
ISA and can SIGILL (not error) when loaded elsewhere: XLA:CPU's AOT
compile cache and the -march=native native runtime .so.  Both key their
on-disk names by this signature so a foreign artifact is simply not
found rather than fatally loaded.  The compile cache's location is chosen
here too.
"""

from __future__ import annotations

import functools
import hashlib
import os
import platform
import sys


@functools.lru_cache(maxsize=1)
def machine_signature() -> str:
    """12-hex digest of the CPU architecture + feature flags."""
    src = platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    src += line
                    break
    except OSError:
        pass
    return hashlib.sha1(src.encode()).hexdigest()[:12]


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_cache_dir(environ=os.environ) -> str | None:
    """The directory this program sets for XLA's persistent compile cache.

    None when JAX_COMPILATION_CACHE_DIR is set (JAX reads that variable
    itself, so the program sets no directory of its own) or when
    NTSM_NO_COMPILE_CACHE asks for no cache.  Otherwise one fixed path
    inside the checkout, `.jax_cache/xla-<machine signature>` (listed in
    .gitignore): the path is part of the cache's key, so it must not move
    between runs.  The signature keeps XLA:CPU's ISA-specialized entries
    from loading on another CPU (they can SIGILL there)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR") or environ.get(
        "NTSM_NO_COMPILE_CACHE"
    ):
        return None
    return os.path.join(_CHECKOUT, ".jax_cache", f"xla-{machine_signature()}")


def enable_compile_cache(environ=os.environ) -> str | None:
    """Point JAX at compile_cache_dir(); returns the directory, or None
    when the program set none.  A directory that cannot be created costs
    one warning on stderr and the run goes on without the cache."""
    path = compile_cache_dir(environ)
    if path is None:
        return None
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        print(f"ntsm_tpu: no compile cache ({path}: {e})", file=sys.stderr)
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
