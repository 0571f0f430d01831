"""The device engines' accelerator check.

When JAX's GPU plugin fails to load, JAX falls back to its CPU backend
without a word, and a device engine would then run on the host at a
fraction of its speed.  The device engines call `require_accelerator()`
where they start, so that fallback is an error unless the CPU was asked
for by name (``JAX_PLATFORMS=cpu``, as the tests do).  The golden and
exact host engines never call it.
"""

from __future__ import annotations

import os


class NoAcceleratorError(RuntimeError):
    """A device engine found only JAX's CPU backend."""


def require_accelerator(backend: str | None = None,
                        platforms: str | None = None) -> None:
    """Raise NoAcceleratorError when JAX's backend is the CPU and the
    requested platforms do not name ``cpu``.

    backend defaults to jax.default_backend(); platforms to
    JAX_PLATFORMS, else the jax_platforms setting."""
    import jax

    backend = jax.default_backend() if backend is None else backend
    if platforms is None:
        platforms = (os.environ.get("JAX_PLATFORMS")
                     or jax.config.jax_platforms or "")
    named = {p.strip().lower() for p in platforms.split(",")}
    if backend != "cpu" or "cpu" in named:
        return
    raise NoAcceleratorError(
        "ntsm: no GPU found — JAX is running on its CPU backend.  Check "
        "that JAX's CUDA plugin is installed and a GPU is visible, set "
        "JAX_PLATFORMS=cpu to run the device engines on the CPU on "
        "purpose, or use the host engines (ntsm count --engine golden, "
        "ntsm eval --engine exact)."
    )
