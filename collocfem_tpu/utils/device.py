"""Device checks for the entry points that must run on a GPU."""

from __future__ import annotations

import subprocess


def require_gpu():
    """Return ``jax.devices()`` when JAX's default backend is a GPU.

    Exits with a message otherwise: a measurement that finds no GPU fails,
    it does not fall back to the CPU.
    """
    import jax

    try:
        backend = jax.default_backend()
    except RuntimeError as e:
        raise SystemExit(f"no GPU backend: {e}") from e
    if backend != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX's default backend is {backend!r}"
        )
    return jax.devices()


def card_line() -> str:
    """The cards' ``name, power.limit`` as nvidia-smi reports them (one
    line per card, joined by '; ')."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())
