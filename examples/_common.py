"""Shared example-script plumbing: platform/precision flags, iteration table.

``--platform cpu`` pins JAX to the CPU in-process, before first device use,
and runs in float64; ``--platform gpu`` runs on the GPU in float32 and
fails when JAX finds none.
"""

from __future__ import annotations

import argparse


def make_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument(
        "--platform", default="cpu", choices=["cpu", "gpu"],
        help="'cpu' (float64, parity-grade) or 'gpu' (float32; fails "
        "without a GPU)",
    )
    ap.add_argument("--plot", action="store_true", help="show matplotlib plots")
    return ap


def setup_jax(args):
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    else:
        from collocfem_tpu.utils.device import require_gpu

        require_gpu()          # exits when JAX finds no GPU
    return jax


def print_history(history, cols, n_iters):
    """Reference-style per-iteration Newton trace (SURVEY.md §5 metrics)."""
    import numpy as np

    h = np.asarray(history)
    print(f"{'it':>4} " + " ".join(f"{c:>12}" for c in cols))
    for i in range(min(int(n_iters), h.shape[0])):
        print(f"{i:>4} " + " ".join(f"{v:>12.4e}" for v in h[i]))
