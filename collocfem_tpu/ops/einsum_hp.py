"""Full-precision einsum for the solver-critical contractions.

On an NVIDIA GPU, XLA may run a float32 matrix product on the tensor cores
in *TF32* (10-bit mantissa, ~3 decimal digits) at the default precision —
fine for neural nets, catastrophic for Gauss-Newton assembly and block
factorizations: the KKT system loses digits and the damped solver stalls.
Every numerically-critical contraction in this package goes through
:func:`einsum_hp`, which pins ``Precision.HIGHEST`` (full f32) regardless
of the global ``jax_default_matmul_precision`` setting.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def einsum_hp(subscripts, *operands, **kwargs):
    """jnp.einsum pinned to Precision.HIGHEST (full f32, never TF32)."""
    kwargs.setdefault("precision", jax.lax.Precision.HIGHEST)
    return jnp.einsum(subscripts, *operands, **kwargs)
