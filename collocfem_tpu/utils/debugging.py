"""Debug-build guards: NaN/inf checking through jitted solves.

SURVEY.md §5 "Race detection / sanitizers": on-device code has no threads of
its own; the rebuild's sanitizer tier is this module —
``jax.experimental.checkify`` wrappers that turn silent NaN/inf propagation
inside jitted solver loops into reported errors, for debug builds only (the
checks cost a few % and are off in production paths).
"""

from __future__ import annotations

import functools

import jax
from jax.experimental import checkify


def checkified(fn, *, errors=checkify.float_checks):
    """Wrap a jittable callable with NaN/inf (and index) checking.

    Returns ``wrapped(*args) -> (error, out)``; call ``error.throw()`` to
    raise on the first failed check, or inspect ``error.get()``.

    Example::

        solve_dbg = checkified(make_gn_solver(problem, opts))
        err, (z, stats) = solve_dbg(z0, data)
        err.throw()   # raises ValueError listing the first NaN site
    """
    checked = checkify.checkify(fn, errors=errors)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return checked(*args, **kwargs)

    return wrapped


def assert_all_finite(tree, name: str = "pytree") -> None:
    """Eager debug assert: every leaf of ``tree`` is finite."""
    import jax.numpy as jnp

    bad = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            if not bool(jnp.all(jnp.isfinite(leaf))):
                bad.append(jax.tree_util.keystr(path))
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
