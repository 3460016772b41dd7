"""The JAX package's raising frontend, made to run on the installed jax.

``repro/core/raise.py`` imports ``jax.core.Literal`` (gone from jax 0.9:
it lives in ``jax.extend.core``) and inlines calls by the primitive name
``pjit`` (now ``jit``).  :func:`shim` patches the module object for the
length of a ``pytest.MonkeyPatch`` context, and nothing else: no file
changes, and every attribute is restored when the context ends, so
``tests/test_raise.py`` sees the module as it was in whatever order the
two files run in one worker.
"""

import contextlib
import importlib

import pytest


def _module():
    return importlib.import_module("repro.core.raise")


def apply(mp: pytest.MonkeyPatch):
    """Patch ``repro.core.raise`` through ``mp``; returns the module."""
    import jax
    import jax.extend.core
    import jax.numpy as jnp

    raising = _module()
    mp.setattr(raising, "_JaxLiteral", jax.extend.core.Literal)
    mp.setattr(raising, "jax", jax)
    mp.setattr(raising, "jnp", jnp)
    mp.setattr(raising, "_HAVE_JAX", True)
    mp.setattr(raising, "_CALL_PRIMS", raising._CALL_PRIMS | {"jit"})
    mp.setitem(raising._Raiser._HANDLERS, "jit", raising._Raiser._h_call)
    return raising


@contextlib.contextmanager
def shim():
    """The reference's raising module, patched while the block runs."""
    with pytest.MonkeyPatch.context() as mp:
        yield apply(mp)


def snapshot():
    """The attributes :func:`apply` touches, for restore checks."""
    raising = _module()
    return (raising._JaxLiteral, raising.jax, raising.jnp,
            raising._HAVE_JAX, raising._CALL_PRIMS,
            "jit" in raising._Raiser._HANDLERS)
