"""The driver's compile-check hook (`__graft_entry__.entry`) must stay green.

The driver calls `entry()` and jit-compiles the returned function on one
chip; `dryrun_multichip(n)` is exercised separately (on n devices, real or
virtual, and by the mesh-parity tests). This guards the cheap half in the
fast tier so a refactor can't silently break the hook between rounds.
"""

import jax
import jax.numpy as jnp
import pytest

import __graft_entry__ as graft


def test_entry_returns_jittable_fn_and_args():
    fn, args = graft.entry()
    assert callable(fn)
    assert isinstance(args, tuple) and args
    # Every example arg must be a concrete array-like with static shape.
    for a in jax.tree_util.tree_leaves(args):
        assert hasattr(jnp.asarray(a), "shape")
    compiled = jax.jit(fn).lower(*args).compile()
    assert compiled is not None


def test_dryrun_symbol_present():
    assert callable(graft.dryrun_multichip)


def test_dryrun_needs_its_devices():
    """Too few devices is an error, never a silent switch to another mesh."""
    with pytest.raises(RuntimeError, match="sees only"):
        graft.dryrun_multichip(len(jax.devices()) + 1)
