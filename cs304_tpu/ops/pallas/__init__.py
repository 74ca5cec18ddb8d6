"""GPU kernels for the hot ops, and the one switch that says where they run.

The kernels here are Pallas kernels on the Triton route: they compile for
the GPU only. Elsewhere they run only when a caller (a test) asks for the
Pallas interpreter with interpret=True.
"""
import jax

PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """The JAX backend this process computes on: "gpu" or "cpu"."""
    name = jax.default_backend()
    if name not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX backend {name!r}: expected one of {PLATFORMS}"
        )
    return name


def has_kernels() -> bool:
    """True where the Pallas kernels compile."""
    return platform() == "gpu"
