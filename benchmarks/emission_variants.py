"""Emission-phase shootout: formulations of (B*T, 39) -> (B*T, S) Gaussian
log-densities, timed on the device JAX computes on.

Variants (all plain XLA):
  whiten         - ops/gaussian.gaussian_log_pdf (per-state whitening einsum,
                   HIGHEST; the f32 parity reference)
  quad/<tier>    - ops/gaussian.gaussian_log_pdf_quad: X2 = vec(x x^T) and ONE
                   (N, 1521) x (1521, S) product, at each emission_precision
                   tier of models/decoder.EMISSION_PRECISION

Each line names the device it ran on. No timing on the GPU is recorded here;
chip_smoke.py prints the emission times of the decode shapes.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def time_fn(fn, *args, reps=10, windows=3):
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def device_label() -> str:
    import jax

    d = jax.devices()[0]
    return f"{d.platform}/{d.device_kind} x{len(jax.devices())}"


def states_sweep():
    """whiten vs quad across state counts - the large-vocabulary view. The
    whitening path materializes a (frames, S, D) intermediate that grows
    linearly in S; the quad layout's X2 round trip is S-independent (the
    decoder exposes it as ContinuousDecoder(emissions="quad"))."""
    import jax
    import jax.numpy as jnp

    from cs304_tpu.ops.gaussian import (
        gaussian_log_pdf,
        gaussian_log_pdf_quad,
        make_gaussian_params,
        make_gaussian_quad_params,
    )

    rng = np.random.default_rng(0)
    d = 39
    n = 64 * 200
    frames = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    print(f"device {device_label()}")
    for s_states in (58, 128, 503, 1003):
        means = rng.normal(size=(s_states, d)).astype(np.float32)
        a = rng.normal(size=(s_states, d, d)).astype(np.float32) * 0.1
        covs = a @ a.transpose(0, 2, 1) + np.eye(d, dtype=np.float32)
        p = make_gaussian_params(jnp.asarray(means), jnp.asarray(covs))
        qp = make_gaussian_quad_params(jnp.asarray(means), jnp.asarray(covs))
        w = jax.jit(lambda fr, p=p: jnp.sum(gaussian_log_pdf(p, fr)))
        q = jax.jit(lambda fr, qp=qp: jnp.sum(gaussian_log_pdf_quad(qp, fr)))
        dt_w = time_fn(w, frames, reps=5)
        dt_q = time_fn(q, frames, reps=5)
        flops = n * s_states * d * d * 2
        print(f"S={s_states:5d}  whiten {dt_w*1e3:7.2f} ms "
              f"({flops/dt_w/1e12:5.2f} TF/s)   quad {dt_q*1e3:7.2f} ms "
              f"({flops/dt_q/1e12:5.2f} TF/s)   quad_speedup "
              f"{dt_w/dt_q:4.2f}x")


def main():
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_params
    from cs304_tpu.models.decoder import EMISSION_PRECISION
    from cs304_tpu.ops.gaussian import (
        gaussian_log_pdf,
        gaussian_log_pdf_quad,
        make_gaussian_params,
        make_gaussian_quad_params,
    )

    comp = _flagship_params()
    means = jnp.asarray(comp.means)
    covs = jnp.asarray(comp.covariances)
    b, t, d = 512, 151, 39
    rng = np.random.default_rng(0)
    frames = jnp.asarray(rng.normal(size=(b * t, d)).astype(np.float32))
    wp = make_gaussian_params(means, covs)
    qp = make_gaussian_quad_params(means, covs)

    variants = {"whiten": jax.jit(
        lambda fr: jnp.sum(gaussian_log_pdf(wp, fr)))}
    for tier, prec in EMISSION_PRECISION.items():
        variants[f"quad/{tier}"] = jax.jit(
            lambda fr, prec=prec: jnp.sum(
                gaussian_log_pdf_quad(qp, fr, precision=prec)))

    print(f"frames={b * t}  (B={b} T={t})  S={comp.num_states}  "
          f"device {device_label()}")
    for name, fn in variants.items():
        print(f"{name:16s} {time_fn(fn, frames) * 1e3:7.3f} ms")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--states-sweep", action="store_true",
                    help="whiten vs quad emissions at S=58..1003 "
                         "(the large-vocabulary decode lever)")
    if ap.parse_args().states_sweep:
        states_sweep()
    else:
        main()
