"""Shared plumbing for the project scripts.

The reference scripts hardcode constants in-file (SURVEY.md §2.2); here every
script is an argparse CLI over cs304_tpu.utils.config.Config, with a
--synthetic switch that substitutes the generated corpus when the licensed
TI-Digits tree is absent.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cs304_tpu.utils.config import Config  # noqa: E402


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", help="JSON config file", default=None)
    p.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="KEY=VALUE", help="config override, e.g. decode.word_penalty=-250",
    )
    p.add_argument("--data-root", default=None, help="TI-Digits root directory")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument(
        "--synthetic", action="store_true",
        help="use the generated synthetic corpus instead of TI-Digits",
    )
    p.add_argument("--log-file", default="runtime.log")
    p.add_argument(
        "--platform", default=None, choices=["cpu", "gpu"],
        help="force the JAX platform (e.g. cpu with "
             "XLA_FLAGS=--xla_force_host_platform_device_count=8 to exercise "
             "--data-parallel on a virtual mesh without GPUs)",
    )
    return p


def load_config(args) -> Config:
    if getattr(args, "platform", None):
        # Must land before first backend use.
        import jax

        jax.config.update("jax_platforms", args.platform)
    from cs304_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = Config.from_file(args.config) if args.config else Config()
    if args.overrides:
        cfg.apply_overrides(args.overrides)
    if args.data_root:
        cfg.data_root = args.data_root
    if args.checkpoint_dir:
        cfg.checkpoint_dir = args.checkpoint_dir
    logging.basicConfig(
        filename=args.log_file, level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    logging.getLogger().addHandler(logging.StreamHandler())
    return cfg


def load_corpus(args, cfg: Config):
    """Returns an object with .train_dataset / .test_dataset."""
    if args.synthetic:
        from cs304_tpu.data.synthetic import SyntheticTIDigits

        return SyntheticTIDigits(num_train_speakers=6, num_test_speakers=2,
                                 takes_per_digit=3, with_sentences=True)
    from cs304_tpu.data.ti_digits import TIDigits

    if not cfg.data_root or not os.path.isdir(cfg.data_root):
        raise FileNotFoundError(
            f"TI-Digits root {cfg.data_root!r} not found — pass --data-root "
            "pointing at the corpus (…/Adults/TIDIGITS above TRAIN/TEST), or "
            "use --synthetic to run on the generated corpus"
        )
    return TIDigits(cfg.data_root)


def frontend_manifest(cfg: Config) -> dict:
    """Front-end facts a checkpoint must pin for decode-time feature parity."""
    return {"normalization": cfg.frontend.normalization}


def adopt_checkpoint_frontend(cfg: Config, args) -> None:
    """Adopt the checkpoint's recorded front-end settings into cfg.frontend.

    Models trained on CMVN features are useless on per-frame-normalized ones
    (and vice versa), so decoding scripts call this after load_config to make
    the checkpoint's manifest win — unless the user explicitly overrode the
    same key with --set frontend.<key>=...
    """
    from cs304_tpu.utils.checkpoint import load_manifest

    try:
        recorded = load_manifest(cfg.checkpoint_dir).get("frontend") or {}
    except OSError:
        return
    explicit = {
        o.partition("=")[0].strip().split(".", 1)[1]
        for o in getattr(args, "overrides", [])
        if o.partition("=")[0].strip().startswith("frontend.")
    }
    for key, value in recorded.items():
        if key not in explicit and hasattr(cfg.frontend, key):
            setattr(cfg.frontend, key, value)


def exact_accuracy(truths, preds) -> float:
    return sum(p == t for p, t in zip(preds, truths)) / max(len(truths), 1)


def run_main(main_fn) -> None:
    """Entry-point wrapper: user-facing errors become one-line messages with
    exit code 1 instead of tracebacks (set CS304_TRACEBACK=1 to debug)."""
    import os as _os

    try:
        main_fn()
    except KeyboardInterrupt:
        raise
    except (FileNotFoundError, ValueError, KeyError, RuntimeError) as e:
        if _os.environ.get("CS304_TRACEBACK"):
            raise
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(1)
