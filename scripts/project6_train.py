#!/usr/bin/env python
"""Embedded continuous training over all multi-digit transcripts, booting from
project5 checkpoints; interrupt-safe save (reference scripts/project6_train.py)."""
from _common import (
    run_main, adopt_checkpoint_frontend, base_parser, frontend_manifest,
    load_config, load_corpus,
)

from cs304_tpu.models.train_continuous import ContinuousTrainConfig, ContinuousTrainer
from cs304_tpu.ops.mfcc import mfcc_batch
from cs304_tpu.utils.checkpoint import load_models, save_models


def main() -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--out-dir", default=None,
                        help="output checkpoint dir (default <checkpoint>_continuous)")
    parser.add_argument("--min-digits", type=int, default=2)
    parser.add_argument("--max-digits", type=int, default=7)
    parser.add_argument("--state-dir", default=None,
                        help="save resumable trainer state here each iteration")
    parser.add_argument("--resume", action="store_true",
                        help="resume from --state-dir")
    parser.add_argument("--gmm-mixtures", type=int, default=0,
                        help="after embedded K=1 training, split each state "
                             "into K mixtures and refine with the embedded "
                             "GMM trainer (beyond-reference capability)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard the corpus over ALL local devices "
                             "(jax.sharding.Mesh; statistics psum across devices). "
                             "Single-device runs work too, for parity checks.")
    args = parser.parse_args()
    if args.resume and not args.state_dir:
        raise SystemExit("--resume requires --state-dir")
    cfg = load_config(args)
    corpus = load_corpus(args, cfg)
    out_dir = args.out_dir or f"{cfg.checkpoint_dir}_continuous"

    models = load_models(cfg.checkpoint_dir)
    adopt_checkpoint_frontend(cfg, args)  # boot checkpoint pins the front-end
    mcfg = cfg.frontend.mfcc_config()
    labeled = {}
    for n in range(args.min_digits, args.max_digits + 1):
        for transcript, utts in corpus.train_dataset.get_all_n_digits(n).items():
            labeled[transcript] = mfcc_batch(utts, cfg=mcfg)
    if not labeled:
        raise SystemExit("no multi-digit transcripts found in the train split")
    print(f"training on {len(labeled)} transcripts, "
          f"{sum(len(v) for v in labeled.values())} utterances")

    mesh = None
    if args.data_parallel:
        from cs304_tpu.parallel.data_parallel import make_mesh

        mesh = make_mesh()
        print(f"data-parallel mesh over {mesh.devices.size} device(s)")
    trainer = ContinuousTrainer(
        models,
        ContinuousTrainConfig(
            max_iterations=cfg.continuous.max_iterations,
            cov_reg=cfg.continuous.cov_reg,
            silence_bootstrap=cfg.continuous.silence_bootstrap,
            insert_silence=cfg.continuous.insert_silence,
            update=cfg.continuous.update,
        ),
        mesh=mesh,
    )
    if args.resume:
        start = trainer.resume(args.state_dir)
        print(f"resuming from iteration {start}")
    try:
        iters = trainer.train(labeled, checkpoint_dir=args.state_dir)
        print(f"finished after {iters} iterations")
    except KeyboardInterrupt:
        print("interrupted — saving current models")
    finally:
        final_models = trainer.models()
        if args.gmm_mixtures > 1:
            from cs304_tpu.models.train_continuous_gmm import (
                GMMContinuousTrainConfig,
                GMMContinuousTrainer,
                promote_to_gmm,
            )

            gmm_trainer = GMMContinuousTrainer(
                promote_to_gmm(final_models, args.gmm_mixtures),
                GMMContinuousTrainConfig(
                    max_iterations=cfg.continuous.max_iterations,
                    cov_reg=cfg.continuous.cov_reg,
                    insert_silence=cfg.continuous.insert_silence,
                ),
                mesh=mesh,
            )
            gmm_iters = gmm_trainer.train(labeled)
            print(f"GMM refinement (K={args.gmm_mixtures}) finished after "
                  f"{gmm_iters} iterations")
            final_models = gmm_trainer.models()
        save_models(final_models, out_dir, frontend=frontend_manifest(cfg),
                    tier="words", provenance={"script": "project6_train.py"})
        print(f"saved to {out_dir}")


if __name__ == "__main__":
    run_main(main)
