"""CLI entry point, flag-compatible with the JAX package's and the
reference's train.py.

The counterpart of ``mvlpt_tpu/cli/train.py``, with the same flags and
merge order (the reference's train.py:222-295), so run scripts translate
1:1:

    python -m mvlpt_torch.cli.train --trainer MVLPT --multi-task --dataset-coop \\
        --dataset "ImageNet,...,UCF101" --shots 16 \\
        --config-file configs/trainers/MVLPT/vit_b16.yaml \\
        --output-dir out --seed 1 TRAINER.MVLPT.COOP.N_CTX 4 ...

Config merge order: dataset-yaml < trainer-yaml < CLI flags < opts
(train.py:171-191). Runs on the card; ``main(args, device="cpu")`` runs
on the CPU. CoOp and ELEVATER datasets, CoCoOp, ``--act-ckpt``, the
zero-shot trainers, the fine-tune trainer (FinetuneCLIP), SGD, Adam, AdamW
and RMSprop, VPT dropout and ``--debug-nans`` run; what the port does not
run yet (a mesh, the data backends other than "python") raises, naming
its ROADMAP.md item.
"""

from __future__ import annotations

import argparse

from mvlpt_torch.config import get_cfg_default, validate_support
from mvlpt_torch.utils.logger import setup_logger
from mvlpt_torch.utils.seeding import set_random_seed


def reset_cfg(cfg, args):
    """CLI flags -> config keys (train.py:48-103)."""
    if args.root:
        cfg.DATASET.ROOT = args.root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.resume:
        cfg.RESUME = args.resume
    # Reference-faithful quirk (train.py:58-60 + :233 "only positive
    # value enables a fixed seed"): the argparse default -1 is truthy,
    # so omitting --seed OVERWRITES any config-file SEED with -1
    # (disabling the fixed seed), and --seed 0 is dropped. Kept as-is
    # so seed-sensitive runs reproduce the reference's selection.
    if args.seed:
        cfg.SEED = args.seed
        cfg.DATASET.RANDOM_SEED_SAMPLING = args.seed
    if args.source_domains:
        cfg.DATASET.SOURCE_DOMAINS = tuple(args.source_domains)
    if args.target_domains:
        cfg.DATASET.TARGET_DOMAINS = tuple(args.target_domains)
    if args.transforms:
        cfg.INPUT.TRANSFORMS = tuple(args.transforms)
    if args.trainer:
        cfg.TRAINER.NAME = args.trainer
    if args.backbone:
        cfg.MODEL.BACKBONE.NAME = args.backbone
    if args.head:
        cfg.MODEL.HEAD.NAME = args.head
    if args.dataset:
        cfg.DATASET.DATASET = args.dataset
        if args.dataset_coop and "," not in args.dataset:
            cfg.DATASET.NAME = args.dataset
    if args.shots:
        cfg.DATASET.NUM_SAMPLES_PER_CLASS = args.shots
        cfg.DATASET.NUM_SHOTS = args.shots
    if args.multi_task:
        cfg.DATASET.MULTITASK = True
    if args.multi_task_label_pertask:
        cfg.DATASET.MULTITASK_LABEL_PERTASK = True
    if args.dataset_coop:
        cfg.DATASET.COOP = True
    if args.cut_contextlen:
        cfg.TRAINER.CUT_CONTEXTLEN = True
    if args.act_ckpt:
        cfg.TRAINER.ACT_CKPT = args.act_ckpt
    if args.multi_task_evalkey != "average":
        cfg.DATASET.MULTITASK_EVALKEY = args.multi_task_evalkey


def setup_cfg(args):
    cfg = get_cfg_default()
    if args.dataset_config_file:
        cfg.merge_from_file(args.dataset_config_file)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    reset_cfg(cfg, args)
    cfg.merge_from_list(args.opts)
    validate_support(cfg)
    cfg.freeze()
    return cfg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="mvlpt_torch trainer")
    parser.add_argument("--root", type=str, default="", help="path to dataset")
    parser.add_argument("--output-dir", type=str, default="")
    parser.add_argument("--resume", type=str, default="",
                        help="checkpoint directory to resume from")
    parser.add_argument("--seed", type=int, default=-1)
    parser.add_argument("--source-domains", type=str, nargs="+")
    parser.add_argument("--target-domains", type=str, nargs="+")
    parser.add_argument("--transforms", type=str, nargs="+")
    parser.add_argument("--config-file", type=str, default="")
    parser.add_argument("--dataset-config-file", type=str, default="")
    parser.add_argument("--dataset", type=str, default="", help="name of task")
    parser.add_argument("--shots", type=int, help="few shot")
    parser.add_argument("--trainer", type=str, default="")
    parser.add_argument("--backbone", type=str, default="")
    parser.add_argument("--head", type=str, default="")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--model-dir", type=str, default="",
                        help="warm-start / eval-only model directory")
    parser.add_argument("--load-epoch", type=int)
    parser.add_argument("--no-train", action="store_true")
    parser.add_argument("--multi-task", action="store_true")
    parser.add_argument("--multi-task-label_pertask", dest="multi_task_label_pertask",
                        action="store_true")
    parser.add_argument("--multi-task-evalkey", type=str, default="average")
    parser.add_argument("--dataset-coop", action="store_true")
    parser.add_argument("--cut-contextlen", action="store_true")
    parser.add_argument("--act-ckpt", type=int, default=1)
    parser.add_argument("--debug-nans", action="store_true",
                        help="fail fast on NaNs (debug-mode equivalent of "
                             "the dormant TRAIN.DETECT_ANOMALY flag)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def main(args, device="cuda"):
    import torch

    from mvlpt_torch.train.trainer import build_trainer
    from mvlpt_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = setup_cfg(args)
    if cfg.SEED >= 0:
        print(f"Setting fixed seed: {cfg.SEED}")
        set_random_seed(cfg.SEED)
    setup_logger(cfg.OUTPUT_DIR)
    print(cfg.dump())
    if args.debug_nans:
        from mvlpt_torch.utils.profiler import enable_nan_debugging

        enable_nan_debugging()

    if device.type == "cuda":
        print(f"torch device: {device} ({torch.cuda.get_device_name(device)})")
    else:
        print(f"torch device: {device}")
    trainer = build_trainer(cfg, device=device)

    if args.eval_only:
        trainer.load_model(args.model_dir, epoch=args.load_epoch)
        trainer.test()
        return trainer
    if args.model_dir:  # warm start (target-task adaptation, train.py:215-218)
        trainer.load_model(args.model_dir, epoch=args.load_epoch)
    if not args.no_train:
        trainer.train()
    return trainer


def cli():
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli()
