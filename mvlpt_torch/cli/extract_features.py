"""ELEVATER feature caching (the reference's
trainers/vision_benchmark/evaluation/feature.py:324-535), as
``mvlpt_tpu/cli/extract_features.py`` runs it for a CLIP backbone:

  * image features: the frozen CLIP visual tower over each split ->
    ``<out>/{train,val,test}.npz``, through ``models.zsclip.
    make_image_encoder``: on a ViT the no-grad half-block kernels (#5/#6)
    under TPU.USE_PALLAS, on an RN its plain tower;
  * text features: each class's prompt templates averaged over the
    task's template pool (``template_map``; a task outside metadata.json
    takes "a photo of a {}."), or with ``--knowledge`` the
    knowledge-augmented texts (``data/elevater/knowledge.py``), plus the
    ``--knowledge-tsv`` rows (``classname<TAB>description``) ->
    ``<out>/text.npz``.

An RN backbone's text step raises, as the JAX package's fails there:
its RNConfig has no text fields (``models.zsclip.text_config``). The
non-CLIP model zoo (``--model``) is not ported.

    python -m mvlpt_torch.cli.extract_features --root DATA --dataset cifar-10 \\
        --output-dir feats --knowledge wiki gpt3

Runs on the card; ``cli(argv, device="cpu")`` on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--dataset", required=True, help="ELEVATER task name")
    p.add_argument("--backbone", default="ViT-B/32")
    p.add_argument("--model", default=None,
                   help="non-CLIP zoo model (the JAX package's models/zoo.py): not ported")
    p.add_argument("--model-checkpoint", default=None, help="local torch state-dict for --model")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--shots", type=int, default=-1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--knowledge", nargs="*", default=[],
                   choices=["wiki", "wordnet", "hierarchy", "gpt3"],
                   help="built-in knowledge sources (data/elevater/knowledge.json) appended "
                        "to prompts")
    p.add_argument("--knowledge-aggregation", default="WIKI_AND_GPT3",
                   choices=["WIKI_AND_GPT3", "WIKI_THEN_GPT3"])
    p.add_argument("--n-gpt3", type=int, default=5)
    p.add_argument("--knowledge-tsv", nargs="*", default=[],
                   help="extra classname<TAB>description files")
    return p


def cli(argv=None, device="cuda"):
    import torch

    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.data.elevater import first_classname, template_map
    from mvlpt_torch.data.managers import build_data_manager
    from mvlpt_torch.models.zsclip import encode_class_text_features, make_image_encoder
    from mvlpt_torch.train.trainer import load_clip_backbone
    from mvlpt_torch.utils.device import resolve_device
    from mvlpt_torch.utils.pipeline import dump_split_features

    args = build_parser().parse_args(argv)
    if args.model:
        raise NotImplementedError(
            f"--model {args.model}: the non-CLIP model zoo (models/zoo.py, core/zoo.py) is not "
            "ported yet (ROADMAP.md Queue 1, item 10)")
    device = resolve_device(device)
    cfg = get_cfg_default()
    cfg.DATASET.ROOT = args.root
    cfg.DATASET.DATASET = args.dataset
    cfg.DATASET.NUM_SAMPLES_PER_CLASS = args.shots
    cfg.DATASET.RANDOM_SEED_SAMPLING = args.seed
    cfg.MODEL.BACKBONE.NAME = args.backbone
    cfg.DATALOADER.TEST.BATCH_SIZE = args.batch_size
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = args.batch_size
    cfg.freeze()
    backbone, clip_cfg = load_clip_backbone(cfg, torch.bfloat16, device)
    encode = make_image_encoder(clip_cfg, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
                                cfg.TPU.USE_PALLAS)
    dm = build_data_manager(cfg, strict_classnames=True)

    os.makedirs(args.output_dir, exist_ok=True)
    for split, loader in (("train", dm.train_loader_x), ("val", dm.val_loader),
                          ("test", dm.test_loader)):
        if loader is None:
            continue
        n = dump_split_features(
            loader, lambda b: encode(backbone, torch.from_numpy(b["image"]).to(device)),
            os.path.join(args.output_dir, f"{split}.npz"))
        print(f"{split}: {n} image features")

    # ---- text features: template averaging (+ optional knowledge rows)
    knowledge = {}
    for tsv in args.knowledge_tsv:
        with open(tsv) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    knowledge.setdefault(parts[0], []).append(parts[1])

    # The data manager's class names (the manifest's, else metadata.json's),
    # so a custom task with a self-describing manifest has text features too.
    classnames = [first_classname(c) for c in dm.classnames]
    try:
        templates = template_map(args.dataset)
    except KeyError:
        # a custom task: metadata.json has no template pool for it
        templates = ["a photo of a {}."]
        print(f"note: task {args.dataset!r} not in metadata.json — "
              f"using the default template 'a photo of a {{}}.'")
    if args.knowledge:
        from mvlpt_torch.data.elevater.knowledge import (
            encode_class_text_features_with_knowledge)

        text = encode_class_text_features_with_knowledge(
            backbone, clip_cfg, args.dataset, classnames, templates,
            sources=tuple(args.knowledge), n_gpt3=args.n_gpt3,
            aggregation=args.knowledge_aggregation)
    else:
        text = encode_class_text_features(backbone, clip_cfg, classnames, templates)
    if knowledge:
        extra = []
        for c in classnames:
            descs = knowledge.get(c, [])
            extra.append(f"{c}. {' '.join(descs)[:200]}" if descs else c)
        text = text + encode_class_text_features(backbone, clip_cfg, extra, ["a photo of a {}."])
        text = text / torch.linalg.norm(text, dim=-1, keepdim=True)
    np.savez(os.path.join(args.output_dir, "text.npz"),
             text_features=text.float().cpu().numpy(),
             classnames=np.asarray(classnames, object))
    print(f"text: {len(classnames)} classes x {len(templates)} templates")


if __name__ == "__main__":
    cli()
