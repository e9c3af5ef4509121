#!/usr/bin/env python3
"""Where an extraction's time goes, batch by batch, on one card.

    python3 scripts/torch_port_extract_timeline.py [--models vit_base_patch16_224 resnet50]

For each zoo model of chip_smoke.py's ZOO_MODELS (its full-width random
state dict, written as ``drive_zoo_extract`` writes it), on the test split
of chip_smoke.py's extraction task (EXTRACT_TASK, 1020 images, batch 128,
bf16, the model's input size and statistics), times each batch of a pass
on the host clock: the loader's ``next`` (decode and transform), the
dispatch (staging and launches) and the wait for the features. Two ways,
in turns (shipped, read-ahead, read-ahead, shipped):

- "shipped": ``utils.pipeline.pipelined_inference`` as the CLIs run it:
  batch i's features are read with ``.cpu()`` after batch i+1 is
  dispatched, on the one stream;
- "read-ahead": the same loop, but batch i's device-to-host copy is
  enqueued into pinned memory right after its dispatch, with an event,
  and the read waits on that event alone.

Also the loader's pass alone, and the tower alone on one staged batch
(median of chip_smoke.py's REPS CUDA-event runs). Prints one JSON line a
pass with the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def timed_pass(loader, dispatch, read_ahead: bool) -> dict:
    """One pass: per batch (next s, dispatch s, wait s), img/s."""
    import torch

    def start(dev):
        if not read_ahead:
            return dev, None
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def finish(pend):
        if pend[1] is None:
            pend[0].cpu()
        else:
            pend[1].synchronize()

    rows, pend, n = [], None, 0
    it = iter(loader)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        t1 = time.perf_counter()
        dev = start(dispatch(batch))
        t2 = time.perf_counter()
        if pend is not None:
            finish(pend)
        rows.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        pend, n = dev, n + batch["n_valid"]
    finish(pend)
    wall = time.perf_counter() - t_start
    return dict(images=n, wall_s=wall, img_per_s=n / wall,
                next_s=[r[0] for r in rows], dispatch_s=[r[1] for r in rows],
                wait_s=[r[2] for r in rows])


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--models", nargs="*", default=["vit_base_patch16_224", "resnet50"])
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.data.loader import DeviceStager, eval_mode
    from mvlpt_torch.data.managers import build_data_manager
    from mvlpt_torch.data.transforms import device_normalize
    from mvlpt_torch.models import zoo

    card = cs.card_line()
    data = cs.write_elevater_dataset(ROOT / "build" / "extract_features_data",
                                     tasks=[cs.EXTRACT_TASK], test=cs.EXTRACT_TEST)
    helpers = cs._test_helpers()
    cfg = get_cfg_default()
    cfg.DATASET.ROOT, cfg.DATASET.DATASET = str(data), cs.EXTRACT_TASK
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = cfg.DATALOADER.TEST.BATCH_SIZE = cs.LP_BATCH
    cfg.INPUT.SIZE = (224, 224)
    cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD = list(zoo._IMAGENET_MEAN), list(zoo._IMAGENET_STD)
    loader = eval_mode(build_data_manager(cfg, strict_classnames=False).test_loader)
    t0 = time.perf_counter()
    n = sum(b["n_valid"] for b in loader)
    print(json.dumps({"card": card, "loader_alone_img_per_s": n / (time.perf_counter() - t0)}),
          flush=True)
    for name in args.models:
        writer, kwargs, _ = cs.ZOO_MODELS[name]
        ckpt = ROOT / "build" / "zoo" / f"{name}.pth"
        ckpt.parent.mkdir(parents=True, exist_ok=True)
        torch.save(getattr(helpers, writer)(0, **kwargs), str(ckpt))
        model = zoo.get_model(name, checkpoint=str(ckpt), dtype=torch.bfloat16)
        mean, std = model.pixel_mean, model.pixel_std
        stager = DeviceStager("cuda")

        @torch.no_grad()
        def dispatch(batch):
            return model.features(device_normalize(stager({"image": batch["image"]})["image"],
                                                   mean, std))

        x = device_normalize(stager({"image": next(iter(loader))["image"]})["image"], mean, std)
        with torch.no_grad():
            tower_ms = cs.cuda_times(lambda: model.features(x))[0]
        for way in ("shipped", "read-ahead", "read-ahead", "shipped"):
            row = timed_pass(loader, dispatch, way == "read-ahead")
            print(json.dumps({"card": card, "model": name, "way": way, "tower_ms": tower_ms,
                              **row}), flush=True)
        del model
        cs._free_cuda()
    return 0


if __name__ == "__main__":
    sys.exit(main())
