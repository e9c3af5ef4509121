#!/usr/bin/env python3
"""Mesh-against-one-rank loss trajectories of the port's train step.

The counterpart of ``scripts/pod_loss_check.py``. Runs K SGD steps of the
flagship MVLPT UPT model (CoOp 4 + deep VPT 4 + the 128-wide coupler, 100
classes) on the same GLOBAL batches twice: once on one rank in this
process, once on a ("data", "model") mesh of spawned ranks (one process a
rank, ``torch.distributed`` over a ``file://`` store), and asserts that
every rank's per-step losses coincide with the single rank's. Sharding
must not change the math beyond the order of sums, so drift past the
tolerance means a sharding bug.

    # CPU rehearsal (tiny towers, fp32):
    python scripts/torch_port_pod_loss_check.py --device cpu --mesh 2,1
    python scripts/torch_port_pod_loss_check.py --device cpu --mesh 1,2 --kernels off
    # the card (ViT-B/16 at full width, bf16; two ranks share one card over gloo):
    python scripts/torch_port_pod_loss_check.py --mesh 1,2 --backbone b16 --kernels on off \
        --steps 3 --tol 0 --rtol 1e-3

``--kernels`` takes one or more ``TPU.USE_PALLAS`` selections, checked in
turn by the same processes: 'block' (the fused half-blocks; their
tensor-parallel parts under a model axis), 'on' (the standalone attention
on each rank's heads) or 'off' (the plain layers).
Each rank reports its losses, the kernel launches of its steps
(``ops._build.LAUNCHES``; the CPU runs the plain twins and counts none),
the rows each standalone-attention call took, its step times on the host
clock, the share of them spent in ``dist.all_reduce``, and its peak
memory on the card. Prints one JSON line (``--out`` writes it to a file
too) and exits non-zero when a loss is off.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
N_CLS = 100
OPTIM = dict(LR=0.002, LR_SCHEDULER="cosine", MAX_EPOCH=200)
# The tiny towers of the CPU rehearsal: the flagship's UPT model on a
# 2-layer ViT (patch 8 at 32 px, 2 heads) and a 2-layer text tower.
TINY = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=8, transformer_width=64, transformer_heads=2,
            transformer_layers=2, vision_heads_override=2)
JOIN_S = 600


def _model(args, kernels, device, mesh=None):
    import torch

    from mvlpt_torch.core.clip import CLIPConfig
    from mvlpt_torch.flagship import flagship

    dtype = torch.float32 if args.backbone == "tiny" else torch.bfloat16
    cfg = CLIPConfig(**TINY) if args.backbone == "tiny" else None
    model, backbone, pp, consts, _, clip_cfg = flagship(
        n_cls=N_CLS, batch=1 if mesh is None else mesh.n_data, compute_dtype=dtype,
        kernels=kernels, device=device, mesh=mesh, clip_cfg=cfg)
    return model, backbone, pp, consts, clip_cfg


def _batches(args, clip_cfg) -> list:
    rng = np.random.RandomState(0)
    res = clip_cfg.image_resolution
    return [{"image": rng.randn(args.batch, res, res, 3).astype(np.float32),
             "label": rng.randint(0, N_CLS, args.batch)} for _ in range(args.steps)]


def _steps(args, kernels, device, mesh=None) -> dict:
    """K SGD steps under ``kernels`` on the global batches (this data
    rank's rows under ``mesh``): losses, launches, attention rows, step
    and all-reduce seconds, peak GiB."""
    import torch
    import torch.distributed as dist

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
    from mvlpt_torch.ops import _build
    from mvlpt_torch.ops import attention
    from mvlpt_torch.train import init_train_state, make_train_step

    model, backbone, pp, consts, clip_cfg = _model(args, kernels, device, mesh)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in _batches(args, clip_cfg)]
    state = init_train_state(pp, optim_config(**OPTIM), 100)
    step = make_train_step(model, normalize=(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD), mesh=mesh)
    rows, reduce_s = set(), [0.0]
    attend, all_reduce = attention.attend_fwd, dist.all_reduce

    def attend_fwd(q, *a, **k):
        rows.add(int(q.shape[0]))
        return attend(q, *a, **k)

    def timed_all_reduce(*a, **k):
        t0 = time.perf_counter()
        try:
            return all_reduce(*a, **k)
        finally:
            reduce_s[0] += time.perf_counter() - t0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    attention.attend_fwd, dist.all_reduce = attend_fwd, timed_all_reduce
    try:
        sync()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _build.reset_launch_counts()
        losses, step_s, step_reduce_s = [], [], []
        for b in batches:
            reduce_s[0] = 0.0
            t0 = time.perf_counter()
            state, metrics = step(state, backbone, consts, b)
            losses.append(metrics["loss"].item())
            sync()
            step_s.append(time.perf_counter() - t0)
            step_reduce_s.append(reduce_s[0])
    finally:
        attention.attend_fwd, dist.all_reduce = attend, all_reduce
    peak = None
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        del model, backbone, batches, state, step
        torch.cuda.empty_cache()
    return dict(kernels=kernels, losses=losses,
                launches={k: v for k, v in _build.LAUNCHES.items() if v},
                attend_rows=sorted(rows), step_s=step_s, all_reduce_s=step_reduce_s,
                peak_mem_gib=peak, heads=clip_cfg.vision_heads,
                text_heads=clip_cfg.transformer_heads)


def _rank(rank: int, world: int, n_data: int, n_model: int, argv: list, workdir: str) -> None:
    """One spawned rank: joins the group, runs the steps on the mesh,
    writes rank{rank}.json (or rank{rank}.err with the traceback)."""
    import torch
    import torch.distributed as dist

    work = Path(workdir)
    try:
        sys.path.insert(0, str(ROOT))
        from mvlpt_torch.parallel import choose_backend, create_mesh

        args = _parser().parse_args(argv)
        device = torch.device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)
        backend, _ = choose_backend(device, world)
        dist.init_process_group(backend, init_method=f"file://{work / 'store'}", rank=rank,
                                world_size=world)
        mesh = create_mesh(n_data, n_model)
        out = [dict(_steps(args, k, device, mesh), backend=backend) for k in args.kernels]
        (work / f"rank{rank}.json").write_text(json.dumps(out))
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mesh", default="2,1", help="data,model axis sizes (2,1 / 1,2 / 2,2)")
    p.add_argument("--backbone", default="tiny", choices=["tiny", "b16"],
                   help="tiny: the CPU rehearsal's towers in fp32; b16: ViT-B/16 in bf16")
    p.add_argument("--kernels", nargs="+", default=["block"], choices=["block", "on", "off"])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch", type=int, default=-1,
                   help="the GLOBAL batch (default 2 a data rank for tiny, 32 for b16)")
    p.add_argument("--tol", type=float, default=1e-5, help="max |loss_mesh - loss_single|")
    p.add_argument("--rtol", type=float, default=0.0,
                   help="plus this times |loss_single| (the card's bf16 runs)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--workdir", default=str(ROOT / "build" / "torch_port_pod_loss_check"))
    p.add_argument("--out", default="", help="also write the JSON line to this file")
    return p


def main(argv=None) -> int:
    import shutil

    import torch
    import torch.multiprocessing as mp

    argv = sys.argv[1:] if argv is None else argv
    args = _parser().parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from mvlpt_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    n_data, n_model = (int(x) for x in args.mesh.split(","))
    if args.batch <= 0:
        args.batch = 2 * n_data if args.backbone == "tiny" else 32
        argv = [*argv, "--batch", str(args.batch)]
    work = Path(args.workdir) / f"{args.backbone}_{'_'.join(args.kernels)}_{n_data}x{n_model}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if not os.environ.get("MVLPT_TORCH_BPE_PATH"):
        from mvlpt_torch.tokenizer import write_synthetic_vocab

        os.environ["MVLPT_TORCH_BPE_PATH"] = str(work / "synthetic_bpe_vocab.txt.gz")
        write_synthetic_vocab(os.environ["MVLPT_TORCH_BPE_PATH"], seed=0)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    single = [_steps(args, k, device) for k in args.kernels]
    world = n_data * n_model
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, n_data, n_model, argv, str(work)))
             for r in range(world)]
    t0 = time.monotonic()
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(max(1.0, JOIN_S - (time.monotonic() - t0)))
    hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    errs = {r: (work / f"rank{r}.err").read_text() for r in range(world)
            if (work / f"rank{r}.err").is_file()}
    codes = [proc.exitcode for proc in procs]
    if hung or errs or codes != [0] * world:
        print(f"ranks failed: hung {hung}, exit codes {codes}, errors {errs}", file=sys.stderr)
        return 1
    by_rank = [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]
    checks = []
    for i, kernels in enumerate(args.kernels):
        ranks = [r[i] for r in by_rank]
        worst = max(abs(a - b) - args.rtol * abs(b)
                    for r in ranks for a, b in zip(r["losses"], single[i]["losses"]))
        checks.append(dict(kernels=kernels, single=single[i], ranks=ranks, max_excess=worst,
                           ok=bool(worst <= args.tol)))
    out = dict(mesh={"data": n_data, "model": n_model}, backbone=args.backbone,
               device=str(device), steps=args.steps, batch=args.batch, tol=args.tol,
               rtol=args.rtol, checks=checks, ok=all(c["ok"] for c in checks))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    for check in checks:
        print(f"{check['kernels']}: single {check['single']['losses']}")
        for r, got in enumerate(check["ranks"]):
            print(f"{check['kernels']}: rank {r} {got['losses']} (backend {got['backend']})")
    if not out["ok"]:
        bad = {c["kernels"]: c["max_excess"] for c in checks if not c["ok"]}
        print(f"LOSS CHECK FAILED: |delta| - rtol x |loss| reaches {bad} > {args.tol:g}",
              file=sys.stderr)
        return 1
    print("POD LOSS CHECK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
