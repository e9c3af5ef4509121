"""The ranks of the port's spawned mesh tests (tests/test_torch_port_mesh_*.py,
tests/test_torch_port_multihost.py).

A child process imports this module, not the test files: it runs the port
alone, never JAX. Each function is one rank's work, run by
``tests.torch_port_util.run_rank`` inside a gloo group over a ``file://``
store: it reads what the parent wrote under ``workdir`` and writes
``rank{r}.npz`` (or ``.json``).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

from tests import torch_port_tp_child as tp
from tests.torch_port_util import WriteProbe

def allgather(rank: int, workdir: str) -> None:
    from mvlpt_torch.parallel import allgather_tree

    tree = {"a": np.array([rank, rank + 1.5], np.float32), "b": [np.int64(3 * rank)],
            "c": (np.array([[rank == 1]]),)}
    out = allgather_tree(tree)
    np.savez(Path(workdir) / f"rank{rank}.npz", a=out["a"], b=out["b"][0], c=out["c"][0])


def plain(rank: int, n_data: int, n_model: int, workdir: str, vocab: str, sel: str) -> None:
    """``sel`` ('off' or 'on') on a mesh: one block's y and dx on this data
    rank's rows and this model rank's shard, the cached-text eval logits of
    the whole eval batch, and one SGD step of the tiny UPT step."""
    import torch

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.core import layers
    from mvlpt_torch.core.clip import CLIPConfig
    from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.ops.attention import select_attn_fn
    from mvlpt_torch.parallel import create_mesh, local_batch, shard_backbone, shard_blocks
    from mvlpt_torch.prompts import PromptSpec, build_prompt_consts
    from mvlpt_torch.train import init_train_state, make_cached_text_eval, make_train_step
    from mvlpt_torch.utils.tree import tree_leaves

    os.environ["MVLPT_TORCH_BPE_PATH"] = vocab
    work = Path(workdir)
    inputs = np.load(work / "inputs.npz")
    mesh = create_mesh(n_data, n_model)
    clip_cfg = CLIPConfig(**tp.DIMS)
    spec = PromptSpec(**tp.spec_kw(int(inputs["context_length"])))
    full = tp.unflatten(inputs, "bb")
    consts = build_prompt_consts([f"c{i}" for i in range(tp.N_CLS)], spec, full, torch.float32)
    backbone = shard_backbone(full, clip_cfg, mesh)
    p = shard_blocks(tp.unflatten(inputs, "blk"), tp.BLOCK_HEADS, n_model, mesh.model_rank)
    x = local_batch(torch.from_numpy(inputs["x"]), mesh)
    gy = local_batch(torch.from_numpy(inputs["gy"]), mesh)
    norm = (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
    out = {}
    kernels = select_attn_fn(sel, mesh=mesh)
    for name, mask in (("none", None), ("causal", torch.from_numpy(inputs["mask"]))):
        xr = x.clone().requires_grad_(True)
        y = layers.residual_block(xr, p, tp.BLOCK_HEADS, mask, kernels)
        (dx,) = torch.autograd.grad(y, xr, gy)
        out[f"y_{name}"], out[f"dx_{name}"] = y.detach().numpy(), dx.numpy()
    model = MVLPTModel(clip_cfg, spec, kernels=kernels, compute_dtype=torch.float32)
    pp = tp.unflatten(inputs, "pp")
    text_fn, eval_fn = make_cached_text_eval(model, normalize=norm, mesh=mesh)
    out["eval_logits"] = eval_fn(backbone, pp, text_fn(backbone, pp, consts),
                                 {"image": torch.from_numpy(inputs["eval_image"])}).numpy()
    state = init_train_state(pp, optim_config(**tp.OPTIM), steps_per_epoch=1)
    batch = {"image": torch.from_numpy(inputs["image"]),
             "label": torch.from_numpy(inputs["label"])}
    state, metrics = make_train_step(model, mesh=mesh)(state, backbone, consts, batch)
    out["loss"] = metrics["loss"].numpy()
    for i, leaf in enumerate(tree_leaves(state.prompt_params)):
        out[f"param{i}"] = leaf.detach().numpy()
    np.savez(work / f"rank{rank}.npz", **out)


def window(rank: int, n_data: int, n_model: int, workdir: str, vocab: str) -> None:
    """A K-step window of float batches under the mesh (capture=False) on
    this data rank's rows of each global batch (axis 1), and the eval
    step's logits of the whole uint8 eval batch."""
    import torch

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.core.clip import CLIPConfig
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.ops.attention import select_attn_fn
    from mvlpt_torch.parallel import create_mesh, local_batch_slice, shard_backbone
    from mvlpt_torch.prompts import PromptSpec, build_prompt_consts
    from mvlpt_torch.train import init_train_state, make_eval_step, make_train_step_multi
    from mvlpt_torch.utils.tree import tree_leaves

    os.environ["MVLPT_TORCH_BPE_PATH"] = vocab
    work = Path(workdir)
    inputs = np.load(work / "inputs.npz")
    meta = json.loads((work / "meta.json").read_text())
    mesh = create_mesh(n_data, n_model)
    clip_cfg = CLIPConfig(**tp.DIMS)
    spec = PromptSpec(**tp.spec_kw(int(inputs["context_length"])))
    full = tp.unflatten(inputs, "bb")
    consts = build_prompt_consts([f"c{i}" for i in range(tp.N_CLS)], spec, full, torch.float32)
    backbone = shard_backbone(full, clip_cfg, mesh)
    model = MVLPTModel(clip_cfg, spec, kernels=select_attn_fn(meta["kernels"], mesh=mesh),
                       compute_dtype=torch.float32)
    start, size = local_batch_slice(inputs["image"].shape[1], mesh)
    rows = slice(start, start + size)
    batches = {k: torch.from_numpy(inputs[k][:, rows]) for k in ("image", "label")}
    state = init_train_state(tp.unflatten(inputs, "pp"), optim_config(**meta["optim"]),
                             meta["spe"])
    step = make_train_step_multi(model, mesh=mesh, capture=False)
    state, m = step(state, backbone, consts, batches)
    out = {f"metric/{k}": v.numpy() for k, v in m.items()}
    for i, leaf in enumerate(tree_leaves(state.prompt_params)):
        out[f"param{i}"] = leaf.detach().numpy()
    eval_fn = make_eval_step(model, normalize=tuple(map(tuple, meta["norm"])), mesh=mesh)
    out["eval_logits"] = eval_fn(backbone, tp.unflatten(inputs, "pp"), consts,
                                 {"image": torch.from_numpy(inputs["eval_image"])}).numpy()
    np.savez(work / f"rank{rank}.npz", **out)


def cli(rank: int, workdir: str, vocab: str, env: dict, runs: list) -> None:
    """The port's CLI, ``main(args, device="cpu")``, once for each argv of
    ``runs`` (a list of [name, argv, out_dir]) on this rank. For each run:
    the per-step losses (the step builders wrapped, as
    tests/test_torch_port_trainer.py does), the ``results`` lines it
    printed, the paths it wrote under its output dir, the final prompt
    leaves by key, or the exception it raised."""
    import torch

    from mvlpt_torch.cli import train as cli_mod
    from mvlpt_torch.train import trainer as t_trainer

    os.environ["MVLPT_TORCH_BPE_PATH"] = vocab
    os.environ.update(env)
    work = Path(workdir)
    report = {}
    for name, argv, out_dir in runs:
        losses = []
        made = {k: getattr(t_trainer, k) for k in ("make_train_step", "make_train_step_multi")}

        def wrap(make):
            def build(*a, **k):
                step = make(*a, **k)

                def call(*sa, **sk):
                    state, metrics = step(*sa, **sk)
                    losses.extend(float(x) for x in metrics["loss"].detach().reshape(-1))
                    return state, metrics
                return call
            return build

        for k, make in made.items():
            setattr(t_trainer, k, wrap(make))
        log = work / f"{name}.rank{rank}.out"
        saved = sys.stdout
        entry = {}
        try:
            with open(log, "w") as f, WriteProbe(out_dir) as writes:
                sys.stdout = f
                try:
                    trainer = cli_mod.main(cli_mod.build_parser().parse_args(argv), device="cpu")
                    entry["prompts"] = {}
                    if getattr(trainer, "state", None) is not None:
                        from mvlpt_torch.checkpoint import flatten_params

                        entry["prompts"] = {k: np.asarray(v).tolist() for k, v in
                                            flatten_params(trainer.state.prompt_params).items()}
                except Exception as e:  # noqa: BLE001 (the parent holds the message)
                    entry["raised"] = f"{type(e).__name__}: {e}"
        finally:
            sys.stdout = saved
            for k, make in made.items():
                setattr(t_trainer, k, make)
        entry["losses"] = losses
        entry["writes"] = sorted(set(writes.paths))
        entry["results"] = [line[len("results "):].strip() for line in log.read_text().splitlines()
                            if line.startswith("results ")]
        report[name] = entry
        torch.distributed.barrier()
    (work / f"rank{rank}.json").write_text(json.dumps(report))
