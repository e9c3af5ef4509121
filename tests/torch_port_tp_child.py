"""One rank of the spawned tensor-parallel runs of tests/test_torch_port_tp.py.

A child process imports this module, not the test file: it runs the port
alone, never JAX. The parent writes the inputs (the tiny UPT config's
weights, as carried over from the JAX side, and the batches) to
``inputs.npz``; each rank runs on a gloo mesh over the CPU and writes
``rank{r}.npz``, or ``rank{r}.err`` with its traceback.
"""

from __future__ import annotations

import os
import traceback
from pathlib import Path

import numpy as np

# The tiny UPT config of tests/test_torch_port_slice.py.
N_CLS, BATCH = 20, 4
DIMS = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=8, transformer_width=64, transformer_heads=2,
            transformer_layers=2, vision_heads_override=2)
OPTIM = dict(LR=0.05, LR_SCHEDULER="cosine", MAX_EPOCH=4)
BLOCK_HEADS = 4  # heads of the single-block checks


def spec_kw(context_length: int) -> dict:
    return dict(n_cls=N_CLS, coop_n_ctx=2, vpt_n_ctx=2, vpt_deep=True,
                class_token_position="middle", project_method="transformer", project_dim=16,
                context_length=context_length, vision_layers=2, vision_width=64, text_width=64,
                embed_dim=32, vision_patch_size=8)


def flatten(tree: dict, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def unflatten(arrays, prefix: str) -> dict:
    """The tree under ``prefix`` of an npz written from :func:`flatten`, as
    CPU tensors."""
    import torch

    tree: dict = {}
    for key in arrays.files:
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = torch.from_numpy(np.array(arrays[key]))
    return tree


def run(rank: int, world: int, n_data: int, n_model: int, workdir: str, vocab: str) -> None:
    import torch
    import torch.distributed as dist

    work = Path(workdir)
    try:
        torch.set_num_threads(1)
        os.environ["MVLPT_TORCH_BPE_PATH"] = vocab
        dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                                world_size=world)
        out = _rank_outputs(rank, n_data, n_model, np.load(work / "inputs.npz"))
        np.savez(work / f"rank{rank}.npz", **out)
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank_outputs(rank, n_data, n_model, inputs) -> dict:
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

    mesh = create_mesh(n_data, n_model)
    assert rank == mesh.data_rank * n_model + mesh.model_rank
    kernels = select_attn_fn("block", mesh=mesh)
    out = {}

    # One residual block through core.layers, forward and dx, on this
    # data rank's rows with this model rank's shard.
    p = shard_blocks(unflatten(inputs, "blk"), BLOCK_HEADS, n_model, mesh.model_rank)
    x = local_batch(torch.from_numpy(inputs["x"]), mesh)
    gy = local_batch(torch.from_numpy(inputs["gy"]), mesh)
    for name, mask in (("none", None), ("causal", torch.from_numpy(inputs["mask"]))):
        xr = x.clone().requires_grad_(True)
        y = layers.residual_block(xr, p, BLOCK_HEADS, mask, kernels)
        (dx,) = torch.autograd.grad(y, xr, gy)
        out[f"y_{name}"], out[f"dx_{name}"] = y.detach().numpy(), dx.numpy()

    # The cached-text eval of the initial prompts, then one SGD step of
    # the tiny UPT step, under the mesh.
    clip_cfg = CLIPConfig(**DIMS)
    classnames = [f"c{i}" for i in range(N_CLS)]
    spec = PromptSpec(**spec_kw(int(inputs["context_length"])))
    backbone = unflatten(inputs, "bb")
    consts = build_prompt_consts(classnames, spec, backbone, torch.float32)
    model = MVLPTModel(clip_cfg, spec, kernels=kernels, compute_dtype=torch.float32)
    backbone = shard_backbone(backbone, clip_cfg, mesh)
    pp = unflatten(inputs, "pp")
    if n_data == 1:
        text_fn, eval_fn = make_cached_text_eval(
            model, normalize=(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD))
        out["eval_logits"] = eval_fn(backbone, pp, text_fn(backbone, pp, consts),
                                     {"image": torch.from_numpy(inputs["eval_image"])}).numpy()
    state = init_train_state(pp, optim_config(**OPTIM), steps_per_epoch=1)
    batch = {"image": torch.from_numpy(inputs["image"]),
             "label": torch.from_numpy(inputs["label"])}
    state, metrics = make_train_step(model, mesh=mesh)(state, backbone, consts, batch)
    out["loss"] = metrics["loss"].numpy()
    for i, leaf in enumerate(tree_leaves(state.prompt_params)):
        out[f"param{i}"] = leaf.detach().numpy()
    return out
