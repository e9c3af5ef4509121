"""A ("data", "model") mesh of ``torch.distributed`` ranks, and the
Megatron layout of the frozen backbone over it.

The counterpart of ``mvlpt_tpu/parallel/mesh.py``. Every process is one
rank; ranks are laid out row-major over (data, model), as
``mesh_utils.create_device_mesh((n_data, n_model))`` lays out devices:
rank = data_rank * n_model + model_rank. A model group holds the
n_model ranks of one data row, a data group the n_data ranks of one
model column.

  * "data": each data rank takes its rows of the global batch
    (:func:`local_batch`, the counterpart of ``batch_specs``), and the
    train step takes the mean of the prompt gradients over the data
    group.
  * "model": each block's weights are cut Megatron-style
    (:func:`shard_backbone`): the qkv and fc products by columns, the
    out and proj products by rows, so each model rank holds H/tp whole
    heads and 4W/tp hidden units. The fused tensor-parallel kernels
    (``ops/block.py``, ``attn_block_tp``/``mlp_block_tp``) emit fp32
    partials that an all-reduce over the model group sums. The plain
    layers ('off') and the standalone attention ('on') run on the same
    shard through the two Megatron conjugates below
    (:func:`copy_to_model` on entry to a sharded half-block,
    :func:`reduce_from_model` on its row-parallel partial), where the
    JAX package lets GSPMD partition its plain layers over the mesh.

The token embedding stays whole on every rank: the JAX package
vocab-shards it, which is a memory layout with the same values.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the mesh and its two process groups."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: object    # dist.ProcessGroup of this rank's model column
    model_group: object   # dist.ProcessGroup of this rank's data row


def create_mesh(n_data: int, n_model: int) -> Mesh:
    """This rank's view of an (n_data, n_model) mesh over every rank of
    the initialised default process group. Every rank must call it, in
    the same order as its other group creations: each rank creates
    every group. The groups take the default group's backend."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh: initialise torch.distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"create_mesh: a {n_data}x{n_model} mesh needs {n_data * n_model} "
                         f"ranks, the process group has {world}")
    data_rank, model_rank = divmod(rank, n_model)
    model_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == data_rank:
            model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == model_rank:
            data_group = g
    return Mesh(n_data, n_model, data_rank, model_rank, data_group, model_group)


def shard_blocks(blocks: dict, n_heads: int, tp: int, rank: int) -> dict:
    """Model rank ``rank``'s shard of a block tree (one block, or blocks
    stacked on a leading layer axis), or the tree itself when the tower
    does not divide by ``tp`` (its heads or its hidden units): such a
    tower keeps its full weights, and every model rank runs the whole
    fused block on them (``ops/block.fused_residual_block_sharded``).
    The shard:

      * qkv_w (W, 3W) -> (W, 3Wl) columns [q_r | k_r | v_r], Wl = W/tp,
        the port's layout of ``_qkv_tp_layout``; qkv_b likewise;
      * out_w (W, W) -> the rows of this rank's heads, (Wl, W);
      * fc_w (W, 4W) and fc_b -> this rank's 4W/tp hidden units (columns);
        proj_w (4W, W) -> the same units (rows);
      * LayerNorms, out_b and proj_b whole.

    Sliced leaves are contiguous copies; the rest are shared."""
    attn, mlp = blocks["attn"], blocks["mlp"]
    w, w4 = attn["out_w"].shape[-1], mlp["fc_w"].shape[-1]
    if tp == 1 or n_heads % tp or w4 % tp:
        return blocks
    wl, w4l = w // tp, w4 // tp
    lead = attn["qkv_b"].shape[:-1]
    cols, rows = slice(rank * wl, (rank + 1) * wl), slice(rank * w4l, (rank + 1) * w4l)
    qkv_w = attn["qkv_w"].reshape(*lead, w, 3, tp, wl)[..., rank, :].reshape(*lead, w, 3 * wl)
    qkv_b = attn["qkv_b"].reshape(*lead, 3, tp, wl)[..., rank, :].reshape(*lead, 3 * wl)
    return dict(
        blocks,
        attn=dict(attn, qkv_w=qkv_w.contiguous(), qkv_b=qkv_b.contiguous(),
                  out_w=attn["out_w"][..., cols, :].contiguous()),
        mlp=dict(mlp, fc_w=mlp["fc_w"][..., rows].contiguous(),
                 fc_b=mlp["fc_b"][..., rows].contiguous(),
                 proj_w=mlp["proj_w"][..., rows, :].contiguous()))


def shard_backbone(backbone: dict, clip_cfg, mesh: Mesh) -> dict:
    """This model rank's Megatron shard of both towers' blocks (see
    :func:`shard_blocks`); every other leaf is shared with ``backbone``.
    ``clip_cfg`` gives each tower's head count."""
    out = dict(backbone)
    for tower, heads in (("visual", clip_cfg.vision_heads), ("text", clip_cfg.transformer_heads)):
        out[tower] = dict(backbone[tower], blocks=shard_blocks(
            backbone[tower]["blocks"], heads, mesh.n_model, mesh.model_rank))
    return out


def local_batch(batch, mesh: Mesh):
    """This data rank's rows of a global batch (a tensor, or a dict of
    tensors with a leading batch axis): the counterpart of
    ``batch_specs`` with P("data"). The batch must divide by n_data."""
    if isinstance(batch, dict):
        return {k: local_batch(v, mesh) for k, v in batch.items()}
    n = batch.shape[0]
    if n % mesh.n_data:
        raise ValueError(f"local_batch: a batch of {n} rows does not divide over "
                         f"{mesh.n_data} data ranks")
    per = n // mesh.n_data
    return batch[mesh.data_rank * per:(mesh.data_rank + 1) * per]


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (each model rank's shard contributes a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward; identity backward (every
    model rank holds the whole gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's f: ``x`` as it is, on entry to a column-parallel product;
    its gradient is all-reduced over the model group."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's g: the all-reduce over the model group of a row-parallel
    partial; its gradient passes as it is."""
    return _ReduceFromModel.apply(x, mesh.model_group)


def data_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's ``x`` (its rows of a batch, one shape on every
    rank) concatenated in data-rank order along the leading axis, on every
    rank: each rank writes its rows into its slot of zeros and an
    all_reduce over the data group sums the slots, which is exact and runs
    on every backend and device (gloo gathers no CUDA tensor)."""
    if mesh is None or mesh.n_data == 1:
        return x
    n = x.shape[0]
    out = torch.zeros((mesh.n_data * n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    out[mesh.data_rank * n:(mesh.data_rank + 1) * n] = x
    dist.all_reduce(out, group=mesh.data_group)
    return out


def over_data_rows(fn, batch: dict, mesh: Mesh | None):
    """``fn(rows)`` over a mesh's data axis, for no-grad callers: each data
    rank runs its rows of ``batch`` (a dict of tensors with one leading
    batch axis, padded by repeating its last row until it divides over the
    data ranks), and the results are gathered over the data group
    (:func:`data_gather`), so every rank holds the whole batch's, cut back
    to the batch's rows. Without a data axis, ``fn(batch)``."""
    if mesh is None or mesh.n_data == 1:
        return fn(batch)
    n = next(iter(batch.values())).shape[0]
    pad = -n % mesh.n_data
    if pad:
        batch = {k: torch.cat([v, v[-1:].expand(pad, *v.shape[1:])]) for k, v in batch.items()}
    return data_gather(fn(local_batch(batch, mesh)), mesh)[:n]
