"""Multi-process execution: one ``torch.distributed`` rank a process.

The counterpart of ``mvlpt_tpu/parallel/multihost.py``. On the JAX side
every host runs the program, ``jax.distributed.initialize`` joins them,
and one SPMD program spans the global device set. Here every rank is a
process of its own (``python -m torch.distributed.run --nproc-per-node N
-m mvlpt_torch.cli.train ...``), and the ("data", "model") mesh is a set
of process groups (``parallel.mesh.create_mesh``).

Data contract when the world has more than one rank:

* **Train**: every rank computes the SAME deterministic batch order
  (seeded shuffles, identical config), but decodes only its data rank's
  ``local_batch_slice`` rows of each global batch
  (``DataLoader(host_shard=...)``); the model ranks of one data row
  decode the same rows. The JAX package's ``global_batch_arrays``
  assembles those rows into global arrays; here each rank keeps its rows
  as they are (``parallel.local_batch`` is the same cut of a global
  batch), and the train step takes the mean of the gradients over the
  data group.
* **Eval**: every rank reads the full split (its loader has no shard),
  runs its data rank's rows of each batch and gathers the logits over
  the data group, so every rank holds the whole batch's logits and
  computes the same metrics.
* **Frozen backbone / consts**: every rank holds the full tree and keeps
  its Megatron shard of the blocks (``parallel.shard_backbone``), where
  the JAX package's ``put_tree_on_mesh`` places each device's shard.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

# torchrun's variables, read in the place of the JAX package's
# JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID.
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def choose_backend(device: torch.device, local_world: int,
                   device_count: int | None = None) -> tuple[str, str]:
    """(backend, why) for ranks on ``device``, ``local_world`` of them on
    this machine: "nccl" when the device is CUDA and every local rank has a
    card of its own; "gloo" when the local ranks outnumber the cards (NCCL
    refuses two ranks on one device; gloo's all_reduce takes CUDA tensors
    through host memory), and on the CPU. The topology decides: this is
    not a fallback."""
    if device.type != "cuda":
        return "gloo", "the ranks run on the CPU"
    cards = torch.cuda.device_count() if device_count is None else device_count
    if local_world <= cards:
        return "nccl", f"{local_world} local ranks on {cards} cards, one card each"
    return "gloo", (f"{local_world} local ranks share {cards} card(s); NCCL refuses two ranks "
                    "on one device")


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    ``device``, else ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def maybe_initialize_distributed(device="cuda") -> bool:
    """Join the ranks of a ``torch.distributed.run`` launch.

    When a process group is initialised already (a caller made it, as the
    tests' spawned ranks do over a ``file://`` store), it is left alone
    and this returns True. Else, when torchrun's WORLD_SIZE is above 1, it
    calls ``init_process_group`` over ``env://`` (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) with the backend of :func:`choose_backend`
    for this rank's device and LOCAL_WORLD_SIZE, sets that device current
    on the card, and returns True; rank 0 prints the backend and why.
    Otherwise it returns False."""
    if dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is {os.environ['WORLD_SIZE']} but {missing} are unset; "
                           "launch with python -m torch.distributed.run")
    device = rank_device(device)
    backend, why = choose_backend(device, int(os.environ["LOCAL_WORLD_SIZE"]))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    if dist.get_rank() == 0:
        print(f"torch.distributed: backend {backend} ({why})", flush=True)
    return True


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_writer() -> bool:
    """Whether this rank writes the run's files: rank 0 only."""
    return world()[0] == 0


def barrier() -> None:
    """Wait for every rank of the default group (nothing without one)."""
    if dist.is_initialized():
        dist.barrier()


def local_batch_slice(global_batch: int, mesh) -> tuple[int, int]:
    """(start, size) of this rank's rows in the global batch, by its data
    rank: the model ranks of one data row take the same rows."""
    n_data = 1 if mesh is None else mesh.n_data
    if global_batch % n_data:
        raise ValueError(
            f"global batch {global_batch} must divide evenly across "
            f"{n_data} processes; adjust DATALOADER.*.BATCH_SIZE")
    per = global_batch // n_data
    return (0 if mesh is None else mesh.data_rank) * per, per


def _group_device(group) -> torch.device:
    """Where a collective of ``group`` takes its tensors: the current card
    under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_tree(tree, group=None):
    """Gather a rank-local tree (dicts, lists or tuples of arrays or
    numbers) from every rank of ``group`` (the default group when None),
    each leaf stacked on a new leading axis in rank order, as numpy. The
    identity with a new axis without a process group. The gather is an
    all_reduce of each leaf written into its rank's slot of zeros, which
    every backend runs on every device."""
    if isinstance(tree, dict):
        return {k: allgather_tree(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(allgather_tree(v, group) for v in tree)
    x = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    if not dist.is_initialized():
        return x[None]
    n, me = dist.get_world_size(group), dist.get_rank(group)
    work = torch.from_numpy(np.array(x))
    if work.dtype == torch.bool:
        work = work.to(torch.uint8)
    buf = torch.zeros((n, *work.shape), dtype=work.dtype, device=_group_device(group))
    buf[me] = work.to(buf.device)
    dist.all_reduce(buf, group=group)
    return buf.cpu().numpy().astype(x.dtype, copy=False)
