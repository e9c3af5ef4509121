"""Trainer engine: the Dassl-TrainerX contract around the port's steps.

The counterpart of ``mvlpt_tpu/train/trainer.py``, with the same printed
lines, files and selection rules (the reference's MVLPT(TrainerX),
mvlpt.py:827-1125):

  * epoch loop with per-batch metric meters and PRINT_FREQ logging;
    LR stepping per epoch (the device SGD's per-epoch table);
  * windowed dispatch (TRAIN.STEPS_PER_DISPATCH): the window clamps to
    the epoch length, a tail of at least TRAIN.WINDOW_MIN_TAIL batches
    runs as one window (served by the first window's CUDA graph), a
    shorter one a step a call; both steps share one ``WindowState``;
  * best-val checkpoint selection (TEST.FINAL_MODEL=best_val) with
    prompt-only checkpoints under <OUTPUT_DIR>/prompt_learner/;
  * resume from RESUME dir; warm start from --model-dir via load_model
    (drops token_prefix/suffix, renames upt_proj, non-strict);
  * test() over both universes (mvlpt.py:989-1088), with the text
    features once a pass (CoCoOp: both towers each batch): CoOp through
    the classification evaluator, per task in multitask runs; a single
    ELEVATER task by its metric over the concatenated logits; ELEVATER
    multitask per task, on the task's slice [lo:hi] of the logits and
    k-hot targets (the argmax for "accuracy"); overall = average or
    MULTITASK_EVALKEY, and `results {...}` prints;
  * per-layer activation checkpointing for TRAINER.ACT_CKPT > 1;
  * SGD, Adam, AdamW and RMSprop on the device (``optim.DeviceOptimizer``),
    their state in the checkpoints; VPT dropout seeded each epoch by
    max(SEED, 0) * 131 + epoch, as the JAX trainer seeds its keys;
  * scalar logging to <OUTPUT_DIR>/tb/scalars.jsonl;
  * a ("data", "model") mesh of ``torch.distributed`` ranks from
    TPU.MESH_DATA/MESH_MODEL when the run has more than one rank
    (``build_mesh``): the train loader decodes each data rank's rows,
    the backbone keeps each model rank's Megatron shard, windows run
    eagerly, test() runs each data rank's rows and gathers the logits, and
    only rank 0 writes files (log.txt, tb/, checkpoints) while the other
    ranks wait at a barrier.

The fine-tune trainer lives in ``train/finetune.py``, the zero-shot
trainers in ``models/zsclip.py``.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import time

import numpy as np
import torch

from mvlpt_torch.checkpoint import convert as ckpt_convert
from mvlpt_torch.checkpoint import prompt_io
from mvlpt_torch.core import clip as clip_core
from mvlpt_torch.core.clip import CLIPConfig
from mvlpt_torch.core.resnet import RN_ARCHS, RNConfig, init_rn_params
from mvlpt_torch.data.loader import DeviceStager, prefetch_to_device
from mvlpt_torch.data.managers import build_data_manager
from mvlpt_torch.evaluation import ClassificationEvaluator
from mvlpt_torch.models.custom_clip import MVLPTModel, TaskClassRanges
from mvlpt_torch.ops.attention import select_attn_fn
from mvlpt_torch.parallel import barrier, create_mesh, is_writer, shard_backbone, world
from mvlpt_torch.prompts import (
    PromptSpec,
    build_prompt_consts,
    compute_cut_context_length,
    init_prompt_params,
    spec_from_cfg,
)
from mvlpt_torch.train.optim import SLOTS, build_lr_schedule
from mvlpt_torch.train.train_step import (
    init_train_state,
    make_cached_text_eval,
    make_eval_step,
    make_train_step,
    make_train_step_multi,
)
from mvlpt_torch.utils import profiler
from mvlpt_torch.utils.device import resolve_device
from mvlpt_torch.utils.pipeline import pipelined_inference
from mvlpt_torch.utils.registry import TRAINER_REGISTRY
from mvlpt_torch.utils.tree import tree_keys, tree_leaves


def load_clip_backbone(cfg, dtype, device="cuda"):
    """(backbone, config) for cfg.MODEL.BACKBONE.NAME, in the JAX
    package's order: MVLPT_TPU_RANDOM_CLIP=1 gives a random init (a ViT at
    seed 0, MVLPT_TPU_RANDOM_CLIP_ARCH holding JSON CLIPConfig overrides;
    an RN name's tower from ``RN_ARCHS`` at seed 0 beside ViT-B/16's text
    tower at seed 1), then the local file MVLPT_TPU_CLIP_CKPT names, then
    ``~/.cache/clip`` (sha256-checked). A ViT gives its CLIPConfig, an RN
    its RNConfig. Where the JAX package would download, this raises."""
    name = cfg.MODEL.BACKBONE.NAME
    if os.environ.get("MVLPT_TPU_RANDOM_CLIP"):
        if name.startswith("RN"):
            rn_cfg = RN_ARCHS[name]
            # RN50/101 share ViT-B's 512-wide, 12-layer text transformer.
            full = clip_core.init_clip_params(torch.Generator().manual_seed(1),
                                              CLIPConfig.for_backbone("ViT-B/16"), device=device)
            params = {"visual": init_rn_params(torch.Generator().manual_seed(0), rn_cfg,
                                               device=device),
                      "text": full["text"], "logit_scale": full["logit_scale"]}
            return clip_core.cast_backbone(params, dtype), rn_cfg
        clip_cfg = CLIPConfig.for_backbone(name)
        arch_env = os.environ.get("MVLPT_TPU_RANDOM_CLIP_ARCH")
        if arch_env:
            clip_cfg = dataclasses.replace(clip_cfg, **json.loads(arch_env))
        params = clip_core.init_clip_params(torch.Generator().manual_seed(0), clip_cfg,
                                            device=device)
        return clip_core.cast_backbone(params, dtype), clip_cfg
    env = os.environ.get("MVLPT_TPU_CLIP_CKPT")
    path = env if env and os.path.exists(env) else ckpt_convert.find_cached_clip(name)
    params, clip_cfg = ckpt_convert.load_clip(path, dtype=dtype, device=device)
    return clip_core.cast_backbone(params, dtype), clip_cfg


def build_mesh(cfg):
    """The ("data", "model") mesh of TPU.MESH_*, or None when the run
    has one rank. As in the JAX trainer: MESH_DATA -1 means every rank
    over the model axis (world // n_model), and the data axis shrinks
    to its gcd with the train batch. Where the JAX trainer would leave
    devices idle (n_data x n_model below the device count), this
    raises: a rank cannot sit out of the groups it belongs to."""
    rank, n_ranks = world()
    if n_ranks == 1:
        return None
    n_model = max(1, cfg.TPU.MESH_MODEL)
    n_data = cfg.TPU.MESH_DATA
    if n_data == -1:
        n_data = n_ranks // n_model
    n_data = math.gcd(n_data, cfg.DATALOADER.TRAIN_X.BATCH_SIZE)
    if n_data * n_model != n_ranks:
        raise ValueError(
            f"TPU.MESH_DATA/MESH_MODEL give a {n_data}x{n_model} mesh (the data axis cut to "
            f"its gcd with the train batch {cfg.DATALOADER.TRAIN_X.BATCH_SIZE}), but the run "
            f"has {n_ranks} ranks; every rank must sit on the mesh")
    mesh = create_mesh(n_data, n_model)
    print(f"mesh: {{'data': {n_data}, 'model': {n_model}}} (rank {rank}: data rank "
          f"{mesh.data_rank}, model rank {mesh.model_rank})")
    return mesh


class MetricMeter:
    """Accumulates step metrics without reading the device: values stay
    as 0-dim tensors until summary(), so the host and the device stay
    pipelined between prints."""

    def __init__(self, window: int = 20):
        self.meters = {}
        self.window = window

    def update(self, metrics: dict):
        for k, v in metrics.items():
            buf = self.meters.setdefault(k, [])
            buf.append(v)
            if len(buf) > self.window:
                del buf[: -self.window]

    def summary(self) -> str:
        return " ".join(f"{k} {np.mean([float(x) for x in v]):.4f}"
                        for k, v in self.meters.items())


class ScalarWriter:
    """write_scalar equivalent: one JSONL line per scalar. ``enabled=False``
    (a rank other than 0) writes nothing."""

    def __init__(self, output_dir, enabled: bool = True):
        self.path = os.path.join(output_dir, "tb", "scalars.jsonl")
        self._f = None
        if enabled:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._f = open(self.path, "a")

    def write_scalar(self, tag, value, step):
        if self._f is None:
            return
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()


# Where each slot of a DeviceOptimizer lies in a JAX-written ``opt_state``:
# the optax state class and the field that holds the slot's tree.
_FOREIGN_SLOTS = {("sgd", "momentum"): ("TraceState", 0),
                  ("adam", "mu"): ("ScaleByAdamState", 1),
                  ("adam", "nu"): ("ScaleByAdamState", 2),
                  ("rmsprop", "nu"): ("ScaleByRmsState", 0)}


def _payload_key(kind: str, slot: str) -> str:
    """A slot's key in the port's checkpoint payload ("momentum" for SGD,
    as before the other optimizers, else "<kind>_<slot>")."""
    return "momentum" if kind == "sgd" else f"{kind}_{slot}"


def _flat_leaves(tree, prefix: str = "") -> dict:
    """A state tree's leaves by dotted key, leaving out optax's MaskedNode
    (an empty state: a parameter another group of multi_transform owns)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, prompt_io.ForeignState) and not tree:
        return {}
    return {prefix[:-1]: np.asarray(tree)}


def _foreign_states(opt_state, name: str) -> list:
    """Every state of optax class ``name`` in a JAX-written ``opt_state``
    (one a parameter group under optax.multi_transform); the JAX package's
    dampened SGD trace, a dict with "count" and "trace", stands as a
    TraceState."""
    if isinstance(opt_state, prompt_io.ForeignState):
        if type(opt_state).__name__ == name:
            return [opt_state]
        return [s for item in opt_state for s in _foreign_states(item, name)]
    if isinstance(opt_state, dict):
        if name == "TraceState" and set(opt_state) == {"count", "trace"}:
            return [(opt_state["trace"],)]
        return [s for v in opt_state.values() for s in _foreign_states(v, name)]
    if isinstance(opt_state, (tuple, list)):
        return [s for item in opt_state for s in _foreign_states(item, name)]
    return []


def _foreign_slots(opt_state, kind: str, keys: set) -> dict | None:
    """The slots of a ``kind`` optimizer in a JAX-written ``opt_state``, by
    the params' dotted keys, or None when it holds no such state over
    exactly these params."""
    slots = {}
    for slot in SLOTS[kind]:
        cls, field = _FOREIGN_SLOTS[(kind, slot)]
        flat = {}
        for state in _foreign_states(opt_state, cls):
            flat.update(_flat_leaves(state[field]))
        if set(flat) != keys:
            return None
        slots[slot] = flat
    return slots


class PromptTrainer:
    """Shared engine for the MVLPT, CoOp and CoCoOp trainers. Runs on ``device``
    (the card unless the caller asks for the CPU).

    ``timings`` records what the host clock saw: each epoch's wall time
    (ending in a device synchronize), the part of it spent waiting on the
    loader for host batches (``loader_s``), the part spent staging them
    on the device (``stage_s``: copies into pinned memory and waits for
    a pinned buffer), and its images; each test() pass's wall time and
    images.

    Batches reach the device through one ``DeviceStager`` (pinned host
    buffers, copies on a side stream): train batches through
    ``prefetch_to_device``, eval batches in ``model_inference``.

    Under a mesh (``self.mesh``, more than one rank) the train loader
    yields this rank's rows of each global batch, so ``_device_batch`` and
    ``_stage_window`` stage those rows, and the steps take them as local
    (``make_train_step(..., local_rows=True)``); eval batches are whole
    and the eval steps cut and gather them. Only rank 0 writes files."""

    trainer_cfg_key = "MVLPT"

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dir = cfg.OUTPUT_DIR
        self.writes = is_writer()
        if self.writes:
            os.makedirs(self.output_dir, exist_ok=True)
        self.writer = ScalarWriter(self.output_dir, enabled=self.writes)
        self.epoch = 0
        self.max_epoch = cfg.OPTIM.MAX_EPOCH
        self.best_result = -np.inf
        self.timings = {"epochs": [], "tests": []}
        self._stager = DeviceStager(self.device)

        self.multi_task = cfg.DATASET.MULTITASK
        # The mesh comes first: the train loader decodes each rank's rows,
        # and select_attn_fn and the backbone's shard take it (the JAX
        # trainer builds it before the model, replacing nn.DataParallel,
        # mvlpt.py:877-880).
        self.mesh = self._build_mesh(cfg)
        self.build_data_loader()
        self.build_model()

    # ---------------------------------------------------------------- config
    @property
    def tcfg(self):
        return self.cfg.TRAINER[self.trainer_cfg_key]

    def check_cfg(self):
        if self.tcfg.PREC not in ("fp16", "fp32", "amp", "bf16"):
            raise ValueError(f"TRAINER.{self.trainer_cfg_key}.PREC {self.tcfg.PREC!r}")

    def _dtypes(self):
        if self.tcfg.PREC == "fp32":
            return torch.float32, torch.float32
        # fp16 / amp / bf16 all mean bf16 (no loss scaling needed)
        return getattr(torch, self.cfg.TPU.PARAM_DTYPE), getattr(torch, self.cfg.TPU.COMPUTE_DTYPE)

    def build_spec(self, clip_cfg: CLIPConfig, classnames) -> PromptSpec:
        """MVLPT spec from TRAINER.MVLPT.* (overridden by CoOp and CoCoOp)."""
        return spec_from_cfg(self.cfg, len(classnames), clip_cfg, classnames)

    def ctx_inits(self) -> tuple[str, str]:
        """(CoOp, CoCoOp) context init words."""
        return self.tcfg.COOP.CTX_INIT, self.tcfg.COCOOP.CTX_INIT

    def _build_mesh(self, cfg):
        """The run's mesh (:func:`build_mesh`)."""
        return build_mesh(cfg)

    # ------------------------------------------------------------------ data
    def build_data_loader(self):
        dm = build_data_manager(self.cfg, mesh=self.mesh)
        self.dm = dm
        self.train_loader_x = dm.train_loader_x
        self.val_loader = dm.val_loader
        self.test_loader = dm.test_loader
        self.num_classes = dm.num_classes
        self.lab2cname = dm.lab2cname

    # ----------------------------------------------------------------- model
    def build_model(self):
        cfg = self.cfg
        self.check_cfg()
        param_dtype, compute_dtype = self._dtypes()
        classnames = self.dm.classnames

        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.backbone, self.clip_cfg = load_clip_backbone(cfg, param_dtype, self.device)
        if isinstance(self.clip_cfg, RNConfig):
            raise ValueError(
                "Prompt tuning requires a ViT backbone (the reference asserts the same, "
                "mvlpt.py:47); RN* checkpoints serve the linear-probe / feature-extraction "
                "path.")

        print("Building custom CLIP")
        self.spec = self.build_spec(self.clip_cfg, classnames)
        coop_init, cocoop_init = self.ctx_inits()
        prompt_params = init_prompt_params(
            torch.Generator().manual_seed(max(cfg.SEED, 0)), self.spec, device=self.device,
            clip_params=self.backbone, coop_ctx_init=coop_init, cocoop_ctx_init=cocoop_init)
        self.consts = build_prompt_consts(classnames, self.spec, self.backbone, compute_dtype,
                                          ctx_init=coop_init or cocoop_init)
        print("Current Context Length is:", self.spec.context_length)

        self.task_ranges = None
        if cfg.DATASET.MULTITASK_LABEL_PERTASK and hasattr(self.dm, "_task_class_idx"):
            idx = self.dm._task_class_idx
            self.task_ranges = TaskClassRanges(
                start=torch.tensor([idx[t][0] for t in self.dm._task_names], device=self.device),
                end=torch.tensor([idx[t][1] for t in self.dm._task_names], device=self.device))

        # ACT_CKPT is the memory lever (the reference's
        # checkpoint_sequential chunks, mvlpt.py:119-121): any value > 1
        # checkpoints every layer, as the JAX package's remat does.
        self.model = MVLPTModel(self.clip_cfg, self.spec,
                                kernels=select_attn_fn(cfg.TPU.USE_PALLAS, mesh=self.mesh),
                                compute_dtype=compute_dtype, remat=cfg.TRAINER.ACT_CKPT > 1)

        n_prompt = sum(t.numel() for t in tree_leaves(prompt_params))
        n_clip = sum(t.numel() for t in tree_leaves(self.backbone))
        print(f"Tunable Param: {n_prompt/1e6}M, Original CLIP {n_clip/1e6}M")
        if n_prompt == 0:
            # The reference defaults all MVLPT N_CTX knobs to 0 and relies
            # on run scripts to set them; torch's optimizer constructor
            # raises on an empty parameter list. Match that loudly.
            raise ValueError(
                "No tunable prompt parameters: all of "
                "TRAINER.MVLPT.{COOP,VPT,COCOOP}.N_CTX are 0. Set at "
                "least one (e.g. TRAINER.MVLPT.COOP.N_CTX 16, or both "
                "COOP and VPT N_CTX for UPT) as the reference run "
                "scripts do (scripts/mvlpt/main_mt_coopdata_cut.sh).")

        self.steps_per_epoch = max(1, len(self.train_loader_x))
        self.lr_schedule = build_lr_schedule(cfg.OPTIM, self.steps_per_epoch)
        self.state = self._init_state(prompt_params)
        # TPU.DEVICE_NORMALIZE: loaders yield raw uint8; the steps fold
        # CLIP normalization into the frozen patch-embed product
        self._normalize = (tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)) \
            if cfg.TPU.DEVICE_NORMALIZE else None
        self.train_step = make_train_step(self.model, self.task_ranges, normalize=self._normalize,
                                          mesh=self.mesh, local_rows=True)
        self.train_step_multi = None  # built on first use (TRAIN.STEPS_PER_DISPATCH)
        self.eval_step = make_eval_step(self.model, self.task_ranges, normalize=self._normalize,
                                        mesh=self.mesh)
        # Cached-text eval: prompts are frozen during eval, so test()
        # computes the text features once a call instead of per batch
        # (None for CoCoOp: its text features depend on the image).
        self._eval_text_fn, self.eval_step_cached = make_cached_text_eval(
            self.model, self.task_ranges, normalize=self._normalize, mesh=self.mesh)
        self._eval_text = None
        self.evaluator = ClassificationEvaluator(self.lab2cname)
        if self.mesh is not None:
            # each model rank keeps its Megatron shard of the frozen blocks
            self.backbone = shard_backbone(self.backbone, self.clip_cfg, self.mesh)

    def _init_state(self, params: dict):
        """A fresh train state over ``params`` (the device optimizer of
        cfg.OPTIM, update count 0)."""
        return init_train_state(params, self.cfg.OPTIM, self.steps_per_epoch)

    def _device_batch(self, batch: dict) -> dict:
        """One batch on the device (tasks as int64 indices): a host batch
        through the stager, a staged one (``prefetch_to_device``) as it is.
        Under a mesh a train batch holds this rank's rows already (the
        loader's ``host_shard``)."""
        keys = [k for k in ("image", "label", "task") if k in batch]
        if not all(isinstance(batch[k], torch.Tensor) for k in keys):
            batch = self._stager({k: batch[k] for k in keys})
        out = {k: batch[k] for k in keys}
        if "task" in out:
            out["task"] = out["task"].long()
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ train
    def train(self):
        cfg = self.cfg
        if cfg.RESUME:
            self.resume_from_checkpoint(cfg.RESUME)
        start = time.time()
        for self.epoch in range(self.epoch, self.max_epoch):
            self.run_epoch()
            self.after_epoch()
        self.after_train()
        elapsed = round(time.time() - start)
        print(f"Elapsed: {datetime.timedelta(seconds=elapsed)}")

    def _timed_batches(self, record: dict):
        """The train loader's host batches, adding the host's wait for each
        to ``record``; a multitask batch carries its count of distinct
        tasks (``num_tasks``, a host int, read before staging)."""
        it = iter(self.train_loader_x)
        while True:
            t0 = time.perf_counter()
            try:
                with profiler.span("loader.next", device=False):
                    batch = next(it)
            except StopIteration:
                record["loader_s"] += time.perf_counter() - t0
                return
            record["loader_s"] += time.perf_counter() - t0
            record["images"] += len(batch["image"])
            if "task" in batch:
                batch["num_tasks"] = len(set(batch["task"].tolist()))
            yield batch

    def _dispatch_window(self) -> int:
        """The steps a windowed call takes (TRAIN.STEPS_PER_DISPATCH)."""
        return max(1, int(self.cfg.TRAIN.STEPS_PER_DISPATCH))

    def run_epoch(self):
        record = {"epoch": self.epoch + 1, "loader_s": 0.0, "images": 0}
        t0, stage0 = time.perf_counter(), self._stager.host_s
        # The epoch's dropout seed, as the JAX trainer's PRNGKey: written
        # into the state's tensor, which a captured window reads.
        self.state.seed.fill_(max(self.cfg.SEED, 0) * 131 + self.epoch)
        window = self._dispatch_window()
        batches = prefetch_to_device(self._timed_batches(record), stager=self._stager)
        if window > 1:
            self._run_epoch_windowed(window, batches)
        else:
            self._run_epoch_plain(batches)
        self._sync()
        record["wall_s"] = time.perf_counter() - t0
        record["stage_s"] = self._stager.host_s - stage0
        self.timings["epochs"].append(record)

    def _print_progress(self, done: int, num_batches: int, meter: MetricMeter):
        lr = self.lr_schedule(self.state.step - 1)
        print(f"epoch [{self.epoch + 1}/{self.max_epoch}] batch [{done}/{num_batches}] "
              f"{meter.summary()} lr {lr:.4e}")

    def _run_epoch_plain(self, batches):
        """One step call per loader batch (the window = 1 path)."""
        meter = MetricMeter()
        num_batches = len(self.train_loader_x)
        for batch_idx, batch in enumerate(batches):
            self.state, metrics = self.train_step(self.state, self.backbone, self.consts,
                                                  self._device_batch(batch))
            meter.update(metrics)
            if "num_tasks" in batch:
                meter.update({"num_tasks": batch["num_tasks"]})
            if (batch_idx + 1) % max(1, self.cfg.TRAIN.PRINT_FREQ) == 0:
                self._print_progress(batch_idx + 1, num_batches, meter)

    def _stage_window(self, pending: list) -> dict:
        """The window's batches stacked to (K, B, ...) on the device (a copy
        on the device when they are staged already); float images in the
        compute dtype the model casts them to anyway, uint8
        (DEVICE_NORMALIZE) as they are."""
        # The train loader drops its tail batch (build_data_loader), so
        # every batch of a window has one shape.
        shape = pending[0]["image"].shape
        if any(b["image"].shape != shape for b in pending):
            raise ValueError("a window's batches must share one shape: "
                             f"{[tuple(b['image'].shape) for b in pending]}")
        batches = [self._device_batch(b) for b in pending]
        out = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        if out["image"].dtype != torch.uint8:
            out["image"] = out["image"].to(self.model.compute_dtype)
        return out

    def _run_epoch_windowed(self, window: int, batches):
        """Stage ``window`` loader batches and run them in one call of the
        windowed step (``make_train_step_multi``: on the card one captured
        step replayed K times). Same optimizer and schedule math as the
        per-batch path.

        A window's progress line reads the device (the meter's values and
        the update count), which waits for its replays. It is printed once
        the next window's batches are decoded and staged, just before that
        window runs, so the host decodes while the card replays; the lines
        and their values are the same, in the same order."""
        meter = MetricMeter()
        num_batches = len(self.train_loader_x)
        # An epoch shorter than the configured window still gets windowed
        # dispatch (one window over the whole epoch).
        window = max(1, min(window, num_batches))
        if window < 2:
            return self._run_epoch_plain(batches)
        min_tail = max(0, int(self.cfg.TRAIN.WINDOW_MIN_TAIL))
        if self.train_step_multi is None:
            if self.mesh is not None:
                print("windows run eagerly under the mesh (capture=False): the ranks' "
                      "all-reduces are not captured")
            self.train_step_multi = make_train_step_multi(
                self.model, self.task_ranges, pre_embed=bool(self.cfg.TPU.PRE_EMBED_WINDOW),
                normalize=self._normalize, mesh=self.mesh, capture=self.mesh is None)
        pending: list[dict] = []
        done = 0
        deferred = []  # the progress line of the last window, not yet printed

        def settle():
            while deferred:
                self._print_progress(deferred.pop(), num_batches, meter)

        def flush():
            nonlocal done
            if not pending:
                return
            full = len(pending) == window or bool(min_tail and len(pending) >= min_tail)
            with profiler.span("window.stage_host", device=False):
                stacked = self._stage_window(pending) if full else None
            settle()
            if not full:
                # Short tail: a step a call.
                for b in pending:
                    self.state, metrics = self.train_step(
                        self.state, self.backbone, self.consts, self._device_batch(b))
                    meter.update(metrics)
            else:
                # A full window, or a tail of at least min_tail batches,
                # which the first window's capture serves.
                self.state, mstack = self.train_step_multi(
                    self.state, self.backbone, self.consts, stacked)
                # one meter entry per step (the window mean, pushed K
                # times) so the rolling average weights every step equally
                means = {k: v.mean() for k, v in mstack.items()}
                for _ in range(len(pending)):
                    meter.update(means)
            for b in pending:
                if "num_tasks" in b:
                    meter.update({"num_tasks": b["num_tasks"]})
            done += len(pending)
            pending.clear()
            if done % max(1, self.cfg.TRAIN.PRINT_FREQ) < window:
                deferred.append(done)

        for batch in batches:
            pending.append(batch)
            if len(pending) == window:
                flush()
        flush()
        settle()

    def after_epoch(self):
        cfg = self.cfg
        last_epoch = (self.epoch + 1) == self.max_epoch
        do_test = not cfg.TEST.NO_TEST
        meet_freq = (cfg.TRAIN.CHECKPOINT_FREQ > 0 and
                     (self.epoch + 1) % cfg.TRAIN.CHECKPOINT_FREQ == 0)
        if do_test and cfg.TEST.FINAL_MODEL == "best_val" and self.val_loader:
            result = self.test(split="val")
            if result > self.best_result:
                self.best_result = result
                self.save_checkpoint(best=True, val_result=result)
        if meet_freq or last_epoch:
            self.save_checkpoint(val_result=self.best_result)

    def after_train(self):
        cfg = self.cfg
        if not cfg.TEST.NO_TEST:
            if cfg.TEST.FINAL_MODEL == "best_val" and self.val_loader:
                print("Deploy the model with the best val performance")
                best = prompt_io.checkpoint_path(self.output_dir)
                if os.path.exists(best):
                    self.load_model(self.output_dir)
            self.test()
        self.writer.close()

    # ------------------------------------------------------------- inference
    def model_inference(self, batch: dict) -> torch.Tensor:
        batch = self._device_batch({k: batch[k] for k in ("image", "task") if k in batch})
        if self._eval_text is not None:
            return self.eval_step_cached(self.backbone, self.state.prompt_params,
                                         self._eval_text, batch)
        return self.eval_step(self.backbone, self.state.prompt_params, self.consts, batch)

    def test(self, split=None) -> float:
        """Per-task evaluation (the reference's mvlpt.py:989-1088)."""
        cfg = self.cfg
        if split is None:
            split = cfg.TEST.SPLIT
        if split == "val" and self.val_loader is not None:
            loader = self.val_loader
        else:
            split = "test"
            loader = self.test_loader
        print(f"Evaluate on the *{split}* set")

        self.evaluator.reset()
        coop = cfg.DATASET.COOP
        elevater_pred, elevater_true = [], []
        task_eval = {}
        if self.multi_task:
            task_eval = {t: self.evaluator.clone() if coop else {"y_pred": [], "y_true": []}
                         for t in self.dm._task_names}

        t0 = time.perf_counter()
        if self._eval_text_fn is not None:
            # one text-tower pass for the whole split (prompts frozen)
            self._eval_text = self._eval_text_fn(self.backbone, self.state.prompt_params,
                                                 self.consts)
        try:
            images = 0
            for logits_full, batch in pipelined_inference(loader, self.model_inference):
                n_valid = batch.get("n_valid", len(batch["image"]))
                images += n_valid
                logits = logits_full[:n_valid]
                labels = np.asarray(batch["label"])[:n_valid]
                if coop:
                    self.evaluator.process(logits, labels)
                elif not self.multi_task:
                    elevater_pred.append(logits)
                    elevater_true.append(labels)
                if "task" in batch:
                    tasks_np = np.asarray(batch["task"])[:n_valid]
                    for out, lab, tid in zip(logits, labels, tasks_np):
                        task = self.dm._id2task[int(tid)]
                        if coop:
                            lo, hi = self.dm._task_class_idx[task]
                            task_eval[task].process(out[None, lo:hi], np.asarray([lab - lo]))
                        else:
                            task_eval[task]["y_pred"].append(out[None])
                            task_eval[task]["y_true"].append(lab[None])
        finally:
            self._eval_text = None  # prompts train on after test()
        self.timings["tests"].append({"split": split, "wall_s": time.perf_counter() - t0,
                                      "images": images})

        results_overall = {}
        for task, ev in task_eval.items():
            print(f"evaluate on the *{task}* !")
            if coop:
                results = ev.evaluate()
                results_overall[task] = results["accuracy"]
            else:
                y_true = np.concatenate(ev["y_true"], axis=0)
                y_pred = np.concatenate(ev["y_pred"], axis=0)
                lo, hi = self.dm._task_class_idx[task]
                y_true, y_pred = y_true[:, lo:hi], y_pred[:, lo:hi]
                if self.dm._metric_name[task] == "accuracy":
                    y_true = np.argmax(y_true, axis=-1)
                value = self.dm._metric[task](y_true, y_pred)
                results = {self.dm._metric_name[task]: value}
                results_overall[task] = value
            print("results", results)
            for k, v in results.items():
                self.writer.write_scalar(f"{split}/{task}/{k}", v, self.epoch)

        print("Overall evaluation !")
        if self.multi_task:
            evalkey = cfg.DATASET.MULTITASK_EVALKEY
            if evalkey == "average":
                results = {"average": sum(results_overall.values())
                           / max(1, len(results_overall))}
            else:
                if evalkey not in results_overall:
                    raise KeyError(f"DATASET.MULTITASK_EVALKEY {evalkey!r} names no task: "
                                   f"{sorted(results_overall)}")
                results = {evalkey: results_overall[evalkey]}
        elif not coop:
            y_true = np.concatenate(elevater_true, axis=0)
            y_pred = np.concatenate(elevater_pred, axis=0)
            results = {self.dm._metric_name: self.dm._metric(y_true, y_pred)}
        else:
            results = self.evaluator.evaluate()
        print("results", results)
        for k, v in results.items():
            self.writer.write_scalar(f"/{split}/{k}", v, self.epoch)
        return float(list(results.values())[0])

    # ------------------------------------------------------------ checkpoint
    def _opt_payload(self) -> dict:
        """The optimizer's kind and its slots (SGD's momentum, Adam's mu and
        nu, RMSprop's nu), each by the params' dotted keys."""
        keys = tree_keys(self.state.prompt_params)
        opt = self.state.opt
        out = {"optimizer": opt.kind}
        for slot in SLOTS[opt.kind]:
            out[_payload_key(opt.kind, slot)] = {
                k: t.detach().cpu().numpy() for k, t in zip(keys, opt.slots[slot])}
        return out

    def save_checkpoint(self, best: bool = False, val_result=None):
        if val_result is not None and not np.isfinite(val_result):
            # last_step/NO_TEST runs pass the -inf best_result sentinel;
            # persist None so averaging/export never see -inf.
            val_result = None
        path = prompt_io.checkpoint_path(self.output_dir,
                                         epoch=None if best else self.epoch + 1)
        # the step and the optimizer's slots ride along for an exact resume
        # (the JAX package keeps optax's state as "opt_state", which it
        # reads and this package reads too)
        extra = {**self._opt_payload(), "step": self.state.step}
        if self.writes:
            prompt_io.save_prompt_checkpoint(path, self.state.prompt_params, self.epoch + 1,
                                             val_result, extra=extra)
            print(f"Checkpoint saved to {path}")
        barrier()  # under a mesh the other ranks wait for rank 0's file

    def load_model(self, directory, epoch=None):
        """Warm start / eval load (the reference's mvlpt.py:1090-1125)."""
        if not directory:
            print("Note that load_model() is skipped as no pretrained model is given")
            return
        path = prompt_io.find_checkpoint(directory, epoch)
        if not os.path.exists(path):
            raise FileNotFoundError(f'Model not found at "{path}"')
        if epoch is None and os.path.basename(path) != prompt_io.MODEL_BEST:
            print(f'WARNING: no {prompt_io.MODEL_BEST} in "{directory}"; loading the newest '
                  f'epoch checkpoint "{path}" instead')
        payload = prompt_io.load_prompt_checkpoint(path)
        print(f'Loading weights to prompt_learner from "{path}" (epoch = {payload["epoch"]})')
        params, _, skipped = prompt_io.apply_state_dict(self.state.prompt_params,
                                                        payload["state_dict"])
        if skipped:
            print(f"  skipped keys: {skipped}")
        self.state = self._init_state(params)

    def resume_from_checkpoint(self, directory):
        epochs = prompt_io.list_epoch_checkpoints(directory)
        if not epochs:
            print(f"No checkpoint found in {directory}, starting fresh")
            return
        payload = prompt_io.load_prompt_checkpoint(prompt_io.checkpoint_path(directory, epochs[-1]))
        params, _, _ = prompt_io.apply_state_dict(self.state.prompt_params, payload["state_dict"])
        self.state = self._init_state(params)
        self.epoch = payload["epoch"]
        # Restore the best-val watermark (the epoch checkpoint's
        # val_result, and model-best.pth.tar's, which is newer when
        # CHECKPOINT_FREQ > 1): without it a resumed best_val run would
        # overwrite model-best.pth.tar with its first val result.
        val = payload.get("val_result")
        if val is not None and np.isfinite(val):
            self.best_result = max(self.best_result, float(val))
        best_path = prompt_io.checkpoint_path(directory)
        if os.path.exists(best_path):
            best_val = prompt_io.load_prompt_checkpoint(best_path).get("val_result")
            if best_val is not None and np.isfinite(best_val):
                self.best_result = max(self.best_result, float(best_val))
        # The step (the lr table's position) and the optimizer's slots:
        # this package writes them by kind ("optimizer", "momentum",
        # "adam_mu", ...), the JAX package optax's states inside
        # "opt_state"; a reference-written checkpoint has neither, and
        # resumes with fresh state at the epoch's first step, as does a
        # checkpoint of another optimizer (with the JAX package's note).
        step = int(payload.get("step", self.epoch * self.steps_per_epoch))
        keys = tree_keys(self.state.prompt_params)
        opt = self.state.opt
        slots, offered = None, False
        own = [_payload_key(opt.kind, slot) for slot in SLOTS[opt.kind]]
        if payload.get("optimizer") is not None or "momentum" in payload:
            offered = True
            if payload.get("optimizer", "sgd") == opt.kind and all(
                    k in payload and set(payload[k]) == set(keys) for k in own):
                slots = {slot: payload[k] for slot, k in zip(SLOTS[opt.kind], own)}
        elif payload.get("opt_state") is not None:
            offered = True
            slots = _foreign_slots(payload["opt_state"], opt.kind, set(keys))
        if offered and slots is None:
            print("  (optimizer state in checkpoint incompatible; resuming with fresh momentum)")
        with torch.no_grad():
            if slots is not None:
                for slot, flat in slots.items():
                    for k, t in zip(keys, opt.slots[slot]):
                        t.copy_(torch.from_numpy(np.array(flat[k], np.float32)))
            opt.count.fill_(step)
        print(f"Resumed from epoch {self.epoch} (step {step})")


@TRAINER_REGISTRY.register()
class MVLPT(PromptTrainer):
    """Multitask vision-language prompt tuning (the reference's mvlpt.py:827)."""

    trainer_cfg_key = "MVLPT"


@TRAINER_REGISTRY.register()
class CoOp(PromptTrainer):
    """Text-context prompt tuning (the reference's coop.py:502); spec from
    TRAINER.COOP."""

    trainer_cfg_key = "COOP"

    def build_spec(self, clip_cfg, classnames):
        t = self.cfg.TRAINER.COOP
        n_ctx = t.N_CTX
        if t.CTX_INIT:
            n_ctx = len(t.CTX_INIT.replace("_", " ").split(" "))
        context_length = clip_cfg.context_length
        if self.cfg.TRAINER.CUT_CONTEXTLEN:
            context_length = compute_cut_context_length(
                classnames, n_ctx, clip_cfg.context_length, ctx_init=t.CTX_INIT)
        return PromptSpec(
            n_cls=len(classnames), coop_n_ctx=n_ctx, coop_csc=t.CSC,
            class_token_position=t.CLASS_TOKEN_POSITION, context_length=context_length,
            vision_layers=clip_cfg.vision_layers, vision_width=clip_cfg.vision_width,
            text_width=clip_cfg.transformer_width, embed_dim=clip_cfg.embed_dim,
            vision_patch_size=clip_cfg.vision_patch_size)

    def ctx_inits(self) -> tuple[str, str]:
        return self.cfg.TRAINER.COOP.CTX_INIT, ""


@TRAINER_REGISTRY.register()
class CoCoOp(PromptTrainer):
    """Conditional prompt tuning (the reference's cocoop.py:197); spec from
    TRAINER.COCOOP."""

    trainer_cfg_key = "COCOOP"

    def build_spec(self, clip_cfg, classnames):
        t = self.cfg.TRAINER.COCOOP
        n_ctx = t.N_CTX
        if t.CTX_INIT:
            n_ctx = len(t.CTX_INIT.replace("_", " ").split(" "))
        context_length = clip_cfg.context_length
        if self.cfg.TRAINER.CUT_CONTEXTLEN:
            context_length = compute_cut_context_length(
                classnames, n_ctx, clip_cfg.context_length, ctx_init=t.CTX_INIT)
        return PromptSpec(
            n_cls=len(classnames), cocoop_n_ctx=n_ctx, context_length=context_length,
            vision_layers=clip_cfg.vision_layers, vision_width=clip_cfg.vision_width,
            text_width=clip_cfg.transformer_width, embed_dim=clip_cfg.embed_dim,
            vision_patch_size=clip_cfg.vision_patch_size)

    def ctx_inits(self) -> tuple[str, str]:
        return "", self.cfg.TRAINER.COCOOP.CTX_INIT


def build_trainer(cfg, device="cuda"):
    from mvlpt_torch.models import zsclip  # noqa: F401  (registers the zero-shot trainers)
    from mvlpt_torch.train import finetune  # noqa: F401  (registers FinetuneCLIP)

    return TRAINER_REGISTRY.get(cfg.TRAINER.NAME)(cfg, device=device)
