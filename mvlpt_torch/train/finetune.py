"""Full-model finetune trainer (the ELEVATER finetune baseline).

The counterpart of ``mvlpt_tpu/train/finetune.py``. The reference vendors
the ELEVATER toolkit's finetune command (trainers/vision_benchmark/
commands/finetune.py + optim/build.py:88-170): CLIP's visual tower plus a
linear classification head, all parameters trainable, optionally with a
lower trunk learning rate (two-LR mode).

The trainable tree is {"visual": <tower>, "head": {kernel, bias}} with
nothing frozen; the PromptTrainer's loop, checkpoints and evaluation serve
it through the same (backbone, params, consts, batch) step signature with
an empty frozen side. The tower runs its plain path, as the JAX package's
does (it passes no attention function): none of the fused half-block
kernels, which return dx only and no weight gradients, runs here.
"""

from __future__ import annotations

import dataclasses

import torch

from mvlpt_torch.core import vit as vit_mod
from mvlpt_torch.core.clip import CLIPConfig
from mvlpt_torch.core.resnet import RNConfig
from mvlpt_torch.data.transforms import device_normalize
from mvlpt_torch.evaluation import ClassificationEvaluator
from mvlpt_torch.models.custom_clip import TaskClassRanges, _apply_task_mask
from mvlpt_torch.train.optim import build_lr_schedule
from mvlpt_torch.train.train_step import (
    WINDOW_METRICS,
    _ranges_on,
    apply_gradients,
    init_train_state,
    soft_cross_entropy,
)
from mvlpt_torch.train.trainer import PromptTrainer, load_clip_backbone
from mvlpt_torch.utils.registry import TRAINER_REGISTRY
from mvlpt_torch.utils.tree import tree_keys, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class FinetuneModel:
    clip_cfg: CLIPConfig
    compute_dtype: torch.dtype = torch.bfloat16
    # (mean, std) for raw-uint8 batches (TPU.DEVICE_NORMALIZE loaders);
    # float batches pass through device_normalize untouched.
    normalize: tuple | None = None

    def __call__(self, backbone, params, consts, images, tasks=None, task_ranges=None):
        if self.normalize is not None:
            images = device_normalize(images, *self.normalize)
        # Mixed precision: fp32 master params, cast to the compute dtype
        # inside the differentiated function, so the tower runs in the
        # compute dtype and the gradients come back in fp32.
        visual = tree_map(lambda x: x.to(self.compute_dtype), params["visual"])
        feats = vit_mod.encode_image(visual, images.to(self.compute_dtype),
                                     patch_size=self.clip_cfg.vision_patch_size,
                                     n_heads=self.clip_cfg.vision_heads)
        logits = feats.float() @ params["head"]["kernel"].float() + params["head"]["bias"]
        return _apply_task_mask(logits, tasks, task_ranges)


def finetune_groups(ocfg, params: dict) -> tuple[list, list]:
    """(OPTIM configs, each leaf's group) of ``build_finetune_optimizer``'s
    two-LR mode: with STAGED_LR the top-level key "head" trains at LR and
    every other key (the trunk) at LR * BASE_LR_MULT, each group with its
    own lr table; else one group."""
    keys = tree_keys(params)
    if not ocfg.STAGED_LR:
        return [ocfg], [0] * len(keys)
    trunk = ocfg.clone()  # unfrozen
    trunk.LR = ocfg.LR * ocfg.BASE_LR_MULT
    return [ocfg, trunk], [0 if k.split(".")[0] == "head" else 1 for k in keys]


def build_finetune_optimizer(params: dict, ocfg, steps_per_epoch: int):
    """(train state over ``params``, lr schedule): the device optimizer of
    OPTIM.NAME over two parameter groups under STAGED_LR
    (``finetune_groups``); the schedule is the head's (LR)."""
    ocfgs, group = finetune_groups(ocfg, params)
    return (init_train_state(params, ocfgs, steps_per_epoch, group),
            build_lr_schedule(ocfg, steps_per_epoch))


def make_finetune_step(model: FinetuneModel, task_ranges: TaskClassRanges | None = None):
    """step(state, backbone, consts, batch) -> (state, metrics): forward,
    soft-label cross-entropy, backward into the whole tree, the device
    optimizer's update (``train_step.apply_gradients``)."""

    def step_fn(state, backbone, consts, batch):
        nonlocal task_ranges
        task_ranges = _ranges_on(task_ranges, batch["image"].device)
        logits = model(backbone, state.prompt_params, consts, batch["image"],
                       batch.get("task"), task_ranges)
        loss = soft_cross_entropy(logits, batch["label"])
        values = apply_gradients(state, loss, logits, batch["label"])
        return state, dict(zip(WINDOW_METRICS, values))

    return step_fn


def make_finetune_eval(model: FinetuneModel, task_ranges: TaskClassRanges | None = None):
    """eval_step(backbone, params, consts, batch) -> fp32 logits, no grad."""

    @torch.no_grad()
    def eval_fn(backbone, params, consts, batch):
        nonlocal task_ranges
        task_ranges = _ranges_on(task_ranges, batch["image"].device)
        return model(backbone, params, consts, batch["image"], batch.get("task"), task_ranges)

    return eval_fn


@TRAINER_REGISTRY.register()
class FinetuneCLIP(PromptTrainer):
    """--trainer FinetuneCLIP: full-model finetune with a linear head."""

    trainer_cfg_key = "MVLPT"  # PREC etc. read from the MVLPT namespace

    def _dispatch_window(self) -> int:
        # Windowed dispatch needs the prompt-model protocol (embed_image,
        # pre_embedded) that FinetuneModel does not implement, as in the
        # JAX package; the full-tower backward dwarfs the dispatch cost.
        # Always run the per-batch path.
        window = int(self.cfg.TRAIN.STEPS_PER_DISPATCH)
        if window > 1 and self.epoch == 0:
            print(f"FinetuneCLIP: TRAIN.STEPS_PER_DISPATCH={window} "
                  f"ignored (windowed dispatch is a prompt-trainer "
                  f"optimization); running per-batch steps")
        return 1

    def _init_state(self, params: dict):
        state, _ = build_finetune_optimizer(params, self.cfg.OPTIM, self.steps_per_epoch)
        return state

    def build_model(self):
        cfg = self.cfg
        param_dtype, compute_dtype = self._dtypes()
        backbone, self.clip_cfg = load_clip_backbone(cfg, param_dtype, self.device)
        if isinstance(self.clip_cfg, RNConfig):
            raise ValueError("FinetuneCLIP currently finetunes the ViT tower")

        n_cls = self.num_classes
        out_dim = self.clip_cfg.embed_dim
        gen = torch.Generator().manual_seed(max(cfg.SEED, 0))
        # trainable tree: the whole visual tower (fp32 masters) + the head
        params = {
            "visual": tree_map(lambda x: x.float(), backbone["visual"]),
            "head": {
                "kernel": (torch.randn((out_dim, n_cls), generator=gen) * 0.01).to(self.device),
                "bias": torch.zeros((n_cls,), device=self.device),
            },
        }
        del backbone
        self.backbone = {}  # nothing frozen
        self.consts = None
        self.spec = None
        self.task_ranges = None
        if cfg.DATASET.MULTITASK_LABEL_PERTASK and hasattr(self.dm, "_task_class_idx"):
            idx = self.dm._task_class_idx
            self.task_ranges = TaskClassRanges(
                start=torch.tensor([idx[t][0] for t in self.dm._task_names], device=self.device),
                end=torch.tensor([idx[t][1] for t in self.dm._task_names], device=self.device))

        self.model = FinetuneModel(
            clip_cfg=self.clip_cfg, compute_dtype=compute_dtype,
            normalize=(tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)))
        self.steps_per_epoch = max(1, len(self.train_loader_x))
        self.state, self.lr_schedule = build_finetune_optimizer(params, cfg.OPTIM,
                                                                self.steps_per_epoch)
        self._normalize = None
        self.train_step = make_finetune_step(self.model, self.task_ranges)
        self.train_step_multi = None
        self.eval_step = make_finetune_eval(self.model, self.task_ranges)
        self._eval_text_fn, self.eval_step_cached, self._eval_text = None, None, None
        self.evaluator = ClassificationEvaluator(self.lab2cname)
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"Finetuning {n_params/1e6:.1f}M params "
              f"(visual tower + {n_cls}-way head)")
