"""Default config tree.

The counterpart of ``mvlpt_tpu/config/defaults.py``, every key with the
same default, so the same config files and override lists merge: the
Dassl defaults the reference reads, the MVLPT schema of its
``extend_cfg`` (train.py:105-169) and the ``TPU`` namespace, whose
names the port keeps (``TPU.USE_PALLAS`` selects the CUDA kernels,
``ops.attention.select_attn_fn``). :func:`validate_support` refuses what
the port does not run yet.
"""

from __future__ import annotations

from mvlpt_torch.config.config import CfgNode as CN


def get_cfg_default() -> CN:
    cfg = CN()
    cfg.VERSION = 1
    cfg.VERBOSE = True
    cfg.SEED = -1
    cfg.USE_CUDA = True  # accepted for script compat; entry points take a device
    cfg.OUTPUT_DIR = "./output"
    cfg.RESUME = ""

    # ------------------------------------------------------------------ input
    cfg.INPUT = CN()
    cfg.INPUT.SIZE = (224, 224)
    cfg.INPUT.INTERPOLATION = "bilinear"
    cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
    cfg.INPUT.PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
    cfg.INPUT.TRANSFORMS = ()
    cfg.INPUT.NO_TRANSFORM = False
    cfg.INPUT.CROP_PADDING = 4
    cfg.INPUT.RRCROP_SCALE = (0.08, 1.0)

    # ------------------------------------------------------------- dataloader
    cfg.DATALOADER = CN()
    # "python" (PIL threads) | "tf" (tf.data; refused) | "native" (C++
    # decode/resample core, bit-identical to "python": mvlpt_torch/native/)
    cfg.DATALOADER.BACKEND = "python"
    # native backend only: decode JPEGs at the smallest M/8 DCT scale
    # covering the output (large-photo speedup; not bit-identical)
    cfg.DATALOADER.NATIVE_FAST_JPEG = False
    cfg.DATALOADER.NUM_WORKERS = 4
    cfg.DATALOADER.K_TRANSFORMS = 1
    cfg.DATALOADER.RETURN_IMG0 = False
    cfg.DATALOADER.TRAIN_X = CN()
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 32
    cfg.DATALOADER.TRAIN_X.N_DOMAIN = 0
    cfg.DATALOADER.TRAIN_X.N_INS = 16
    cfg.DATALOADER.TRAIN_U = CN()
    cfg.DATALOADER.TRAIN_U.SAME_AS_X = True
    cfg.DATALOADER.TRAIN_U.SAMPLER = "RandomSampler"
    cfg.DATALOADER.TRAIN_U.BATCH_SIZE = 32
    cfg.DATALOADER.TRAIN_U.N_DOMAIN = 0
    cfg.DATALOADER.TRAIN_U.N_INS = 16
    cfg.DATALOADER.TEST = CN()
    cfg.DATALOADER.TEST.SAMPLER = "SequentialSampler"
    cfg.DATALOADER.TEST.BATCH_SIZE = 100

    # ---------------------------------------------------------------- dataset
    cfg.DATASET = CN()
    cfg.DATASET.ROOT = ""
    cfg.DATASET.NAME = ""
    cfg.DATASET.SOURCE_DOMAINS = ()
    cfg.DATASET.TARGET_DOMAINS = ()
    cfg.DATASET.NUM_SHOTS = -1
    cfg.DATASET.NUM_LABELED = -1
    cfg.DATASET.ALL_AS_UNLABELED = False
    # MVLPT extensions (train.py:152-168)
    cfg.DATASET.SUBSAMPLE_CLASSES = "all"  # all, base or new
    cfg.DATASET.NUM_SAMPLES_PER_CLASS = 20
    cfg.DATASET.DATASET = ""
    cfg.DATASET.RANDOM_SEED_SAMPLING = 1
    cfg.DATASET.VAL_SET = ""
    cfg.DATASET.TRAIN_SET = "train"
    cfg.DATASET.TEST_SET = "val"
    cfg.DATASET.CENTER_CROP = False
    cfg.DATASET.COOP = False
    cfg.DATASET.MULTITASK = False
    cfg.DATASET.MULTITASK_LABEL_PERTASK = False
    cfg.DATASET.MULTITASK_EVALKEY = "average"
    # Per-task metric overrides ("task=metric"). The reference scores
    # hateful-memes with plain accuracy via its class_map_metric table
    # (prompts.py:3249) although the ELEVATER leaderboard uses roc_auc;
    # the bug-compatible table stays the default, this knob opts into
    # e.g. ("hateful-memes=roc_auc",).
    cfg.DATASET.METRIC_OVERRIDES = ()

    # ------------------------------------------------------------------ model
    cfg.MODEL = CN()
    cfg.MODEL.INIT_WEIGHTS = ""
    cfg.MODEL.BACKBONE = CN()
    cfg.MODEL.BACKBONE.NAME = "ViT-B/16"
    cfg.MODEL.BACKBONE.PRETRAINED = True
    cfg.MODEL.HEAD = CN()
    cfg.MODEL.HEAD.NAME = ""

    # ------------------------------------------------------------------ optim
    cfg.OPTIM = CN()
    cfg.OPTIM.NAME = "sgd"
    cfg.OPTIM.LR = 0.0003
    cfg.OPTIM.WEIGHT_DECAY = 5e-4
    cfg.OPTIM.MOMENTUM = 0.9
    cfg.OPTIM.SGD_DAMPNING = 0.0
    cfg.OPTIM.SGD_NESTEROV = False
    cfg.OPTIM.RMSPROP_ALPHA = 0.99
    cfg.OPTIM.ADAM_BETA1 = 0.9
    cfg.OPTIM.ADAM_BETA2 = 0.999
    cfg.OPTIM.LR_SCHEDULER = "single_step"
    cfg.OPTIM.STEPSIZE = (-1,)
    cfg.OPTIM.GAMMA = 0.1
    cfg.OPTIM.MAX_EPOCH = 10
    cfg.OPTIM.WARMUP_EPOCH = -1
    cfg.OPTIM.WARMUP_TYPE = "linear"
    cfg.OPTIM.WARMUP_CONS_LR = 1e-5
    cfg.OPTIM.WARMUP_MIN_LR = 1e-5
    cfg.OPTIM.WARMUP_RECOUNT = True
    # Dassl staged-lr keys (used by the full-finetune trainer: trunk lr =
    # LR * BASE_LR_MULT, head lr = LR — the two-LR mode of
    # vision_benchmark/optim/build.py:88-170)
    cfg.OPTIM.STAGED_LR = False
    cfg.OPTIM.NEW_LAYERS = ()
    cfg.OPTIM.BASE_LR_MULT = 0.1

    # ------------------------------------------------------------------ train
    cfg.TRAIN = CN()
    cfg.TRAIN.CHECKPOINT_FREQ = 0
    cfg.TRAIN.PRINT_FREQ = 10
    cfg.TRAIN.COUNT_ITER = "train_x"
    # Windowed dispatch: K loader batches a call of the windowed step
    # (train/train_step.py: make_train_step_multi), one step captured as
    # a CUDA graph and replayed K times. 1 = one call a batch. The
    # window is clamped to the epoch length.
    cfg.TRAIN.STEPS_PER_DISPATCH = 1
    # An epoch whose length is not a multiple of the window leaves a
    # tail of N % window batches: a tail of at least this many runs as
    # one window (served by the first window's capture), a shorter one
    # a step a call. 0: tails always run a step a call.
    cfg.TRAIN.WINDOW_MIN_TAIL = 8

    # ------------------------------------------------------------------- test
    cfg.TEST = CN()
    cfg.TEST.EVALUATOR = "Classification"
    cfg.TEST.PER_CLASS_RESULT = False
    cfg.TEST.COMPUTE_CMAT = False
    cfg.TEST.NO_TEST = False
    cfg.TEST.SPLIT = "test"
    cfg.TEST.FINAL_MODEL = "last_step"  # or "best_val"

    # ---------------------------------------------------------------- trainer
    cfg.TRAINER = CN()
    cfg.TRAINER.NAME = ""

    cfg.TRAINER.COOP = CN()
    cfg.TRAINER.COOP.N_CTX = 16
    cfg.TRAINER.COOP.CSC = False
    cfg.TRAINER.COOP.CTX_INIT = ""
    cfg.TRAINER.COOP.PREC = "fp16"  # fp16, fp32, amp (fp16/amp -> bf16)
    cfg.TRAINER.COOP.CLASS_TOKEN_POSITION = "end"

    cfg.TRAINER.COCOOP = CN()
    cfg.TRAINER.COCOOP.N_CTX = 16
    cfg.TRAINER.COCOOP.CTX_INIT = ""
    cfg.TRAINER.COCOOP.PREC = "fp16"

    cfg.TRAINER.MVLPT = CN()
    cfg.TRAINER.MVLPT.PREC = "fp16"
    cfg.TRAINER.MVLPT.PROJECT_METHOD = "transformer"  # identity / mlp / transformer
    cfg.TRAINER.MVLPT.PROJECT_DIM = 128

    cfg.TRAINER.MVLPT.VPT = CN()
    cfg.TRAINER.MVLPT.VPT.N_CTX = 0
    cfg.TRAINER.MVLPT.VPT.CSC = False
    cfg.TRAINER.MVLPT.VPT.CTX_INIT = ""
    cfg.TRAINER.MVLPT.VPT.DROPOUT = 0.0
    cfg.TRAINER.MVLPT.VPT.PROJECT = -1
    cfg.TRAINER.MVLPT.VPT.DEEP = True

    cfg.TRAINER.MVLPT.COOP = CN()
    cfg.TRAINER.MVLPT.COOP.N_CTX = 0
    cfg.TRAINER.MVLPT.COOP.CSC = False
    cfg.TRAINER.MVLPT.COOP.CTX_INIT = ""
    cfg.TRAINER.MVLPT.COOP.CLASS_TOKEN_POSITION = "middle"

    cfg.TRAINER.MVLPT.COCOOP = CN()
    cfg.TRAINER.MVLPT.COCOOP.N_CTX = 0
    cfg.TRAINER.MVLPT.COCOOP.CTX_INIT = ""
    cfg.TRAINER.MVLPT.COCOOP.PREC = "fp16"

    cfg.TRAINER.CUT_CONTEXTLEN = False
    cfg.TRAINER.ACT_CKPT = 1

    # ------------------------------------------ device (names kept) ---
    cfg.TPU = CN()
    cfg.TPU.MESH_DATA = -1      # -1: all devices on the data axis
    cfg.TPU.MESH_MODEL = 1      # tensor-parallel axis size
    cfg.TPU.USE_PALLAS = "auto"  # "auto" | "on" | "off" | "block"
    cfg.TPU.PARAM_DTYPE = "bfloat16"   # frozen backbone storage dtype
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.PROMPT_DTYPE = "float32"   # trainable prompt master dtype
    # Stage raw uint8 pixels and normalize on the device: the CLIP
    # (x/255-mean)/std affine folds into the frozen patch-embed product
    # (core/vit.py:embed_image). Off by default for parity with the
    # reference's host-side normalize.
    cfg.TPU.DEVICE_NORMALIZE = False
    # Windowed dispatch only: run the frozen ViT stem over all K staged
    # batches once before the steps instead of once a step (no gradient
    # flows through the stem).
    cfg.TPU.PRE_EMBED_WINDOW = True
    return cfg



def optim_config(**overrides) -> CN:
    """The default OPTIM node with ``overrides`` set, for callers that
    build a train step without a whole config."""
    node = get_cfg_default().OPTIM
    for key, value in overrides.items():
        if key not in node:
            raise KeyError(f"Non-existent config key: OPTIM.{key}")
        node[key] = value
    return node

def validate_support(cfg) -> None:
    """Fail loudly on keys whose non-default values nothing runs.

    As in the JAX package: the Dassl DataLoader features MVLPT never
    exercises. Besides, the "tf" data backend, which the port does not
    run (``data/tfdata.py`` imports TensorFlow, which the port does not
    use; ROADMAP.md Queue 1). TPU.MESH_DATA/MESH_MODEL take any value: the
    trainer checks the mesh against the run's ranks
    (``train.trainer.build_mesh``)."""
    problems = []
    if cfg.DATALOADER.K_TRANSFORMS != 1:
        problems.append("DATALOADER.K_TRANSFORMS != 1 (multi-view "
                        "augmentation) is not implemented")
    if cfg.DATALOADER.RETURN_IMG0:
        problems.append("DATALOADER.RETURN_IMG0 (un-augmented image "
                        "passthrough) is not implemented")
    for sub in ("TRAIN_X", "TRAIN_U"):
        node = cfg.DATALOADER[sub]
        if node.SAMPLER not in ("RandomSampler", "SequentialSampler"):
            problems.append(
                f"DATALOADER.{sub}.SAMPLER={node.SAMPLER!r}: only "
                "RandomSampler/SequentialSampler are implemented")
        if node.N_DOMAIN != 0 or node.N_INS != 16:
            problems.append(
                f"DATALOADER.{sub}.N_DOMAIN/N_INS only apply to the "
                "domain/class samplers, which are not implemented")
    if problems:
        raise NotImplementedError("; ".join(problems))

    missing = []
    if cfg.DATALOADER.BACKEND not in ("python", "native"):
        missing.append(f"DATALOADER.BACKEND {cfg.DATALOADER.BACKEND!r}: only 'python' and "
                       "'native' (ROADMAP.md Queue 1: data/tfdata.py is not ported)")
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))
