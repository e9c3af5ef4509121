#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mvlpt_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

1. Builds the six kernel sources of mvlpt_torch/csrc with nvcc (sm_90a),
   one process a source, and prints the build time, the vocab in use and
   the card.
2. Holds each kernel against its plain PyTorch twin on the card, in fp32
   and bf16: the tensor-parallel parts at tp = 2 on rank 0's shard of
   the image train and packed text shapes, and the tp shards' partials
   summed and finished against the plain twin on the full weights (the
   single-device kernels' outputs printed beside it); the
   half-block kernels at the flagship shapes (ViT-B/16
   image tower at batch 32, and at the eval batch 100 for the
   no-residual forwards; class-packed text tower with its block-causal
   mask); the attention half-blocks (#1, #2, #5, and #7/#8 at tp = 2) at
   ViT-L/14@336px width and length (W = 1024, H = 16, S = 581, batch 4);
   the attention half-blocks (#1, #2, #5, and #7/#8 at tp = 2) at
   S = 1024 under a causal mask, past the bf16 cores' windows of keys;
   and the standalone attention (forward and backward) at the image
   train and eval shapes, the packed text rows, CLIP's full text context,
   the edges of the tensor-core tiling (S = 1, 17, 261, each bf16
   bucket's largest S and one past it, the fp32 kernels' largest S before
   they streamed their rows) and S = 581 and 1024; and the backwards'
   K-major wgmma GEMM alone (the MLP backward's two epilogues and the
   attention backward's rounding one, both tile widths) at the image, text
   and ViT-L/14@336px rows and a ragged edge. fp32 rows
   hold to 1e-4 x max|twin|; bf16 rows to the rule at TOL, against the
   twin and the fp64-summed twin, each printing the old bound's verdict
   beside it (ok_old). The attention forwards in train mode (#1, #7) are
   held on each output: y (or the fp32 partial), and the residuals qkv,
   probs, mu and rstd that the backward reads. Each row names its route where it has more than
   one: the standalone attention's by dtype and S (attention.route_of:
   bf16 on the tensor cores up to the buckets, on the CUDA cores past
   them; fp32 on the CUDA cores), the MLP and attention half-blocks' by
   dtype (MLP_ROUTES, ATTN_FWD_ROUTES, ATTN_BWD_ROUTES: bf16 through the
   wgmma GEMM, the attention cores on mma.sync). In bf16 each
   standalone-attention wrapper may request nothing beyond its outputs
   and its route's scratch, attn_fwd (and its part) nothing beyond its
   outputs and residuals and its xh and o scratch, attn_bwd (and its
   part) nothing beyond its output and its do, dqkv, fp32 dxh and (B, H,
   S) fp32 t scratch, mlp_fwd nothing beyond its outputs and its xh and
   act scratch, mlp_bwd (and its part) nothing beyond its output and its
   dh and fp32 dxh scratch. ptxas must report no spills for any
   tensor-core kernel (the standalone attention's, the attention
   half-blocks' cores and the wgmma GEMM's), in this run's build or the
   cached one's; the attn_fwd, attn_bwd, mlp_fwd and mlp_bwd libraries
   must hold HGMMA in their SASS, and attn_fwd's and attn_bwd's also HMMA
   (their mma.sync cores). Times kernel, twin and a
   library call computing the same function (scaled_dot_product_attention
   on the attention core; for the attention backwards its forward and
   backward by autograd) as the median of REPS event-timed runs each, the
   kernel's spread [min, max] beside it, and, as a yardstick for the MLP
   and attention half-blocks' products alone, cuBLAS's two products on
   the same inputs (gemm_library_ms).
3. Drives the port's paths, each with the launch counts set to 0 just
   before it and read just after, against the plain path ('off') on the
   same inputs:
   - the flagship MVLPT UPT train step (ViT-B/16, batch 32, 100 classes,
     bf16) for a few SGD steps under 'auto' (half-block kernels) and
     'on' (standalone attention), first loss within 1e-2;
   - eval of the prompt through the cached-text fast path at batch 100
     under 'auto' (the no-grad half-block forwards) and 'on', its
     logits equal to the full eval step's, its soft-CE within 1e-2 of
     the plain path's;
   - zero-shot CLIP over the 100 class names and the 7 select templates,
     at batch 100 under 'auto' and 'on', held as eval is;
   - the tensor-parallel train step, train[tp2]: two ranks in two spawned
     processes share the one card as a (data=1, model=2) mesh, each with
     its Megatron shard of the flagship, for a few SGD steps under
     'block'. Rank 0's first loss and grad norm held to train[auto]'s on
     the same batch (TP_REL), in bf16 and, for one more step, in fp32;
     each rank's layer 0 of both towers (y and dx, through the
     all-reduce) against the block's plain twin on the full weights under
     the rule at TOL (#1-#4 printed beside it), in bf16 and fp32, and
     equal across the ranks; the prompt params
     bit-equal across the ranks afterwards; and on each rank only the four
     tensor-parallel kernels launched, 24 times a step.
     Its step time is that of two processes time-slicing one card with
     all-reduces through the host: it is not a tensor-parallel speed;
   - ViT-L/14@336px (S = 581 on the image tower) at batch 8: one train
     step under 'auto' and 'on', first loss within 1e-2 of 'off''s, and
     one cached-text eval batch under each, held as eval is;
   - the windowed train step (make_train_step_multi, pre_embed, uint8
     images with normalize) under 'auto' and 'on' (train_window[sel]):
     two windows of 8 steps three ways from the same prompt, one step a
     call, the window run eagerly (capture=False) and the window replayed
     from its CUDA graph; the replay equal to the eager window bit for
     bit; the eager window's losses, grad norms and prompt leaves equal
     to the per-step path's bit for bit (it reads the window's own
     pre-embedded tokens), and two broken windows (a batch index shifted
     by one, a frozen lr) unequal.
     A replay calls no kernel wrapper: the replayed window's launches
     are counted in a torch.profiler trace by kernel name (TRACE_MARKS),
     and it must run the repo's kernels as often as the eager window.
     Then under 'auto' the shipped window of 120 steps
     (train_window_k120[auto]): a warm-up window with the capture, then
     two timed, with ms/step on the host clock and CUDA events, img/s,
     MFU (utils/flops.py at the run's text shape over the dense bf16
     rate) and peak memory, the card's name and power limit on each line;
     then its graph replays 8 of those batches under a trace, which
     counts its launches.
   - the training CLI end to end (trainer_cli, ``drive_trainer_cli``):
     ``python -m mvlpt_torch.cli.train``'s main in-process at full width
     (random ViT-B/16, MVLPT UPT, --dataset-coop on a 100-class dataset
     it writes, configs/trainers/MVLPT/vit_b16_tpu_fast.yaml, windows of
     20 with a tail window of 10, best-val selection, two epochs): one
     capture over both epochs, #1-#6 launched, the checkpoints and a
     results line written, an --eval-only rerun's test logits bit-equal,
     the first loss within 1e-2 of an 'off' run's; its epoch times,
     img/s with the loading, the loader's share, test() img/s and peak
     memory.
   - ELEVATER through the CLI (``drive_trainer_elevater``), on the 20
     tasks of scripts/mvlpt/main_mt_elevater_cut.sh written under build/
     with their real class names (1151 classes), a random ViT-B/16 at full
     width: trainer_elevater, the multitask UPT run with the script's
     flags (--multi-task --multi-task-label_pertask --cut-contextlen
     --act-ckpt 4, NCTX 16, 'middle', best_val), two epochs: one capture,
     the replayed window equal bit for bit to the eager window, a traced
     replay launching #1 and #3 twice as often as #2 and #4 (remat), the
     first window equal bit for bit to an --act-ckpt 1 run's, an
     --eval-only rerun's test logits bit-equal, every result finite; its
     window ms/step (host and CUDA events) and MFU with and without
     remat, peak memory, epoch img/s and loader share, every task's
     metric. trainer_elevater_transfer: one task warm-started from that
     run's best prompt (main_single_elevater_cut.sh). zeroshot_cli:
     ZeroshotCLIP on trainer_cli's dataset, ZeroshotCLIP2 on an ELEVATER
     task (zeroshot.sh), #5 and #6 launched. The half-block check rows
     (#1-#6) also run at each shape these runs give the kernels: the
     ELEVATER-20 and the transfer task's text towers, the image tower
     with 16 VPT rows at the train and eval batches, and the zero-shot
     image tower; each run fails if its shapes are not its rows'.
   - CoCoOp through the CLI (``drive_trainer_cocoop``), on a synthetic
     ImageNet of 1000 wnid folders written under build/, a random
     ViT-B/16 at full width, configs/trainers/CoCoOp/vit_b16.yaml (N_CTX
     16, s = 77, causal, G = 1): trainer_cocoop, scripts/cocoop/
     base2new_train.sh imagenet 1 (500 base classes, 16,000 text
     sequences a step in 4 checkpointed chunks of 4000) and
     base2new_test.sh imagenet 1 (500 new classes, chunks of 2500 at
     batch 100), #1-#6 launched exactly as the steps and test batches
     need; trainer_cocoop_window, the same training in windows of 5: one
     capture, a traced replay launching #1-#4, the replay equal bit for
     bit to the eager window and to one step a call; cocoop_memory, one
     step at SUN397 base (199 classes, 6368 rows, no chunk checkpoint
     under the rule) and with the checkpoint forced, bit-equal, each
     one's peak memory. ms/step (host and CUDA events), img/s, MFU by
     model FLOPs, peak memory, test() img/s. Check rows for #1-#6 at the
     text chunk (4000, 77), the test chunk (2500, 77) and the image tower
     without VPT rows at (32, 197); each run fails if its shapes are not
     its rows'.
   - The linear probe (``drive_lpclip``): ``python -m mvlpt_torch.cli.lpclip
     extract-features`` with RN50 at batch 128 on trainer_cli's dataset,
     from a random init and from an OpenAI-layout RN50 state_dict the
     phase writes (the converter at full size), no kernel launched; the
     tower's ms a batch (CUDA events and the host clock), img/s alone and
     with the loading, peak memory; the bf16 tower's trunk (the map the
     attention pool reads) on the first batch against the fp32 one on the
     card (TF32 off), each row's cosine at least LP_COS, the features the
     CLI wrote for that batch against the fp32 tower's printed beside it
     with the pool's peak probability; then ``probe`` on the converted
     run's features, the
     sweep cut (LP_RUNS, LP_STEPS, LP_SHOTS): wall time, fits, mean
     L-BFGS iterations a fit.
   - ELEVATER feature extraction (``drive_extract_features``): the CLI at
     its defaults (ViT-B/32, batch 128) on EXTRACT_TASK with its real
     class names and --knowledge wiki gpt3: #5 and #6 launched 12 times
     an image batch, no other kernel; image img/s and the knowledge text
     step's ms. Check rows for #5/#6 at its image tower, (128, 50, 768,
     H 12); the run fails if its blocks' shapes are not that row's.
   - The model zoo (``drive_zoo_extract``): extract_features
     --model on the same task, in bf16 at batch 128, for
     vit_base_patch16_224 (timm), resnet50 (torchvision) and
     efficientnet_b0 (timm), each from a full-width random state dict in
     its library's key layout (tests/torch_port_util.py's writers): every
     split's rows as the CLIP extraction's, finite features of the
     family's width, no kernel of the repo launched, 4 test images' fp32
     features on the card within 1e-4 x max|ref| of the CPU's, the bf16
     features' cosine to fp32 at least ZOO_COS; img/s with the loading,
     the tower's ms a batch alone, peak memory, load-and-convert seconds.
     interpret_prompt (``drive_interpret_prompt``): the CLI with the
     random ViT-B/16 on a CoOp-layout checkpoint, its top 5 against
     float64 numpy on the host.
   - The rest of the training CLI (PR 15), after trainer_cli:
     trainer_adamw_dropout (``drive_trainer_adamw_dropout``): trainer_cli's
     run with AdamW and VPT dropout 0.1: the replayed window equal bit for
     bit to the eager window, and that to one step a call, with dropout
     live; two consecutive one-step replays of its graph drawing
     different masks, each the counter's for its step, kept share within
     5 sigma of 0.9; a second seed giving other losses; an Adam and an
     RMSprop window each replayed from its own graph, equal to its eager
     self; ms/step, img/s and peak memory beside the SGD window of
     train_window_k120[auto]. debug_nans (``drive_debug_nans``): the CLI
     with --debug-nans builds the trainer; a step with a NaN pixel raises
     FloatingPointError naming step 1, the same step without it runs.
     post_run (``drive_post_run``): avg_ckpt over trainer_cli's and
     trainer_adamw_dropout's prompts, export_ckpt of the average,
     --eval-only on it (#5 and #6 launched), parse_test_res over the
     runs. finetune_cli (``drive_finetune_cli``): --trainer FinetuneCLIP
     on cifar-10 at 224 px, batch 32, AdamW with STAGED_LR, two epochs,
     best_val: no kernel of the repo launched (the plain path), the first
     bf16 loss within 1e-2 of fp32 on the same batch and weights, an
     --eval-only rerun's test logits bit-equal; ms/step, img/s, peak
     memory and the parameter count.
   - The data side (PR 16). trainer_cli stages its batches through
     ``prefetch_to_device`` (pinned ring, side stream) and prints its
     loader-wait and staging shares beside PR 15's figures.
     trainer_cli_native (``drive_trainer_cli_native``, after
     trainer_cli): its data, flags and cuts on DATALOADER.BACKEND
     "native", one epoch: the C++ core built from the checkout's sources
     (the toolchain line: g++, the route, the libjpeg and libpng it
     resolves), every image on its fast path, the loaders' transforms the
     native ones, the first window's staged images and labels hashing as
     trainer_cli's and its step-0 loss equal bit for bit, the tokenizer's
     native BPE live. lpclip_native (``drive_lpclip_native``, after
     lpclip): lpclip's random-RN50 extraction with a --config-file on
     "native", every split's features bit-equal to the python run's,
     img/s by split beside it.
   - The mesh, last (after interpret_prompt). mesh_cli (``drive_mesh_cli``): the
     training CLI on trainer_cli's data and flags (4 shots: one eager
     window of 12 steps, one epoch) as two ranks that share the card
     (torchrun's variables, gloo), once with TPU.MESH_DATA 2 and once
     with TPU.MESH_MODEL 2 TPU.MESH_DATA 1, then on one rank, and the
     single-rank CLI's --eval-only on the data-axis run's directory:
     every rank exits 0, only rank 0 writes files, both ranks print the
     same results, the first loss and grad norm within TP_REL of one
     rank's, the test logits and accuracy within MESH_LOGIT_REL and
     MESH_ACC_PP (``_logit_bound``), #1-#4 (data axis) or #7-#10 (model
     axis) launched 24 times a step and nothing else in training, #5/#6
     or #7/#9 in test(); each rank's step ms, img/s with the loading,
     share in dist.all_reduce and peak memory, which are no scaling
     figures (two ranks time-slice one card). pod_loss_check
     (``drive_pod_loss_check``): scripts/torch_port_pod_loss_check.py on
     a (1, 2) mesh, ViT-B/16 bf16, 3 SGD steps under 'on' and 'off',
     losses within TP_REL of one rank's, #11/#12 alone under 'on' on 6
     of the 12 heads a rank, no kernel under 'off'.
   - The extraction read (``read_turns``): lpclip's random RN50,
     extract_features and zoo_extract's ViT run again with the previous
     ``pipelined_inference`` read (batch i's ``.cpu()`` queued behind
     batch i+1's tower) and then the shipped one, printing img/s with the
     loading of each, in turns.
4. Prints a summary line (img/s, ms/step, MFU, peak memory), one JSON
   line of kernel numbers, then, as the last line, {"ok": true,
   "device": {...}}.

Any failure raises and exits non-zero without the last line. Without a
card, or outside a checkout, it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STEPS = 6                 # SGD steps a train path (the first one warms up)
TP = 2                    # model ranks of the tensor-parallel phases
TP_STEPS = 4              # SGD steps of train[tp2]
TP_TIMEOUT_S = 420        # the spawned ranks' deadline
# train[tp2]'s first loss and grad norm against train[auto]'s on the same
# batch, relative. In bf16 another summation order alone moves them by up
# to 3e-4 and 1.1e-2 on an H100 (scripts/torch_port_tp_drift.py), and
# uniform logits would move the loss by 4.8e-3; in fp32 the same
# comparisons agree within 1e-6.
TP_REL = {"bfloat16": {"loss": 1e-3, "grad_norm": 2e-2},
          "float32": {"loss": 1e-5, "grad_norm": 1e-5}}
OPTIM = dict(LR=0.002, LR_SCHEDULER="cosine", MAX_EPOCH=200)
EVAL_BATCH = 100          # the reference TEST batch
REPS = 20                 # event-timed runs a kernel, twin or library call (median, spread)
EVAL_BATCHES = 4          # eval and zero-shot batches a path (the first one warms up)
HBM_BYTES_S = 3.35e12     # H100 SXM memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; fp32 CUDA cores
# The rule a check row holds its kernel to (``verdict``). fp32: max|out -
# ref| <= 1e-4 x max|ref|, ref the plain twin (ops/block.py,
# ops/attention.py). bf16: out, ref and ref64, the fp64-summed twin (the
# twin with acc=torch.float64: its rounding points, every sum in fp64), on
# the same inputs; the row passes when
#     max|out - ref64| <= max(TWIN_FACTOR x max|ref - ref64|, 5e-3 x max|ref64|).
# A kernel may sit at most twice as far from exact sums as the twin does
# (the practice of the FlashAttention test suite), with the old bound as
# the floor. The kernels sum in another order than the twins, so where a
# value lands near a rounding boundary a bf16 output can round the other
# way; the twin's own fp32 sums do the same against exact ones. The old
# bf16 bound, 5e-3 x max|ref| against ref, is printed beside the rule
# (tol_old, ok_old) and stops nothing.
TOL = {"float32": 1e-4, "bfloat16": 5e-3}
TWIN_FACTOR = 2
# Each kernel of the path, in ops._build.LAUNCHES' names: (source,
# TPU kernel it replaces, the check row whose numbers it reports as
# (name, mode, shape, dtype)).
KERNELS = {
    "attn_fwd": ("attn_fwd", "mvlpt_tpu/ops/block.py:149", ("attn_fwd", "train", "image")),
    "attn_bwd": ("attn_bwd", "mvlpt_tpu/ops/block.py:226", ("attn_bwd", "train", "image")),
    "mlp_fwd": ("mlp_fwd", "mvlpt_tpu/ops/block.py:486", ("mlp_fwd", "train", "image")),
    "mlp_bwd": ("mlp_bwd", "mvlpt_tpu/ops/block.py:532", ("mlp_bwd", "train", "image")),
    "attn_fwd_infer": ("attn_fwd", "mvlpt_tpu/ops/block.py:449",
                       ("attn_fwd", "no-residual", "image_eval")),
    "mlp_fwd_infer": ("mlp_fwd", "mvlpt_tpu/ops/block.py:626",
                      ("mlp_fwd", "no-residual", "image_eval")),
    "attend_fwd": ("attend_fwd", "mvlpt_tpu/ops/attention.py:69",
                   ("attend_fwd", "core", "image_eval")),
    "attend_bwd": ("attend_bwd", "mvlpt_tpu/ops/attention.py:81",
                   ("attend_bwd", "core", "image_train")),
    "attn_fwd_tp": ("attn_fwd", "mvlpt_tpu/ops/block.py:902", ("attn_fwd_tp", "part", "image")),
    "attn_bwd_tp": ("attn_bwd", "mvlpt_tpu/ops/block.py:966", ("attn_bwd_tp", "part", "image")),
    "mlp_fwd_tp": ("mlp_fwd", "mvlpt_tpu/ops/block.py:1024", ("mlp_fwd_tp", "part", "image")),
    "mlp_bwd_tp": ("mlp_bwd", "mvlpt_tpu/ops/block.py:1072", ("mlp_bwd_tp", "part", "image")),
}
# Kernels each path must launch, and how many times per unit of work
# (per train step or per layer-tower pass); every other kernel, 0 times.
TRAIN_KERNELS = {"auto": ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd"),
                 "on": ("attend_fwd", "attend_bwd")}
EVAL_KERNELS = {"auto": ("attn_fwd_infer", "mlp_fwd_infer"), "on": ("attend_fwd",)}
TP_KERNELS = ("attn_fwd_tp", "attn_bwd_tp", "mlp_fwd_tp", "mlp_bwd_tp")
# The long-sequence phase: ViT-L/14@336px, whose image tower runs S = 1 +
# 24 x 24 + 4 VPT rows = 581.
VITL336 = dict(backbone_name="ViT-L/14@336px", batch=8)
# The windowed train step (train.make_train_step_multi, pre_embed, uint8
# images with normalize). Its checks run WINDOW_CHECK_WINDOWS windows of
# WINDOW_CHECK_K steps (the first captures the step, the second only
# replays it) under OPTIM's cosine cut to WINDOW_CHECK_EPOCHS epochs of
# WINDOW_CHECK_SPE steps, so the lr falls at every fourth step inside the
# windows; the timing runs the shipped window of WINDOW_K steps
# (configs/trainers/MVLPT/vit_b16_tpu_fast.yaml:34), one warm-up window
# with the capture, then WINDOW_TIMED timed. At WINDOW_SPE steps an epoch
# a window of WINDOW_K crosses an epoch boundary of the lr table.
WINDOW_CHECK_K, WINDOW_CHECK_WINDOWS = 8, 2
WINDOW_CHECK_SPE, WINDOW_CHECK_EPOCHS = 4, 4
WINDOW_K, WINDOW_TIMED = 120, 2
WINDOW_SPE = 100
# The eager window against one make_train_step call a batch, from the same
# prompt (``_window_gaps``): the largest relative gap over the steps of
# the loss and of the grad norm, and the largest gap of the prompt
# leaves' displacement (leaf less its initial value) relative to the
# per-step path's largest displacement. The per-step path reads the
# window's own pre-embedded tokens (the stem's output over all K x B
# images, sliced a batch a step) and updates with the same device SGD,
# so the two run the same operations on the same values: every gap must
# be 0, bit equality. Two broken windows (WINDOW_CONTROLS: step k reading
# batch k + 1, the lr frozen at its first value) must not be.
WINDOW_REL = {"loss": 0.0, "grad_norm": 0.0, "displacement": 0.0}
# Which gaps each broken window must exceed: a frozen lr leaves the first
# epoch's steps as they were, so only the displacement is sure to show it.
WINDOW_CONTROLS = {"batch k+1 at step k": tuple(WINDOW_REL),
                   "lr frozen at its first value": ("displacement",)}
# The kernel that each wrapper of the windowed paths launches exactly
# once a call on its bf16 route, by its name in a device trace:
# attn_fwd.cu's core that writes the probabilities, attn_bwd.cu's dq pass,
# the wgmma products with the EPI_BIAS_GELU (4) and EPI_GELU_BWD (5)
# epilogues, which only mlp_fwd.cu and mlp_bwd.cu instantiate, and the
# standalone attention's tensor-core forward and dq pass. A graph replay
# calls no wrapper, so ops._build.LAUNCHES cannot count its launches: the
# replayed window's trace counts them by these names.
TRACE_MARKS = {"attn_fwd": r"[\s:]attn_core_tc<true>\(",
               "attn_bwd": r"[\s:]attn_bwd_dq_tc\(",
               "mlp_fwd": r"[\s:]wgmma_gemm_kernel<4,",
               "mlp_bwd": r"[\s:]wgmma_gemm_kernel<5,",
               "attend_fwd": r"[\s:]attend_fwd_tc[<(]",
               "attend_bwd": r"[\s:]attend_bwd_dq_tc[<(]"}

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def setup_vocab() -> str:
    from mvlpt_torch.tokenizer import write_synthetic_vocab

    path = os.environ.get("MVLPT_TORCH_BPE_PATH", "")
    if path and os.path.isfile(path):
        return f"vocab: real at {path}"
    path = str(ROOT / "build" / "mvlpt_torch_vocab" / "synthetic_bpe_vocab.txt.gz")
    write_synthetic_vocab(path, seed=0)
    os.environ["MVLPT_TORCH_BPE_PATH"] = path
    return f"vocab: synthetic at {path}"


def cuda_times(fn, reps: int = REPS) -> tuple[float, float, float]:
    """(median, min, max) ms of ``reps`` runs of fn, each between its own
    pair of CUDA events. A sleep kernel holds the card while the host
    enqueues every run, so each pair reads the card's time for that run
    alone, not the host's launch gaps."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    # Cycles at about 1.5 GHz: longer than the host takes to enqueue them all.
    torch.cuda._sleep(int(min(1.5 * reps * warm_s, 5.0) * 1.5e9))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sorted(start.elapsed_time(end) for start, end in events)
    return ms[len(ms) // 2], ms[0], ms[-1]


def cuda_ms(fn) -> float:
    return cuda_times(fn)[0]


def timed(kern, plain, lib=None) -> dict:
    """A check row's times: the kernel's median and spread [min, max], the
    plain twin's and the library call's medians (None without one)."""
    med, lo, hi = cuda_times(kern)
    return dict(ms=med, ms_spread=[lo, hi], plain_ms=cuda_ms(plain),
                library_ms=None if lib is None else cuda_ms(lib))


def layer_params(w: int, dtype, gen):
    """One block's params at CLIP's init scale, with non-trivial LN and biases."""
    import torch

    from mvlpt_torch.core.clip import init_block_stack
    from mvlpt_torch.core.layers import layer_params as take
    from mvlpt_torch.utils.tree import tree_map

    p = take(init_block_stack(gen, 1, w), 0)
    for ln in ("ln_1", "ln_2"):
        p[ln]["scale"] = 1 + 0.1 * torch.randn(w, generator=gen)
        p[ln]["bias"] = 0.02 * torch.randn(w, generator=gen)
    for grp, key in (("attn", "qkv_b"), ("attn", "out_b"), ("mlp", "fc_b"), ("mlp", "proj_b")):
        p[grp][key] = 0.02 * torch.randn(p[grp][key].shape, generator=gen)
    return tree_map(lambda t: t.to("cuda", dtype).contiguous(), p)


def bound(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _verdict_one(dtype_name: str, out, ref, ref64) -> dict:
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol_old = TOL[dtype_name] * scale
    ok_old = math.isfinite(err) and err <= tol_old
    row = dict(max_abs_err=err, max_abs_ref=scale,
               differ_share=(out != ref).float().mean().item())
    if dtype_name != "bfloat16":
        return dict(row, tol=tol_old, ok=ok_old)
    err64 = (out.double() - ref64.double()).abs().max().item()
    twin64 = (ref.double() - ref64.double()).abs().max().item()
    scale64 = ref64.double().abs().max().item()
    tol = max(TWIN_FACTOR * twin64, TOL[dtype_name] * scale64)
    return dict(row, max_abs_err64=err64, twin_err64=twin64, max_abs_ref64=scale64, tol=tol,
                ok=math.isfinite(err64) and math.isfinite(tol) and err64 <= tol,
                tol_old=tol_old, ok_old=ok_old,
                differ_share64=(out != ref64.to(out.dtype)).float().mean().item())


def verdict(dtype_name: str, outs, refs, refs64=None, names=None) -> dict:
    """A check row's numbers and verdict (the rule at TOL): the outputs
    ``outs`` (a tensor or a tuple of them) against the twin's ``refs``
    and, in bf16, the fp64-summed twin's ``refs64``. max_abs_err and
    differ_share are against ref; in bf16 also max_abs_err64 and
    differ_share64 against ref64, twin_err64 = max|ref - ref64|, the
    rule's tol, and the old bound as tol_old and ok_old. With several
    outputs: the numbers of the one furthest past its tol, ``ok`` and
    ``ok_old`` only if every output's is; with their ``names`` also each
    output's error, tol and verdict (by_output) and the name of the one
    reported (worst_output)."""
    import torch

    if isinstance(outs, torch.Tensor):
        outs, refs, refs64 = (outs,), (refs,), (refs64,)
    refs64 = refs64 if refs64 is not None else (None,) * len(outs)
    rows = [_verdict_one(dtype_name, o, r, r64) for o, r, r64 in zip(outs, refs, refs64)]
    key = "max_abs_err64" if dtype_name == "bfloat16" else "max_abs_err"

    def past(r):
        ratio = r[key] / max(r["tol"], 1e-30)
        return ratio if math.isfinite(ratio) else math.inf

    worst = max(range(len(rows)), key=lambda i: past(rows[i]))
    out = dict(rows[worst], ok=all(r["ok"] for r in rows))
    if "ok_old" in out:
        out["ok_old"] = all(r["ok_old"] for r in rows)
    if names is not None:
        out["worst_output"] = names[worst]
        out["by_output"] = {n: {k: r[k] for k in (key, "tol", "ok", "differ_share")}
                            for n, r in zip(names, rows)}
    return out


# The attention forwards' outputs in train mode, each held to the rule:
# y (or the part's fp32 partial) and the residuals the backward reads.
ATTN_FWD_OUTPUTS = ("y", "qkv", "probs", "mu", "rstd")


def _with_residuals(result):
    """(y, (qkv, probs, mu, rstd)) -> (y, qkv, probs, mu, rstd)."""
    y, res = result
    return (y, *res)


def check_kernels(shapes: dict) -> list[dict]:
    """Every half-block kernel and mode against its plain twin (in bf16
    also the fp64-summed twin); returns result rows."""
    import torch

    from mvlpt_torch.ops import block

    rows = []
    # shapes[tower] = (B, S, W, H, mask, seg, n_seq, modes): n_seq sequences
    # of seg tokens hold data (images; or classes packed G to a row);
    # ``modes`` are the kernel modes checked at that shape (a mode for
    # every kernel, or a (kernel, mode) pair).
    for (tower, dtype_name), (b, s, w, h, mask, seg, n_seq, modes) in (
            ((t, d), shapes[t]) for t in shapes for d in ("bfloat16", "float32")):
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator().manual_seed(7)
        p = layer_params(w, dtype, gen)
        x = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        gy = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        esz = torch.finfo(dtype).bits // 8
        m, d, w4 = b * s, w // h, 4 * w
        do = torch.randn((b, h, s, d), generator=gen).to("cuda", dtype)
        ln1, ln2, at, ml = p["ln_1"], p["ln_2"], p["attn"], p["mlp"]
        attn_args = (x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"],
                     at["out_b"], mask, h)
        mlp_args = (x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"],
                    ml["proj_b"])
        _, (qkv, probs, mu, rstd) = block.attn_fwd_plain(*attn_args)
        _, (hpre, mu2, rstd2) = block.mlp_fwd_plain(*mlp_args)
        attn_bwd_args = (x, mu, rstd, qkv, probs, ln1["scale"], at["qkv_w"], at["out_w"], gy, h)
        mlp_bwd_args = (x, mu2, rstd2, hpre, ln2["scale"], ml["fc_w"], ml["proj_w"], gy)

        sdpa, sdpa_bwd = sdpa_library(qkv, mask, h, do)

        # Bytes: each input read once, each output written once. Operations:
        # what this run's data needs; for the packed text rows only the real
        # classes' tokens and the causal part of each class's own block.
        # Each case's twin takes the dtype of its sums (acc).
        f32 = torch.float32
        n_tok = n_seq * seg
        core = 4 * h * d * n_seq * (seg * seg if mask is None else seg * (seg + 1) // 2)
        gemm_attn, gemm_mlp = 2 * n_tok * w * 4 * w, 4 * n_tok * w * w4
        act, stats = m * w * esz, 8 * m                  # a (B, S, W) tensor; mu + rstd
        probs_b = b * h * s * s * esz
        mask_b = 0 if mask is None else s * s * 4
        attn_w = (4 * w * w + 6 * w) * esz               # LN, qkv and out weights and biases
        mlp_w = (2 * w * w4 + w4 + 3 * w) * esz          # LN, fc and proj weights and biases
        cases = [
            ("attn_fwd", "train", lambda: _with_residuals(block.attn_fwd(*attn_args)),
             lambda acc=f32: _with_residuals(block.attn_fwd_plain(*attn_args, acc=acc)),
             gemm_attn + core,
             act + attn_w + mask_b + act + 3 * act + probs_b + stats, sdpa),
            ("attn_fwd", "no-residual",
             lambda: block.attn_fwd(*attn_args, save_residuals=False)[0],
             lambda acc=f32: block.attn_fwd_plain(*attn_args, save_residuals=False, acc=acc)[0],
             gemm_attn + core, act + attn_w + mask_b + act, sdpa),
            ("attn_bwd", "train", lambda: block.attn_bwd(*attn_bwd_args),
             lambda acc=f32: block.attn_bwd_plain(*attn_bwd_args, acc=acc), gemm_attn + 2 * core,
             act + stats + 3 * act + probs_b + (4 * w * w + w) * esz + act + act, sdpa_bwd),
            ("mlp_fwd", "train", lambda: block.mlp_fwd(*mlp_args)[0],
             lambda acc=f32: block.mlp_fwd_plain(*mlp_args, acc=acc)[0], gemm_mlp,
             act + mlp_w + act + m * w4 * esz + stats, None),
            ("mlp_fwd", "no-residual",
             lambda: block.mlp_fwd(*mlp_args, save_residuals=False)[0],
             lambda acc=f32: block.mlp_fwd_plain(*mlp_args, save_residuals=False, acc=acc)[0],
             gemm_mlp, act + mlp_w + act, None),
            ("mlp_bwd", "train", lambda: block.mlp_bwd(*mlp_bwd_args),
             lambda acc=f32: block.mlp_bwd_plain(*mlp_bwd_args, acc=acc), gemm_mlp,
             act + stats + m * w4 * esz + (2 * w * w4 + w) * esz + act + act, None),
        ]
        gemm_lib = {"attn_fwd": attn_gemm_library(*attn_args[:5], at["out_w"], mask, h),
                    "attn_bwd": attn_bwd_gemm_library(qkv, probs, at["qkv_w"], at["out_w"], gy,
                                                      h),
                    "mlp_fwd": mlp_gemm_library(*mlp_args[:6]),
                    "mlp_bwd": mlp_bwd_gemm_library(hpre, ml["fc_w"], ml["proj_w"], gy)}
        for name, mode, kern, twin, flops, nbytes, lib in (
                c for c in cases if c[1] in modes or (c[0], c[1]) in modes):
            got, alloc = requested(kern)
            ref64 = twin(torch.float64) if dtype == torch.bfloat16 else None
            bound_ms, bound_by = bound(flops, nbytes, dtype_name)
            outputs = ATTN_FWD_OUTPUTS if (name, mode) == ("attn_fwd", "train") else None
            row = dict(name=name, mode=mode, tower=tower, dtype=dtype_name,
                       shape=[b, s, w, h], masked=mask is not None,
                       **verdict(dtype_name, got, twin(), ref64, outputs),
                       **timed(kern, twin, lib), bound_ms=bound_ms, bound_by=bound_by)
            if name in gemm_lib:
                # The bf16 route's wrappers request their outputs and scratch,
                # nothing more: attn_fwd y, qkv (a residual, or scratch
                # without residuals), probs, mu and rstd, and its xh and o;
                # attn_bwd dx, its do and dqkv, the fp32 dxh and the core's
                # (B, H, S) fp32 t, no (B, H, S, S) tensor; mlp_fwd its xh
                # and act, mlp_bwd its dh and fp32 dxh.
                train = mode == "train"
                if name == "attn_fwd":
                    want = act + m * 3 * w * esz + (probs_b + stats if train else 0) + 2 * act
                elif name == "attn_bwd":
                    want = act + act + m * 3 * w * esz + m * w * 4 + b * h * s * 4
                elif name == "mlp_fwd":
                    want = act + (m * w4 * esz + stats if train else 0) + act + m * w4 * esz
                else:
                    want = act + m * w4 * esz + m * w * 4
                routes = {"attn_fwd": block.ATTN_FWD_ROUTES,
                          "attn_bwd": block.ATTN_BWD_ROUTES}.get(name, block.MLP_ROUTES)
                row.update(route=routes[dtype], gemm_library_ms=cuda_ms(gemm_lib[name]),
                           requested_bytes=alloc, want_bytes=want)
                if dtype == torch.bfloat16 and alloc != want:
                    raise AssertionError(f"{name} ({mode}, {tower}, bf16): requested {alloc} "
                                         f"bytes, not those of its outputs and scratch ({want})")
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)
    return _fail_on_disagreement(rows)


def requested(fn):
    """fn()'s result and the bytes it asked the caching allocator for at
    its peak. Its block counts (memory_allocated) would add whatever a
    cached free block holds beyond the request when it is reused unsplit."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    got = fn()
    torch.cuda.synchronize()
    return got, torch.cuda.memory_stats()["requested_bytes.all.peak"] - before


def sdpa_library(qkv, mask, n_heads, do):
    """The attention core's library calls on the twin's qkv (B, S, 3Wl)
    over ``n_heads`` heads: scaled_dot_product_attention forward, and its
    forward and backward by autograd against ``do`` (B, H, S, D). The
    yardsticks of the attention half-blocks' cores (library_ms), which the
    port never calls."""
    import torch
    import torch.nn.functional as F

    b, s, wl3 = qkv.shape
    q, k, v = qkv.view(b, s, 3, n_heads, wl3 // 3 // n_heads).permute(2, 0, 3, 1, 4)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa_mask = mask.to(qkv.dtype) if mask is not None else None

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask)
        return torch.autograd.grad(o, (qg, kg, vg), do)

    return fwd, fwd_bwd


def attn_gemm_library(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, mask, n_heads):
    """A yardstick for the attention half-block forwards' two products
    alone, as mlp_gemm_library is the MLP's: cuBLAS (torch.matmul) in x's
    dtype, xh W_qkv and o W_out on the twin's xh and o (over qkv_w's
    heads), with no LayerNorm, core or epilogue."""
    import torch

    from mvlpt_torch.ops import block

    xh = block._ln2d(x.float(), ln_scale.float(), ln_bias.float(), 1e-5)[0].to(x.dtype)
    o = block._attn_core_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, mask, n_heads, 1e-5)[0]
    w, wl = x.shape[-1], out_w.shape[0]
    return lambda: (torch.matmul(xh.view(-1, w), qkv_w), torch.matmul(o.view(-1, wl), out_w))


def attn_bwd_gemm_library(qkv, probs, qkv_w, out_w, gy, n_heads):
    """The attention backwards' yardstick for their two products alone, as
    mlp_bwd_gemm_library is the MLP's: cuBLAS (torch.matmul) in gy's
    dtype, gy W_out^T and dqkv W_qkv^T on the twin's dqkv (over qkv's
    ``n_heads`` heads), with no attention core or LayerNorm backward."""
    import torch

    from mvlpt_torch.ops import block

    dqkv = block._attn_dqkv_plain(qkv, probs, out_w, gy, n_heads)
    gy2, dqkv2 = gy.reshape(-1, gy.shape[-1]), dqkv.reshape(-1, dqkv.shape[-1])
    return lambda: (torch.matmul(gy2, out_w.t()), torch.matmul(dqkv2, qkv_w.t()))


def mlp_gemm_library(x, ln_scale, ln_bias, fc_w, fc_b, proj_w):
    """A yardstick for the MLP forwards' two products alone, not the same
    function (no LayerNorm, epilogues or rounding between): cuBLAS
    (torch.matmul) in x's dtype on the twin's xh and act, which the port
    never calls. Returns the callable that gemm_library_ms times."""
    import torch

    from mvlpt_torch.ops import block

    xh = block._ln2d(x.float(), ln_scale.float(), ln_bias.float(), 1e-5)[0].to(x.dtype)
    act = block._mlp_hidden_plain(x, ln_scale, ln_bias, fc_w, fc_b, 1e-5)[0]
    w, w4 = fc_w.shape
    return lambda: (torch.matmul(xh.view(-1, w), fc_w), torch.matmul(act.view(-1, w4), proj_w))


def mlp_bwd_gemm_library(hpre, fc_w, proj_w, gy):
    """The MLP backward's yardstick, as mlp_gemm_library is the forward's:
    cuBLAS's two products in gy's dtype, gy W_proj^T and dh W_fc^T on the
    twin's dh, with no epilogue or LayerNorm backward."""
    import torch

    from mvlpt_torch.ops import block

    w, w4 = fc_w.shape
    gy2 = gy.reshape(-1, w)
    dh = block._gelu_bwd_plain(block._mm(gy2, proj_w.t()), hpre.reshape(-1, w4))
    return lambda: (torch.matmul(gy2, proj_w.t()), torch.matmul(dh, fc_w.t()))


def _compared(dtype_name: str, out, ref, ref64) -> dict:
    """out against ``ref`` (#1-#4, say) under the rule, as numbers to
    print: the row's verdict is taken against the plain twin."""
    r = verdict(dtype_name, out, ref, ref64)
    return {k: r[k] for k in ("max_abs_err", "max_abs_err64", "twin_err64", "tol", "ok",
                              "differ_share") if k in r}


def _fail_on_disagreement(rows: list[dict]) -> list[dict]:
    """Raise if any row fails the rule (``ok``; ``ok_old`` stops nothing)."""
    bad = [f"{r['name']} ({r['mode']}, {r['tower']}, {r['dtype']}): max|err"
           f"{'64' if 'max_abs_err64' in r else ''}| "
           f"{r.get('max_abs_err64', r['max_abs_err'])} > {r['tol']}" for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("kernels disagree with their plain twins: " + "; ".join(bad))
    return rows


def check_tp_kernels(shapes: dict) -> list[dict]:
    """The tensor-parallel parts (#7-#10) against their plain twins on
    rank 0's shard at tp = TP; then the TP shards' partials summed in fp32
    and finished (bias, rounding, residual; or the LayerNorm backward)
    against the plain twin on the full weights (ref; in bf16 ref64 is the
    fp64-summed twin), with the single-device kernels #1-#4 beside it as a
    printed second comparison (vs_kernels). Returns result rows."""
    import torch

    from mvlpt_torch.ops import block
    from mvlpt_torch.parallel import shard_blocks

    rows, joined = [], []
    # shapes[tower] = (B, S, W, H, mask, seg, n_seq, names): as check_kernels',
    # with the part kernels checked at that shape.
    for (tower, dtype_name), (b, s, w, h, mask, seg, n_seq, names) in (
            ((t, d), shapes[t]) for t in shapes for d in ("bfloat16", "float32")):
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator().manual_seed(13)
        p = layer_params(w, dtype, gen)
        x = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        gy = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        esz = torch.finfo(dtype).bits // 8
        m, d, hl, wl, w4l = b * s, w // h, h // TP, w // TP, 4 * w // TP
        do = torch.randn((b, hl, s, d), generator=gen).to("cuda", dtype)
        ln1, ln2 = p["ln_1"], p["ln_2"]
        shards = [shard_blocks(p, h, TP, r) for r in range(TP)]

        def attn_args(r):
            at = shards[r]["attn"]
            return (x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"], mask, hl)

        def mlp_args(r):
            ml = shards[r]["mlp"]
            return (x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"])

        fwd_res = [block.attn_fwd_part_plain(*attn_args(r))[1] for r in range(TP)]
        mlp_res = [block.mlp_fwd_part_plain(*mlp_args(r))[1] for r in range(TP)]

        def attn_bwd_args(r):
            at = shards[r]["attn"]
            return (fwd_res[r][0], fwd_res[r][1], at["qkv_w"], at["out_w"], gy, hl)

        def mlp_bwd_args(r):
            ml = shards[r]["mlp"]
            return (mlp_res[r][0], ml["fc_w"], ml["proj_w"], gy)

        # Bytes: each input read once, each output written once, on rank
        # 0's shard. Operations: what this run's data needs (see
        # check_kernels).
        n_tok = n_seq * seg
        core = 4 * hl * d * n_seq * (seg * seg if mask is None else seg * (seg + 1) // 2)
        gemm_attn, gemm_mlp = 2 * n_tok * w * 4 * wl, 4 * n_tok * w * w4l
        act, part, stats = m * w * esz, m * w * 4, 8 * m  # (B, S, W); fp32 partial; mu + rstd
        probs_b, qkv_b = b * hl * s * s * esz, m * 3 * wl * esz
        mask_b = 0 if mask is None else s * s * 4
        attn_w, mlp_w = 4 * w * wl * esz, 2 * w * w4l * esz
        f32, bf16 = torch.float32, dtype == torch.bfloat16
        # SDPA on rank 0's local heads: the cores' library calls.
        sdpa, sdpa_bwd = sdpa_library(fwd_res[0][0], mask, hl, do)
        cases = [
            ("attn_fwd_tp", lambda: _with_residuals(block.attn_fwd_part(*attn_args(0))),
             lambda acc=f32: _with_residuals(block.attn_fwd_part_plain(*attn_args(0), acc=acc)),
             gemm_attn + core,
             act + attn_w + (3 * wl + 2 * w) * esz + mask_b + part + qkv_b + probs_b + stats,
             sdpa),
            ("attn_bwd_tp", lambda: block.attn_bwd_part(*attn_bwd_args(0)),
             lambda acc=f32: block.attn_bwd_part_plain(*attn_bwd_args(0), acc=acc),
             gemm_attn + 2 * core, qkv_b + probs_b + attn_w + act + part, sdpa_bwd),
            ("mlp_fwd_tp", lambda: block.mlp_fwd_part(*mlp_args(0))[0],
             lambda acc=f32: block.mlp_fwd_part_plain(*mlp_args(0), acc=acc)[0], gemm_mlp,
             act + mlp_w + (w4l + 2 * w) * esz + part + m * w4l * esz + stats, None),
            ("mlp_bwd_tp", lambda: block.mlp_bwd_part(*mlp_bwd_args(0)),
             lambda acc=f32: block.mlp_bwd_part_plain(*mlp_bwd_args(0), acc=acc), gemm_mlp,
             m * w4l * esz + mlp_w + act + part, None),
        ]
        for name, kern, twin, flops, nbytes, lib in (c for c in cases if c[0] in names):
            got, alloc = requested(kern)
            bound_ms, bound_by = bound(flops, nbytes, dtype_name)
            row = dict(name=name, mode="part", tower=tower, dtype=dtype_name,
                       shape=[b, s, w, hl if "attn" in name else w4l], tp=TP,
                       masked=mask is not None,
                       **verdict(dtype_name, got, twin(), twin(torch.float64) if bf16 else None,
                                 ATTN_FWD_OUTPUTS if name == "attn_fwd_tp" else None),
                       **timed(kern, twin, lib), bound_ms=bound_ms, bound_by=bound_by)
            if name == "attn_fwd_tp":
                # The bf16 route requests the fp32 partial, the residuals
                # (qkv, probs, mu, rstd) and the xh and o scratch.
                want = part + qkv_b + probs_b + stats + act + m * wl * esz
                row.update(route=block.ATTN_FWD_ROUTES[dtype],
                           gemm_library_ms=cuda_ms(attn_gemm_library(
                               *attn_args(0)[:5], shards[0]["attn"]["out_w"], mask, hl)),
                           requested_bytes=alloc, want_bytes=want)
                if bf16 and alloc != want:
                    raise AssertionError(f"attn_fwd_tp ({tower}, bf16): requested {alloc} bytes, "
                                         f"not those of its outputs and scratch ({want})")
            if name == "attn_bwd_tp":
                # The bf16 route requests the fp32 partial, the do and dqkv
                # scratch and the core's (B, H, S) fp32 t.
                want = part + m * wl * esz + qkv_b + b * hl * s * 4
                row.update(route=block.ATTN_BWD_ROUTES[dtype],
                           gemm_library_ms=cuda_ms(attn_bwd_gemm_library(
                               *attn_bwd_args(0)[:2], shards[0]["attn"]["qkv_w"],
                               shards[0]["attn"]["out_w"], gy, hl)),
                           requested_bytes=alloc, want_bytes=want)
                if bf16 and alloc != want:
                    raise AssertionError(f"attn_bwd_tp ({tower}, bf16): requested {alloc} bytes, "
                                         f"not those of its output and scratch ({want})")
            if name == "mlp_fwd_tp":
                row.update(route=block.MLP_ROUTES[dtype],
                           gemm_library_ms=cuda_ms(mlp_gemm_library(*mlp_args(0))))
            if name == "mlp_bwd_tp":
                # The bf16 route requests the fp32 partial and the dh scratch.
                want = part + m * w4l * esz
                row.update(route=block.MLP_ROUTES[dtype],
                           gemm_library_ms=cuda_ms(mlp_bwd_gemm_library(*mlp_bwd_args(0))),
                           requested_bytes=alloc, want_bytes=want)
                if bf16 and alloc != want:
                    raise AssertionError(f"mlp_bwd_tp ({tower}, bf16): requested {alloc} bytes, "
                                         f"not those of its output and scratch ({want})")
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)

        # The TP shards' kernels, summed and finished, against the twin on
        # the full weights (ref) and, in bf16, the fp64-summed twin (ref64);
        # the backwards' twins take #1's and #3's residuals. #1-#4 on the
        # full weights are printed beside them and decide nothing.
        at, ml = p["attn"], p["mlp"]
        full_attn = (x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"],
                     at["out_b"], mask, h)
        full_mlp = (x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"],
                    ml["proj_b"])
        f64 = torch.float64
        pairs = []
        if "attn_fwd_tp" in names:
            y_attn, (qkv, probs, mu, rstd) = block.attn_fwd(*full_attn)
            fa = [block.attn_fwd_part(*attn_args(r)) for r in range(TP)]
            parts = [res for _, res in fa]
            pairs.append(("attn_fwd_tp",
                          x + (sum(y for y, _ in fa) + at["out_b"].float()).to(dtype), y_attn,
                          lambda acc: block.attn_fwd_plain(*full_attn, acc=acc)[0]))
        if "attn_bwd_tp" in names:
            dxa = sum(block.attn_bwd_part(parts[r][0], parts[r][1], shards[r]["attn"]["qkv_w"],
                                          shards[r]["attn"]["out_w"], gy, hl) for r in range(TP))
            attn_bwd_full = (x, mu, rstd, qkv, probs, ln1["scale"], at["qkv_w"], at["out_w"],
                             gy, h)
            pairs.append(("attn_bwd_tp",
                          block._ln_bwd(x, parts[0][2], parts[0][3], ln1["scale"], dxa, gy),
                          block.attn_bwd(*attn_bwd_full),
                          lambda acc: block.attn_bwd_plain(*attn_bwd_full, acc=acc)))
        if "mlp_fwd_tp" in names:
            y_mlp, (hpre, mu2, rstd2) = block.mlp_fwd(*full_mlp)
            fm = [block.mlp_fwd_part(*mlp_args(r)) for r in range(TP)]
            mparts = [res for _, res in fm]
            pairs.append(("mlp_fwd_tp",
                          x + (sum(y for y, _ in fm) + ml["proj_b"].float()).to(dtype), y_mlp,
                          lambda acc: block.mlp_fwd_plain(*full_mlp, acc=acc)[0]))
        if "mlp_bwd_tp" in names:
            dxm = sum(block.mlp_bwd_part(mparts[r][0], shards[r]["mlp"]["fc_w"],
                                         shards[r]["mlp"]["proj_w"], gy) for r in range(TP))
            mlp_bwd_full = (x, mu2, rstd2, hpre, ln2["scale"], ml["fc_w"], ml["proj_w"], gy)
            pairs.append(("mlp_bwd_tp",
                          block._ln_bwd(x, mparts[0][1], mparts[0][2], ln2["scale"], dxm, gy),
                          block.mlp_bwd(*mlp_bwd_full),
                          lambda acc: block.mlp_bwd_plain(*mlp_bwd_full, acc=acc)))
        for name, got, kernels, twin in pairs:
            ref64 = twin(f64) if bf16 else None
            row = dict(name=name, mode="reassembled", tower=tower, dtype=dtype_name, tp=TP,
                       ref="the plain twin on the full weights",
                       **verdict(dtype_name, got, twin(f32), ref64),
                       vs_kernels=_compared(dtype_name, got, kernels, ref64))
            joined.append(row)
            print("tp-reassembly " + json.dumps(row), flush=True)
    _fail_on_disagreement(joined)
    return _fail_on_disagreement(rows)


def check_attend(shapes: dict) -> list[dict]:
    """The standalone attention, forward and backward, against its plain
    twins; returns result rows, each with the route its dtype and S took
    (``attention.route_of``). ``shapes[name] = (N, S, D, mask, dtypes,
    kernels)``, N = batch x heads. In bf16 each wrapper must request from
    the allocator its outputs and its route's scratch and nothing more: on
    the tensor cores the backward's (3, N, S) row statistics and no
    (N, S, S) tensor; past the buckets, on the CUDA cores, the backward's
    two (N, S, S) bf16 tensors."""
    import torch
    import torch.nn.functional as F

    from mvlpt_torch.ops import attention

    rows = []
    for (path, dtype_name), (n, s, d, mask, _, names) in (
            ((p, t), shapes[p]) for p in shapes for t in shapes[p][4]):
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator().manual_seed(11)
        q, k, v, do = (torch.randn((n, s, d), generator=gen).to("cuda", dtype) for _ in range(4))
        sdpa_mask = None if mask is None else mask.to(dtype)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

        # The library on (1, N, S, D): its fused backends take 4-D inputs.
        def lib_fwd():
            return F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=sdpa_mask)

        def lib_bwd():  # forward and backward through autograd
            o = F.scaled_dot_product_attention(qg[None], kg[None], vg[None], attn_mask=sdpa_mask)
            return torch.autograd.grad(o, (qg, kg, vg), do[None])

        # Bytes: each input read once, each output written once. Operations:
        # the (query, key) pairs the mask leaves, for the score and value
        # products (and, backward, the recomputed scores, dv, dp, dq, dk).
        pairs = s * s if mask is None else int((mask > torch.finfo(torch.float32).min / 2).sum())
        esz = torch.finfo(dtype).bits // 8
        rows_b = n * s * d * esz  # one (N, S, D) tensor
        mask_b = 0 if mask is None else s * s * 4
        f32 = torch.float32
        cases = [
            ("attend_fwd", lambda: (attention.attend_fwd(q, k, v, mask),),
             lambda acc=f32: (attention.attend_fwd_plain(q, k, v, mask, acc=acc),),
             4 * n * d * pairs, 4 * rows_b + mask_b, lib_fwd),
            ("attend_bwd", lambda: attention.attend_bwd(q, k, v, mask, do),
             lambda acc=f32: attention.attend_bwd_plain(q, k, v, mask, do, acc=acc),
             10 * n * d * pairs, 7 * rows_b + mask_b, lib_bwd),
        ]
        for name, kern, twin, flops, nbytes, lib in (c for c in cases if c[0] in names):
            got, alloc = requested(kern)
            ref64 = twin(torch.float64) if dtype == torch.bfloat16 else None
            agree = verdict(dtype_name, got, twin(), ref64)
            bound_ms, bound_by = bound(flops, nbytes, dtype_name)
            # The outputs and the backward's scratch of the route taken.
            route = attention.route_of(name, dtype, s)
            want = len(got) * rows_b
            if name == "attend_bwd":
                want += 3 * n * s * 4 if route == "mma" else 2 * n * s * s * esz
            row = dict(name=name, mode="core", tower=path, dtype=dtype_name, shape=[n, s, d],
                       route=attention.ROUTES[route], masked=mask is not None, **agree,
                       requested_bytes=alloc, **timed(kern, twin, lib), bound_ms=bound_ms,
                       bound_by=bound_by)
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16 and alloc != want:
                raise AssertionError(f"{name} ({path}, bf16): requested {alloc} bytes, not "
                                     f"those of its outputs and its route's scratch ({want})")
    return _fail_on_disagreement(rows)


# The epilogues of the backwards' K-major GEMM (csrc/common.cuh
# Epilogue): the rounding one of the attention backward's do, the fp32 one
# of dxh, the QuickGELU' one of the MLP backward's da.
EPI_ROUND, EPI_F32, EPI_GELU_BWD = 0, 1, 5


def check_gemm_kmajor(shapes: dict) -> list[dict]:
    """The backwards' bf16 GEMM on its own (wgmma.cuh with B read K-major,
    through csrc/mlp_bwd.cu's mvlpt_gemm_kmajor), at #4's two products:
    da = gy W_proj^T through the QuickGELU' epilogue into dh (bf16), and
    dxh = dh W_fc^T through the fp32 one; and at #2's do = gy W_out^T
    through the rounding one (bf16; W_out (W, W) read K-major). Each
    against the twin's product (ops/block._mm, _gelu_bwd_plain) under the
    bf16 rule,
    in both tile widths and as the backward picks one, so the K-major
    layout is guarded apart from the half-block around it; timed beside
    torch.matmul (cuBLAS) of the same product, each tile width apart
    (``ms_by_tile``). The first row is also launched first from a new
    thread, as autograd's backward thread launches #4: it must give the
    main thread's result. ``shapes[name] = (M, W)``; returns result
    rows."""
    import threading

    import torch

    from mvlpt_torch.ops import _build, block

    rows = []
    bf, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    for tower, (m, w) in shapes.items():
        gen = torch.Generator().manual_seed(19)
        w4 = 4 * w
        gy = torch.randn((m, w), generator=gen).to("cuda", bf)
        hpre = torch.randn((m, w4), generator=gen).to("cuda", bf)
        proj_w = (0.02 * torch.randn((w4, w), generator=gen)).to("cuda", bf)
        fc_w = (0.02 * torch.randn((w, w4), generator=gen)).to("cuda", bf)
        out_w = (0.02 * torch.randn((w, w), generator=gen)).to("cuda", bf)
        dh_in = block._gelu_bwd_plain(block._mm(gy, proj_w.t()), hpre)
        products = [
            ("da", EPI_GELU_BWD, gy, proj_w, hpre, bf, w4, w,
             lambda acc=f32: block._gelu_bwd_plain(block._mm(gy, proj_w.t(), acc), hpre, acc),
             lambda: torch.matmul(gy, proj_w.t())),
            ("dxh", EPI_F32, dh_in, fc_w, None, f32, w, w4,
             lambda acc=f32: block._mm(dh_in, fc_w.t(), acc),
             lambda: torch.matmul(dh_in, fc_w.t())),
            ("do", EPI_ROUND, gy, out_w, None, bf, w, w,
             lambda acc=f32: block._mm(gy, out_w.t(), acc).to(bf),
             lambda: torch.matmul(gy, out_w.t()))]
        for name, epi, a, b_t, aux, out_dtype, n, k, twin, lib in products:
            out = torch.empty((m, n), dtype=out_dtype, device="cuda")

            def kern(bn, epi=epi, a=a, b_t=b_t, aux=aux, out=out, n=n, k=k):
                _build.call("gemm_kmajor", epi, bn, a.data_ptr(), b_t.data_ptr(),
                            None if aux is None else aux.data_ptr(), out.data_ptr(), m, n, k,
                            torch.cuda.current_stream().cuda_stream)
                return out

            ref, ref64 = twin(), twin(f64)
            tiles = {bn: verdict("bfloat16", kern(bn).clone(), ref, ref64) for bn in (128, 256)}
            agree = verdict("bfloat16", kern(0).clone(), ref, ref64)
            aux_b = 0 if aux is None else m * n * 2
            bound_ms, bound_by = bound(2 * m * n * k, (m * k + n * k) * 2 + aux_b
                                       + m * n * out.element_size(), "bfloat16")
            row = dict(name="gemm_kmajor", mode=name, tower=tower, dtype="bfloat16",
                       shape=[m, n, k], epilogue=epi, **agree,
                       ok_by_tile={bn: t["ok"] for bn, t in tiles.items()},
                       **timed(lambda: kern(0), twin, lib),
                       ms_by_tile={bn: cuda_ms(lambda bn=bn: kern(bn)) for bn in (128, 256)},
                       bound_ms=bound_ms, bound_by=bound_by)
            row["ok"] = agree["ok"] and all(t["ok"] for t in tiles.values())
            if not rows:
                want, got, err = kern(0).clone(), [], []

                def first_launch():
                    try:
                        got.append(kern(0).clone())
                    except Exception as e:  # re-raised below, on the main thread
                        err.append(e)

                t = threading.Thread(target=first_launch)
                t.start()
                t.join()
                if err or not torch.equal(got[0], want):
                    raise AssertionError(f"gemm_kmajor: a new thread's first launch failed or "
                                         f"differs from the main thread's: {err}")
                row["new_thread"] = "equal"
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)
    return _fail_on_disagreement(rows)


# The tensor-core kernels of each source, by their mangled names: the
# bf16 route of attend_fwd.cu / attend_bwd.cu (one kernel a register
# bucket NT), the wgmma GEMM in attn_fwd.cu, attn_bwd.cu, mlp_fwd.cu and
# mlp_bwd.cu (one an epilogue EPI, tile width BN and B layout, KMAJOR 1 for
# a B read transposed), attn_fwd.cu's mma.sync core (PROBS 1 where it
# writes the probabilities) and attn_bwd.cu's two mma.sync core launches.
# Each pattern of a source must name at least one kernel.
TC_KERNELS = {"attend_fwd": (r"attend_fwd_tc",), "attend_bwd": (r"attend_bwd_(?:dq|dkv)_tc",),
              "attn_fwd": (r"attn_core_tc", r"wgmma_gemm_kernel"),
              "attn_bwd": (r"attn_bwd_(?:dq|dkv)_tc", r"wgmma_gemm_kernel"),
              "mlp_fwd": (r"wgmma_gemm_kernel",), "mlp_bwd": (r"wgmma_gemm_kernel",)}
# The template arguments of each tensor-core kernel, in order (none for a
# plain function).
TC_TEMPLATE_ARGS = {"attend_fwd_tc": ("NT",), "attend_bwd_dq_tc": ("NT",),
                    "attend_bwd_dkv_tc": ("NT",), "attn_core_tc": ("PROBS",),
                    "attn_bwd_dq_tc": (), "attn_bwd_dkv_tc": (),
                    "wgmma_gemm_kernel": ("EPI", "BN", "KMAJOR")}
# Sources whose bf16 products must reach wgmma (HGMMA in their SASS), and
# whose bf16 attention core must reach mma.sync (HMMA).
HGMMA_SOURCES = ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd")
HMMA_SOURCES = ("attn_fwd", "attn_bwd")
# setmaxnreg's split in csrc/wgmma.cuh needs the 168 registers a thread
# that a block of 384 threads holds at entry; with fewer, the consumers'
# request could never be met.
WGMMA_ENTRY_REGS = 168


def tc_ptxas(log: str, pattern: str) -> list[tuple[str, int, int]]:
    """(kernel<template arguments>, registers, bytes of spills) of each
    kernel whose mangled name matches ``pattern`` in one source's ptxas
    -v log, read per kernel because the fp32 routes share the sources."""
    rows = []
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        kernel = re.search(pattern, mangled)
        if kernel is None:
            continue
        args = re.search(r"I((?:L[ib]\d+E)+)E", mangled)
        values = re.findall(r"L[ib](\d+)E", args.group(1)) if args else []
        names = TC_TEMPLATE_ARGS[kernel.group(0)]
        label = ",".join(f"{n}={v}" for n, v in zip(names, values)) or "?"
        regs = re.search(r"Used (\d+) registers", chunk)
        rows.append((f"{kernel.group(0)}<{label}>" if names else kernel.group(0),
                     int(regs.group(1)) if regs else -1,
                     sum(int(b) for b in re.findall(r"(\d+) bytes spill", chunk))))
    return rows


def check_tc_spills(logs: dict) -> None:
    """ptxas's registers and spills of each tensor-core kernel
    (TC_KERNELS), printed; any spill fails the run, and so does a source
    whose build log (``_build.build_kernels``: this run's or the cached
    library's) names no kernel of one of its patterns, or a wgmma GEMM
    kernel holding fewer than WGMMA_ENTRY_REGS registers."""
    rows = []
    for src, patterns in TC_KERNELS.items():
        for pattern in patterns:
            found = tc_ptxas(logs[src], pattern)
            if not found:
                raise AssertionError(f"ptxas: no tensor-core kernel in {src}.cu's build log "
                                     f"matches {pattern}")
            rows += [(f"{src} {label}", regs, spill) for label, regs, spill in found]
    for label, regs, spill in rows:
        print(f"ptxas {label}: {regs} registers, {spill} bytes of spills", flush=True)
    spilled = [label for label, _, spill in rows if spill]
    if spilled:
        raise AssertionError(f"ptxas: tensor-core kernels spill: {spilled}")
    short = [label for label, regs, _ in rows
             if " wgmma" in label and regs < WGMMA_ENTRY_REGS]
    if short:
        raise AssertionError(f"ptxas: wgmma GEMM kernels below {WGMMA_ENTRY_REGS} registers "
                             f"at entry, which setmaxnreg's split needs: {short}")


def check_hgmma() -> None:
    """The SASS (the toolkit's cuobjdump) of each library in HGMMA_SOURCES
    must hold HGMMA, the instruction wgmma compiles to, and of each in
    HMMA_SOURCES HMMA, mma.sync's: their bf16 routes really reach the
    tensor cores through them."""
    from mvlpt_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for src in dict.fromkeys(HGMMA_SOURCES + HMMA_SOURCES):
        sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build._lib_path(src))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        for op, sources, what in (("HGMMA", HGMMA_SOURCES, "wgmma"),
                                  ("HMMA", HMMA_SOURCES, "mma.sync")):
            if src not in sources:
                continue
            count = len(re.findall(rf"\b{op}\.", sass))
            print(f"sass {src}: {count} {op} instructions", flush=True)
            if not count:
                raise AssertionError(f"sass: no {op} in {src}'s library: its bf16 route misses "
                                     f"{what}")


def _launches(path: str, kernels: tuple, per: int) -> dict:
    """The launch counts of the path just driven; each of ``kernels``
    must have launched ``per`` times, every other kernel never."""
    from mvlpt_torch.ops import _build

    return _launches_of(path, dict(_build.LAUNCHES), kernels, per)


def _launches_of(path: str, got: dict, kernels: tuple, per: int) -> dict:
    want = {name: (per if name in kernels else 0) for name in got}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, want {want}")
    return got


def _near(path: str, what: str, got: float, want: float) -> None:
    if not (math.isfinite(got) and abs(got - want) <= 1e-2 * abs(want)):
        raise AssertionError(f"{path}: {what} {got} vs plain path {want} (1e-2 relative)")


def _peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2 ** 30


def drive_train(selection: str, batches: list, loss_plain: float, ocfg, norm, name="train",
                **flagship_kw) -> dict:
    """The flagship train step under ``selection``, one step a batch
    (``flagship_kw``: another backbone and batch). With more than one
    step the first is a warm-up, left out of ms_per_step."""
    import torch

    from mvlpt_torch.flagship import flagship
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import init_train_state, make_train_step

    path = f"{name}[{selection}]"
    model, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels=selection,
                                                        **flagship_kw)
    state = init_train_state(pp, ocfg, 100)
    step = make_train_step(model, normalize=norm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, grad_norms, times = [], [], []
    for bt in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, backbone, consts, bt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        grad_norms.append(metrics["grad_norm"].item())
    layers = clip_cfg.vision_layers + clip_cfg.transformer_layers
    launches = _launches(path, TRAIN_KERNELS[selection], layers * len(batches))
    ms_step = 1e3 * sum(times[1:]) / len(times[1:]) if len(times) > 1 else None
    out = dict(path=path, losses=losses, loss_plain_first=loss_plain, grad_norms=grad_norms,
               launches=launches, ms_per_step=ms_step,
               img_per_s=len(batches[0]["label"]) * 1e3 / ms_step if ms_step else None,
               step_ms=[1e3 * t for t in times], peak_mem_gib=_peak_gib())
    print("main-path " + json.dumps(out), flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{path}: non-finite loss {losses}")
    _near(path, "first loss", losses[0], loss_plain)
    return out


def drive_eval(selection: str, model, backbone, pp, consts, batches: list, ce_plain, norm,
               name="eval"):
    """The cached-text eval under ``selection``: text features once, then
    the image tower per batch; each batch's logits against the full eval
    step's, the soft-CE against the plain path's. With more than one
    batch the first is a warm-up, left out of img_per_s."""
    import torch

    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import make_cached_text_eval, make_eval_step, soft_cross_entropy

    path = f"{name}[{selection}]"
    text_fn, eval_fn = make_cached_text_eval(model, normalize=norm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    text_features = text_fn(backbone, pp, consts)
    torch.cuda.synchronize()
    text_ms = 1e3 * (time.perf_counter() - t0)
    logits, times = [], []
    for bt in batches:
        t0 = time.perf_counter()
        logits.append(eval_fn(backbone, pp, text_features, bt))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    cfg = model.clip_cfg
    launches = _launches(path, EVAL_KERNELS.get(selection, ()), cfg.vision_layers * len(batches)
                         + cfg.transformer_layers)
    peak = _peak_gib()
    full_step = make_eval_step(model, normalize=norm)
    for i, bt in enumerate(batches):
        full = full_step(backbone, pp, consts, bt)
        if not torch.equal(full, logits[i]):
            diff = (full - logits[i]).abs().max().item()
            raise AssertionError(f"{path}: batch {i}: cached-text logits differ from the full "
                                 f"eval step's by {diff}")
    ce = soft_cross_entropy(torch.cat(logits), torch.cat([bt["label"] for bt in batches])).item()
    out = dict(path=path, launches=launches, text_ms=text_ms, batch_ms=[1e3 * t for t in times],
               img_per_s=(len(batches[0]["label"]) * len(times[1:]) / sum(times[1:])
                          if len(times) > 1 else None),
               soft_ce=ce, soft_ce_plain=ce_plain, peak_mem_gib=peak)
    print("main-path " + json.dumps(out), flush=True)
    if ce_plain is not None:
        _near(path, "soft-CE", ce, ce_plain)
    return out, ce


def drive_zeroshot(selection: str, backbone, clip_cfg, text_features, batches: list, ce_plain,
                   norm):
    """make_zs_infer under ``selection`` at batch EVAL_BATCH against the
    class text features."""
    import torch

    from mvlpt_torch.models.zsclip import make_zs_infer
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import soft_cross_entropy

    path = f"zeroshot[{selection}]"
    infer = make_zs_infer(clip_cfg, *norm, use_pallas=selection)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    logits, times = [], []
    for bt in batches:
        t0 = time.perf_counter()
        logits.append(infer(backbone, text_features, bt["image"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = _launches(path, EVAL_KERNELS.get(selection, ()),
                         clip_cfg.vision_layers * len(batches))
    ce = soft_cross_entropy(torch.cat(logits), torch.cat([bt["label"] for bt in batches])).item()
    out = dict(path=path, launches=launches, batch_ms=[1e3 * t for t in times],
               img_per_s=EVAL_BATCH * len(times[1:]) / sum(times[1:]), soft_ce=ce,
               soft_ce_plain=ce_plain, peak_mem_gib=_peak_gib())
    print("main-path " + json.dumps(out), flush=True)
    if not all(tuple(x.shape) == (EVAL_BATCH, text_features.shape[0]) for x in logits):
        raise AssertionError(f"{path}: logits of shape {tuple(logits[0].shape)}")
    if ce_plain is not None:
        _near(path, "soft-CE", ce, ce_plain)
    return out, ce


def _tp_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of train[tp2], in its own spawned process: the flagship on
    a (data=1, model=world) mesh over the one card. First layer 0 of each
    tower, forward and dx, on its shard and the parent's inputs; then
    TP_STEPS SGD steps under 'block' on the parent's batches. Writes
    rank{rank}.json (losses, grad norms, step times, launches, peak
    memory) and rank{rank}.pt (the blocks' y and dx, the prompt params
    after the steps), or rank{rank}.err with the traceback."""
    import traceback

    import torch
    import torch.distributed as dist

    work = Path(workdir)
    try:
        from mvlpt_torch.config import optim_config
        from mvlpt_torch.core.layers import layer_params as take
        from mvlpt_torch.core.layers import residual_block
        from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, flagship
        from mvlpt_torch.ops import _build
        from mvlpt_torch.parallel import create_mesh
        from mvlpt_torch.train import init_train_state, make_train_step
        from mvlpt_torch.utils.tree import tree_leaves

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # NCCL refuses two ranks on one device, so the ranks use gloo,
        # whose all_reduce takes CUDA tensors (through host memory); the
        # mesh's groups inherit it.
        dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                                world_size=world)
        mesh = create_mesh(1, world)
        inputs = torch.load(work / "inputs.pt", weights_only=True)
        batches = [{k: v.cuda() for k, v in bt.items()} for bt in inputs["batches"]]
        norm = (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
        blocks = {}

        def layer0(model, backbone, clip_cfg, dt):
            for tower, (x, gy, mask) in inputs["blocks"].items():
                heads = clip_cfg.vision_heads if tower == "visual" else clip_cfg.transformer_heads
                x = x.to("cuda", getattr(torch, dt)).requires_grad_(True)
                y = residual_block(x, take(backbone[tower]["blocks"], 0), heads,
                                   None if mask is None else mask.cuda(), model.kernels)
                (dx,) = torch.autograd.grad(y, x, gy.to("cuda", x.dtype))
                blocks[f"{tower}/{dt}"] = (y.detach().cpu(), dx.cpu())

        model, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels="block",
                                                            mesh=mesh)
        layer0(model, backbone, clip_cfg, "bfloat16")
        state = init_train_state(pp, optim_config(**OPTIM), 100)
        step = make_train_step(model, normalize=norm, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        losses, grad_norms, times = [], [], []
        for bt in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, backbone, consts, bt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].item())
            grad_norms.append(metrics["grad_norm"].item())
        launches, peak = dict(_build.LAUNCHES), _peak_gib()
        # After the path's counts, in fp32, where no bf16 rounding flips:
        # layer 0 again, and one step on the first batch, which holds the
        # path to fp32 'auto' tightly.
        model, backbone, pp, consts, _, _ = flagship(device="cuda", compute_dtype=torch.float32,
                                                     kernels="block", mesh=mesh)
        layer0(model, backbone, clip_cfg, "float32")
        _, m32 = make_train_step(model, normalize=norm, mesh=mesh)(
            init_train_state(pp, optim_config(**OPTIM), 100), backbone, consts, batches[0])
        (work / f"rank{rank}.json").write_text(json.dumps(dict(
            losses=losses, grad_norms=grad_norms, step_ms=[1e3 * t for t in times],
            launches=launches, peak_mem_gib=peak,
            fp32_first={"loss": m32["loss"].item(), "grad_norm": m32["grad_norm"].item()})))
        torch.save({"blocks": blocks,
                    "params": [t.detach().cpu() for t in tree_leaves(state.prompt_params)]},
                   work / f"rank{rank}.pt")
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def residual_block_twin(x, p, n_heads, mask, gy, acc):
    """y and dx of one residual block through the half-block twins
    (ops/block.py) with sums in ``acc``: the forward's residuals feed the
    backward, as the fused block's kernels #1-#4 do."""
    from mvlpt_torch.ops import block

    ln1, at, ln2, ml = p["ln_1"], p["attn"], p["ln_2"], p["mlp"]
    y1, (qkv, probs, mu, rstd) = block.attn_fwd_plain(
        x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"], at["out_b"], mask,
        n_heads, acc=acc)
    y, (hpre, mu2, rstd2) = block.mlp_fwd_plain(y1, ln2["scale"], ln2["bias"], ml["fc_w"],
                                                ml["fc_b"], ml["proj_w"], ml["proj_b"], acc=acc)
    g1 = block.mlp_bwd_plain(y1, mu2, rstd2, hpre, ln2["scale"], ml["fc_w"], ml["proj_w"], gy,
                             acc=acc)
    dx = block.attn_bwd_plain(x, mu, rstd, qkv, probs, ln1["scale"], at["qkv_w"], at["out_w"],
                              g1, n_heads, acc=acc)
    return y, dx


def _tp_block_check(path: str, backbones: dict, clip_cfg, inputs: dict, got: list) -> dict:
    """Each rank's sharded layer 0 of each tower (y and dx, through the
    all-reduce) against the block's plain twin on the full weights of
    ``backbones[dtype]`` (ref; in bf16 ref64 is its fp64-summed twin),
    under the rule at TOL, with kernels #1-#4 on the same weights beside
    it as a printed second comparison (vs_kernels); and bit-equal across
    the ranks."""
    import torch

    from mvlpt_torch.core.layers import layer_params as take
    from mvlpt_torch.ops.block import fused_residual_block

    out, rows = {}, []
    for dt, backbone in backbones.items():
        for tower, (x, gy, mask) in inputs.items():
            heads = clip_cfg.vision_heads if tower == "visual" else clip_cfg.transformer_heads
            key = f"{tower}/{dt}"
            p = take(backbone[tower]["blocks"], 0)
            mask = None if mask is None else mask.cuda()
            xr = x.to("cuda", getattr(torch, dt)).requires_grad_(True)
            gyr = gy.to("cuda", xr.dtype)
            y = fused_residual_block(xr, p, heads, mask)
            (dx,) = torch.autograd.grad(y, xr, gyr)
            kernels = (y.detach().cpu(), dx.cpu())
            refs = tuple(t.cpu() for t in residual_block_twin(xr.detach(), p, heads, mask, gyr,
                                                              torch.float32))
            refs64 = (None, None)
            if dt == "bfloat16":
                refs64 = tuple(t.cpu() for t in residual_block_twin(
                    xr.detach(), p, heads, mask, gyr, torch.float64))
            for k, name in enumerate(("y", "dx")):
                mine = got[0][key][k]
                row = dict(name=f"{path} layer 0 {name}", mode="rank 0", tower=tower, dtype=dt,
                           **verdict(dt, mine, refs[k], refs64[k]),
                           vs_kernels=_compared(dt, mine, kernels[k], refs64[k]))
                out[f"{key}/{name}"] = row
                rows.append(row)
                if not all(torch.equal(mine, g[key][k]) for g in got[1:]):
                    raise AssertionError(f"{path}: {key} layer 0 {name} differs across ranks")
    _fail_on_disagreement(rows)
    return out


def drive_tp_train(batches: list, blocks: dict, backbones: dict, clip_cfg, auto: dict,
                   auto32: dict) -> dict:
    """train[tp2]: TP spawned ranks share the card. The kernels are built
    already, so the ranks only load them; the batches and the block
    inputs go to them in one file under build/. Rank 0's first loss and
    grad norm are held to train[auto]'s on the same batch (``auto32``:
    its first step in fp32), the blocks to the plain twin on the full
    weights ``backbones[dtype]``."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    path = "train[tp2]"
    work = ROOT / "build" / "chip_smoke_tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.save({"batches": [{k: v.cpu() for k, v in bt.items()} for bt in batches],
                "blocks": blocks}, work / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_tp_rank, args=(r, TP, str(work))) for r in range(TP)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    try:
        for proc in procs:
            proc.join(max(1.0, TP_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    errs = {r: (work / f"rank{r}.err").read_text() for r in range(TP)
            if (work / f"rank{r}.err").is_file()}
    if hung or errs or any(proc.exitcode != 0 for proc in procs):
        raise AssertionError(f"{path}: ranks still running after {TP_TIMEOUT_S} s: {hung}; "
                             f"exit codes {[proc.exitcode for proc in procs]}; errors {errs}")
    wall_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(TP)]
    saved = [torch.load(work / f"rank{r}.pt", weights_only=True) for r in range(TP)]
    layers = clip_cfg.vision_layers + clip_cfg.transformer_layers  # a step, on each rank
    launches = [_launches_of(f"{path} rank {r}", ranks[r]["launches"], TP_KERNELS,
                             layers * len(batches)) for r in range(TP)]
    losses, grad_norms, fp32 = ranks[0]["losses"], ranks[0]["grad_norms"], ranks[0]["fp32_first"]
    ms_step = sum(ranks[0]["step_ms"][1:]) / len(ranks[0]["step_ms"][1:])
    out = dict(path=path, mesh={"data": 1, "model": TP}, losses=losses, grad_norms=grad_norms,
               loss_auto_first=auto["losses"][0], grad_norm_auto_first=auto["grad_norms"][0],
               loss_plain_first=auto["loss_plain_first"], fp32_first=fp32,
               fp32_auto_first=auto32, launches=launches[0],
               launches_by_rank=launches, ms_per_step=ms_step,
               img_per_s=len(batches[0]["label"]) * 1e3 / ms_step,
               step_ms=[x["step_ms"] for x in ranks],
               peak_mem_gib=max(x["peak_mem_gib"] for x in ranks),
               peak_mem_gib_by_rank=[x["peak_mem_gib"] for x in ranks], wall_s=wall_s,
               blocks=_tp_block_check(path, backbones, clip_cfg, blocks,
                                      [x["blocks"] for x in saved]))
    print("main-path " + json.dumps(out), flush=True)
    if not all(math.isfinite(v) for x in ranks for v in x["losses"]):
        raise AssertionError(f"{path}: non-finite loss {[x['losses'] for x in ranks]}")
    for dt, what, got, want in (
            ("bfloat16", "loss", losses[0], auto["losses"][0]),
            ("bfloat16", "grad_norm", grad_norms[0], auto["grad_norms"][0]),
            ("float32", "loss", fp32["loss"], auto32["loss"]),
            ("float32", "grad_norm", fp32["grad_norm"], auto32["grad_norm"])):
        if not (math.isfinite(got) and abs(got - want) <= TP_REL[dt][what] * abs(want)):
            raise AssertionError(f"{path}: rank 0's first {what} in {dt} {got} vs "
                                 f"train[auto]'s {want} ({TP_REL[dt][what]} relative)")
    for r in range(1, TP):
        if not all(torch.equal(a, b) for a, b in zip(saved[0]["params"], saved[r]["params"])):
            raise AssertionError(f"{path}: prompt params of rank {r} differ from rank 0's")
    return out


def _window_batches(k: int, seed: int, res: int) -> dict:
    """A staged window of k flagship batches made on the card: uint8
    (k, 32, res, res, 3) images and (k, 32) labels of 100 classes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"image": torch.randint(0, 256, (k, 32, res, res, 3), dtype=torch.uint8,
                                   device="cuda", generator=gen),
            "label": torch.randint(0, 100, (k, 32), device="cuda", generator=gen)}


def _traced(fn) -> tuple:
    """fn()'s result and the device kernels it ran, counted by their names
    in a torch.profiler trace (CUPTI records each kernel of a graph
    replay too)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    counts = collections.Counter()
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            counts[ev.key] += ev.count
    return out, counts


# A traced graph replay now and then loses a few kernel records (CUPTI
# drops them when its buffer fills). A replay whose trace marks fewer
# launches than it must is traced again from the same state, up to
# TRACE_TRIES times; a graph launches the same kernels on every replay, so
# a full count on any try is the graph's own. More than it must fails.
TRACE_TRIES = 3


def _traced_replay(fn, state, want: dict) -> tuple:
    """fn(), a replay of a captured window from ``state`` (a WindowState),
    under a trace: (its result, the trace's counts, the tries taken).
    While the trace marks (TRACE_MARKS) fewer launches of a kernel than
    ``want`` and of none more, ``state`` is restored and the replay traced
    again. The wrappers' counts are reset before each try."""
    from mvlpt_torch.ops import _build

    before = _state_copy(state)
    for tries in range(1, TRACE_TRIES + 1):
        _build.reset_launch_counts()
        out, counts = _traced(fn)
        marked = _marked(counts)
        short = any(marked[name] < want.get(name, 0) for name in marked)
        over = any(marked[name] > want.get(name, 0) for name in marked)
        if not short or over or tries == TRACE_TRIES:
            return out, counts, tries
        _restore(state, before)


def _repo_kernels(counts: dict) -> dict:
    """The counts of a trace's kernels that this repo's sources define (the
    __global__ functions under mvlpt_torch/csrc)."""
    names = set()
    for src in (ROOT / "mvlpt_torch" / "csrc").glob("*.cu*"):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                src.read_text()))
    ours = re.compile(r"[\s:](?:%s)[<(]" % "|".join(sorted(names)))
    return {key: n for key, n in counts.items() if ours.search(key)}


def _marked(counts: dict) -> dict:
    """Each TRACE_MARKS wrapper's launches in a trace's counts."""
    return {name: sum(n for key, n in counts.items() if re.search(mark, key))
            for name, mark in TRACE_MARKS.items()}


def _replayed_launches(path: str, counts: dict, kernels: tuple, per: int) -> dict:
    """The launches of a window replayed from its graph, counted in its
    trace by TRACE_MARKS: each of ``kernels`` ``per`` times, every other
    marked kernel never. The replay must have called no wrapper, else a
    step ran eagerly."""
    from mvlpt_torch.ops import _build

    called = {name: n for name, n in _build.LAUNCHES.items() if n}
    if called:
        raise AssertionError(f"{path}: the replayed window called the kernel wrappers {called}")
    return _launches_of(path, _marked(counts), kernels, per)


def _window_gaps(per_step: dict, metrics: list, init: list, leaves: list) -> dict:
    """The gaps of a window run from one make_train_step call a batch
    (``per_step``: its losses, grad norms and final prompt leaves), as
    WINDOW_REL reads them; ``init`` are the prompt leaves both started
    from."""
    import torch

    out = {}
    for name in ("loss", "grad_norm"):
        got = torch.cat([m[name] for m in metrics]).double().cpu()
        want = torch.tensor(per_step[name], dtype=torch.float64)
        out[name] = ((got - want).abs() / want.abs()).max().item()
    moved = [(p - p0).double() for p, p0 in zip(per_step["leaves"], init)]
    gap = max(((q - q0).double() - d).abs().max().item()
              for q, q0, d in zip(leaves, init, moved))
    out["displacement"] = gap / max(d.abs().max().item() for d in moved)
    return out


def _timed_window(step, state, backbone, consts, window) -> tuple[float, float, dict]:
    """(host ms, device ms, metrics) of one window: the host clock around
    the call, ending in torch.cuda.synchronize(); the card's time between
    two CUDA events around it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    _, metrics = step(state, backbone, consts, window)
    end.record()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), start.elapsed_time(end), metrics


def drive_window(selection: str, ocfg, norm, text_shape: tuple[int, int]) -> dict:
    """The windowed train step under ``selection`` on the flagship (ViT-B/16,
    batch 32, 100 classes, bf16, uint8 images, normalize, pre_embed).

    Check (train_window[sel]): WINDOW_CHECK_WINDOWS windows of
    WINDOW_CHECK_K steps from the same initial prompt three ways: (a) one
    make_train_step call a batch, (b) make_train_step_multi with
    capture=False, (c) make_train_step_multi replayed from its CUDA graph.
    (a) reads the window's pre-embedded tokens. (c) must equal (b) bit for
    bit (every loss, accuracy and grad norm, every prompt leaf after the
    windows), (b) equal (a) bit for bit (WINDOW_REL), every value be
    finite, and each broken window of WINDOW_CONTROLS,
    run as (b) is, lie outside the limits it names. The last window of
    (b) and of (c) runs under a device trace: (c)'s launches are counted
    there by TRACE_MARKS, with no wrapper called, and (c) must run the
    same kernels of the repo, each as many times, as (b), whose wrappers
    count its launches. One more replayed window, untraced, is timed.

    Timing (train_window_k120[auto], 'auto' only): one warm-up window of
    WINDOW_K steps, the capture included, then WINDOW_TIMED timed windows:
    ms/step on the host clock and on CUDA events, img/s, peak memory, and
    MFU as utils.flops.flagship_step_flops at this run's text shape (s, G)
    over ms/step, against the dense bf16 rate (PEAK_FLOPS); then the
    graph replays a window of its first WINDOW_CHECK_K batches under a
    device trace, which counts the path's launches."""
    import torch

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.flagship import flagship
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import (
        init_train_state, make_train_step, make_train_step_multi)
    from mvlpt_torch.train.train_step import WINDOW_METRICS
    from mvlpt_torch.utils import flops
    from mvlpt_torch.utils.tree import tree_leaves

    path, card = f"train_window[{selection}]", card_line()
    model, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels=selection)
    res, k = clip_cfg.image_resolution, WINDOW_CHECK_K
    layers = clip_cfg.vision_layers + clip_cfg.transformer_layers
    per_window = layers * k
    check_cfg = optim_config(**dict(OPTIM, MAX_EPOCH=WINDOW_CHECK_EPOCHS))
    windows = [_window_batches(k, 40 + i, res) for i in range(WINDOW_CHECK_WINDOWS)]
    init = [t.detach().clone() for t in tree_leaves(pp)]

    state = init_train_state(pp, check_cfg, WINDOW_CHECK_SPE)
    step_a = make_train_step(model, pre_embedded=True)
    per_step = {"loss": [], "grad_norm": []}
    for w in windows:
        with torch.no_grad():
            tokens = model.embed_image(backbone, w["image"].flatten(0, 1), normalize=norm)
        tokens = tokens.unflatten(0, w["image"].shape[:2])
        for i in range(k):
            state, m = step_a(state, backbone, consts, {"image": tokens[i],
                                                        "label": w["label"][i]})
            for name, values in per_step.items():
                values.append(m[name].item())
    per_step["leaves"] = [t.detach() for t in tree_leaves(state.prompt_params)]

    eager = make_train_step_multi(model, pre_embed=True, normalize=norm, capture=False)
    eager_state = init_train_state(pp, check_cfg, WINDOW_CHECK_SPE)
    eager_m = [eager(eager_state, backbone, consts, w)[1] for w in windows[:-1]]
    _build.reset_launch_counts()
    (_, m), eager_trace = _traced(lambda: eager(eager_state, backbone, consts, windows[-1]))
    eager_m.append(m)
    eager_calls = _launches(f"{path} eager", TRAIN_KERNELS[selection], per_window)
    marked = _marked(eager_trace)
    if any(marked[name] != eager_calls[name] for name in marked):
        raise AssertionError(f"{path}: the eager window's trace marks {marked}, its wrappers "
                             f"count {eager_calls}")
    controls = {}
    for name in WINDOW_CONTROLS:
        st = init_train_state(pp, check_cfg, WINDOW_CHECK_SPE)
        ws = windows
        if name.startswith("batch"):
            ws = [{n: t.roll(-1, 0) for n, t in w.items()} for w in windows]
        else:
            st.opt.lr_table.fill_(float(st.opt.lr_table[0, 0]))
        ms = [eager(st, backbone, consts, w)[1] for w in ws]
        controls[name] = _window_gaps(per_step, ms, init, tree_leaves(st.prompt_params))

    graph_state = init_train_state(pp, check_cfg, WINDOW_CHECK_SPE)
    replayed = make_train_step_multi(model, pre_embed=True, normalize=norm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = [_timed_window(replayed, graph_state, backbone, consts, w) for w in windows[:-1]]
    graph_m = [t[2] for t in timed]
    (_, m), trace, trace_tries = _traced_replay(
        lambda: replayed(graph_state, backbone, consts, windows[-1]), graph_state,
        {name: per_window for name in TRAIN_KERNELS[selection]})
    graph_m.append(m)
    launches = _replayed_launches(path, trace, TRAIN_KERNELS[selection], per_window)
    if replayed.captures != 1:
        raise AssertionError(f"{path}: {replayed.captures} captures, want 1")
    ours, ours_eager = _repo_kernels(trace), _repo_kernels(eager_trace)
    if ours != ours_eager:
        diff = {key: (ours.get(key, 0), ours_eager.get(key, 0))
                for key in set(ours) | set(ours_eager) if ours.get(key) != ours_eager.get(key)}
        raise AssertionError(f"{path}: the replayed window ran the repo's kernels other times "
                             f"than the eager window (replayed, eager): {diff}")
    for i, (mb, mc) in enumerate(zip(eager_m, graph_m)):
        for name in WINDOW_METRICS:
            if not torch.equal(mb[name], mc[name]):
                raise AssertionError(f"{path}: window {i}: the replayed {name} "
                                     f"{mc[name].tolist()} differs from the eager window's "
                                     f"{mb[name].tolist()}")
    for j, (pb, pc) in enumerate(zip(tree_leaves(eager_state.prompt_params),
                                     tree_leaves(graph_state.prompt_params))):
        if not torch.equal(pb, pc):
            raise AssertionError(f"{path}: prompt leaf {j} after the windows differs from the "
                                 f"eager window's by {(pb - pc).abs().max().item()}")
    values = torch.cat([m[name] for m in eager_m for name in WINDOW_METRICS])
    if not bool(torch.isfinite(values).all()):
        raise AssertionError(f"{path}: non-finite metrics {values.tolist()}")
    gaps = _window_gaps(per_step, eager_m, init, tree_leaves(eager_state.prompt_params))
    for what, limit in WINDOW_REL.items():
        if not gaps[what] <= limit:
            raise AssertionError(f"{path}: the eager window's {what} lies {gaps[what]} from one "
                                 f"step a call's, over {limit} relative (the first differing "
                                 f"step's losses: per step {per_step['loss']}, window "
                                 f"{torch.cat([m['loss'] for m in eager_m]).tolist()})")
    for name, caught_by in WINDOW_CONTROLS.items():
        passed = [what for what in caught_by if not controls[name][what] > WINDOW_REL[what]]
        if passed:
            raise AssertionError(f"{path}: a window with the {name} passes the {passed} limits "
                                 f"{controls[name]}: they cannot tell it from a sound one")
    peak = _peak_gib()
    host_ms, device_ms, _ = _timed_window(replayed, graph_state, backbone, consts, windows[0])
    out = {path: dict(
        path=path, card=card, k=k, windows=len(windows), steps_per_epoch=WINDOW_CHECK_SPE,
        captures=replayed.captures, replays=replayed.replays, launches=launches,
        launches_counted="the last check window, replayed, in its device trace",
        trace_tries=trace_tries,
        eager_wrapper_launches={n: c for n, c in eager_calls.items() if c},
        repo_kernels_per_step={key[:80]: n // k for key, n in sorted(ours.items())},
        losses_per_step=per_step["loss"], losses_eager_window=torch.cat(
            [m["loss"] for m in eager_m]).tolist(),
        grad_norms_per_step=per_step["grad_norm"], grad_norms_eager_window=torch.cat(
            [m["grad_norm"] for m in eager_m]).tolist(),
        acc_eager_window=torch.cat([m["acc"] for m in eager_m]).tolist(),
        gaps=gaps, limits=WINDOW_REL, control_gaps=controls, replay_equals_eager=True,
        capture_window_host_ms=timed[0][0], window_host_ms=host_ms, window_device_ms=device_ms,
        ms_per_step=host_ms / k, device_ms_per_step=device_ms / k,
        img_per_s=32 * k * 1e3 / host_ms, peak_mem_gib=peak)}
    print("main-path " + json.dumps(out[path]), flush=True)
    if selection != "auto":
        return out

    path = f"train_window_k{WINDOW_K}[{selection}]"
    window = _window_batches(WINDOW_K, 50, res)
    state = init_train_state(pp, ocfg, WINDOW_SPE)
    step = make_train_step_multi(model, pre_embed=True, normalize=norm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = [_timed_window(step, state, backbone, consts, window)
             for _ in range(1 + WINDOW_TIMED)]
    peak = _peak_gib()
    # A trace of a whole window of WINDOW_K steps (about 130,000 kernels)
    # loses records: the graph replays the first WINDOW_CHECK_K batches
    # under the trace instead.
    (_, m), trace, trace_tries = _traced_replay(
        lambda: step(state, backbone, consts, {name: t[:k] for name, t in window.items()}),
        state, {name: per_window for name in TRAIN_KERNELS[selection]})
    launches = _replayed_launches(path, trace, TRAIN_KERNELS[selection], per_window)
    values = torch.cat([x[name] for x in [t[2] for t in timed] + [m] for name in WINDOW_METRICS])
    if not bool(torch.isfinite(values).all()):
        raise AssertionError(f"{path}: non-finite metrics")
    s, g = text_shape
    step_flops = flops.flagship_step_flops(batch=32, n_cls=100, text_tokens_per_cls=s,
                                           text_pack_classes=g)
    host_ms = sum(t[0] for t in timed[1:]) / (WINDOW_TIMED * WINDOW_K)
    device_ms = sum(t[1] for t in timed[1:]) / (WINDOW_TIMED * WINDOW_K)
    peak_flops = PEAK_FLOPS["bfloat16"]
    out[path] = dict(
        path=path, card=card, k=WINDOW_K, steps_per_epoch=WINDOW_SPE, text_s=s, text_g=g,
        captures=step.captures, replays=step.replays, launches=launches, trace_tries=trace_tries,
        launches_counted=f"a window of its first {k} batches replayed through its graph, in "
                         "its device trace",
        warmup_window_host_ms=timed[0][0], window_host_ms=[t[0] for t in timed[1:]],
        window_device_ms=[t[1] for t in timed[1:]], ms_per_step=host_ms,
        device_ms_per_step=device_ms, img_per_s=32 * 1e3 / host_ms,
        flops_per_step=step_flops, peak_tflops=peak_flops / 1e12,
        mfu_host=step_flops / (host_ms * 1e-3) / peak_flops,
        mfu_device=step_flops / (device_ms * 1e-3) / peak_flops,
        first_losses=timed[0][2]["loss"][:4].tolist(), peak_mem_gib=peak)
    print("main-path " + json.dumps(out[path]), flush=True)
    return out


def drive_paths(tp_blocks: dict, text_shape: tuple[int, int]) -> dict:
    """Every path of the port under 'auto' and 'on', each against the
    plain path ('off') on the same seeded inputs, and the windowed train
    step under each against its eager self and the per-step path; then the
    tensor-parallel train step against 'auto'. ``tp_blocks[tower] = (B, S,
    mask)`` are the shapes of train[tp2]'s layer-0 checks; ``text_shape``
    is (s, G), the packed text tower's."""
    import numpy as np
    import torch

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, flagship
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.models.zsclip import IMAGENET_TEMPLATES_SELECT, encode_class_text_features
    from mvlpt_torch.ops import _build
    from mvlpt_torch.ops.attention import select_attn_fn
    from mvlpt_torch.train import init_train_state, make_train_step

    norm = (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
    plain, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels="off")
    res = clip_cfg.image_resolution
    rng = np.random.RandomState(0)

    def batches(n, size):
        return [{"image": torch.from_numpy(rng.randint(0, 256, (size, res, res, 3)).astype(
                     np.uint8)).cuda(),
                 "label": torch.from_numpy(rng.randint(0, 100, size)).cuda()} for _ in range(n)]

    train_batches, eval_batches = batches(STEPS, 32), batches(EVAL_BATCHES, EVAL_BATCH)
    ocfg = optim_config(**OPTIM)
    _, m_plain = make_train_step(plain, normalize=norm)(
        init_train_state(pp, ocfg, 100), backbone, consts, train_batches[0])
    loss_plain = m_plain["loss"].item()
    _, ce_eval_plain = drive_eval("off", plain, backbone, pp, consts, eval_batches, None, norm)

    _build.reset_launch_counts()
    classnames = [f"class number {i}" for i in range(100)]
    text_features = encode_class_text_features(backbone, clip_cfg, classnames,
                                               IMAGENET_TEMPLATES_SELECT)
    _launches("zeroshot class text", (), 0)
    if not (text_features.shape == (100, clip_cfg.embed_dim)
            and torch.isfinite(text_features).all()):
        raise AssertionError(f"class text features: {tuple(text_features.shape)}, not finite")
    _, ce_zs_plain = drive_zeroshot("off", backbone, clip_cfg, text_features, eval_batches, None,
                                    norm)

    out = {}
    for sel in ("auto", "on"):
        out[f"train[{sel}]"] = drive_train(sel, train_batches, loss_plain, ocfg, norm)
        out.update(drive_window(sel, ocfg, norm, text_shape))
        model = MVLPTModel(clip_cfg, plain.spec, kernels=select_attn_fn(sel),
                           compute_dtype=plain.compute_dtype)
        out[f"eval[{sel}]"] = drive_eval(sel, model, backbone, pp, consts, eval_batches,
                                         ce_eval_plain, norm)[0]
        out[f"zeroshot[{sel}]"] = drive_zeroshot(sel, backbone, clip_cfg, text_features,
                                                 eval_batches, ce_zs_plain, norm)[0]
    model32, backbone32, pp32, consts32, _, _ = flagship(
        device="cuda", compute_dtype=torch.float32, kernels="auto")
    _, m32 = make_train_step(model32, normalize=norm)(
        init_train_state(pp32, ocfg, 100), backbone32, consts32, train_batches[0])
    auto32 = {"loss": m32["loss"].item(), "grad_norm": m32["grad_norm"].item()}
    gen = torch.Generator().manual_seed(17)
    widths = {"visual": clip_cfg.vision_width, "text": clip_cfg.transformer_width}
    blocks = {tower: (torch.randn((b, s, widths[tower]), generator=gen).to(torch.bfloat16),
                      torch.randn((b, s, widths[tower]), generator=gen).to(torch.bfloat16),
                      None if mask is None else mask.cpu())
              for tower, (b, s, mask) in tp_blocks.items()}
    out["train[tp2]"] = drive_tp_train(train_batches[:TP_STEPS], blocks,
                                       {"bfloat16": backbone, "float32": backbone32}, clip_cfg,
                                       out["train[auto]"], auto32)
    out.update(drive_vitl336(norm))
    return out


def drive_vitl336(norm) -> dict:
    """ViT-L/14@336px (``VITL336``; its image tower has S = 581, past every
    tensor-core bucket of #11/#12): one train step under 'auto' and 'on',
    the first loss held to 'off''s (1e-2), and one cached-text eval batch
    under each, its soft-CE held the same way."""
    import numpy as np
    import torch

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.flagship import flagship
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.ops.attention import select_attn_fn
    from mvlpt_torch.train import init_train_state, make_train_step

    plain, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels="off", **VITL336)
    res, n = clip_cfg.image_resolution, VITL336["batch"]
    rng = np.random.RandomState(2)
    batch = [{"image": torch.from_numpy(rng.randint(0, 256, (n, res, res, 3)).astype(
                  np.uint8)).cuda(),
              "label": torch.from_numpy(rng.randint(0, 100, n)).cuda()}]
    ocfg = optim_config(**OPTIM)
    _, m_plain = make_train_step(plain, normalize=norm)(
        init_train_state(pp, ocfg, 100), backbone, consts, batch[0])
    loss_plain = m_plain["loss"].item()
    out = {}
    _, ce_plain = drive_eval("off", plain, backbone, pp, consts, batch, None, norm,
                             name="eval_vitl336")
    for sel in ("auto", "on"):
        out[f"train_vitl336[{sel}]"] = drive_train(sel, batch, loss_plain, ocfg, norm,
                                                   name="train_vitl336", **VITL336)
        model = MVLPTModel(clip_cfg, plain.spec, kernels=select_attn_fn(sel),
                           compute_dtype=plain.compute_dtype)
        out[f"eval_vitl336[{sel}]"] = drive_eval(sel, model, backbone, pp, consts, batch,
                                                 ce_plain, norm, name="eval_vitl336")[0]
    return out



# The trainer_cli phase: the port's CLI (mvlpt_torch.cli.train) on a
# CoOp split-json dataset the phase writes under build/ (CLI_CLASSES
# classes; CLI_SHOTS train, CLI_VAL val and CLI_TEST test images a
# class, CLI_IMAGE_SIZE square JPEGs, so random_resized_crop resizes),
# with the flagship's UPT settings at full width.
CLI_CLASSES, CLI_SHOTS, CLI_VAL, CLI_TEST = 100, 16, 2, 4
CLI_IMAGE_SIZE = 256
CLI_OPTS = ["TRAINER.MVLPT.COOP.N_CTX", "4", "TRAINER.MVLPT.VPT.N_CTX", "4",
            "TRAINER.MVLPT.PROJECT_DIM", "128", "TRAINER.MVLPT.COOP.CLASS_TOKEN_POSITION",
            "middle", "DATALOADER.TRAIN_X.BATCH_SIZE", "32", "DATALOADER.TEST.BATCH_SIZE", "100",
            "TRAIN.STEPS_PER_DISPATCH", "20", "TEST.FINAL_MODEL", "best_val"]


def _write_class_jpeg(path: Path, rng, label: int) -> None:
    """A CLI_IMAGE_SIZE square JPEG at ``path``: smooth noise drawn from
    ``rng`` plus a colour of class ``label``."""
    import numpy as np
    from PIL import Image

    n = CLI_IMAGE_SIZE
    coarse = rng.randint(0, 100, (n // 16, n // 16, 3)).astype(np.uint8)
    img = Image.fromarray(coarse).resize((n, n), Image.BILINEAR)
    colour = np.array([(label * 97) % 156, (label * 57) % 156, (label * 37) % 156])
    arr = np.asarray(img, dtype=np.int64) + colour
    Image.fromarray(arr.astype(np.uint8)).save(path, quality=90)


def _fresh_data(root: Path, sizes: dict) -> bool:
    """Whether ``root`` holds data written at ``sizes`` (its marker says
    so); when it does not, ``root`` is removed, to be written anew (the
    readers' caches with it)."""
    import shutil

    marker = root / "written.json"
    if marker.exists() and json.loads(marker.read_text()).get("sizes") == sizes:
        return True
    shutil.rmtree(root, ignore_errors=True)
    return False


def _mark_written(root: Path, sizes: dict) -> None:
    """The marker ``_fresh_data`` reads: ``root``'s data is written at
    ``sizes``."""
    (root / "written.json").write_text(json.dumps({"sizes": sizes}))


def write_cli_dataset(root: Path) -> Path:
    """A CoOp dataset in OxfordPets' split-json layout under ``root``:
    smooth seeded noise plus a class colour, as JPEGs. A marker holds the
    sizes it was written with; data of other sizes is written anew."""
    import numpy as np

    ddir = root / "oxford_pets"
    split_path = ddir / "split_zhou_OxfordPets.json"
    sizes = {"classes": CLI_CLASSES, "shots": CLI_SHOTS, "val": CLI_VAL, "test": CLI_TEST,
             "image_size": CLI_IMAGE_SIZE}
    if _fresh_data(root, sizes):
        return root
    (ddir / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    split = {"train": [], "val": [], "test": []}
    for label in range(CLI_CLASSES):
        cname = f"class_number_{label}"
        for part, count in (("train", CLI_SHOTS), ("val", CLI_VAL), ("test", CLI_TEST)):
            for i in range(count):
                rel = f"{cname}_{part}_{i}.jpg"
                _write_class_jpeg(ddir / "images" / rel, rng, label)
                split[part].append([rel, label, cname])
    split_path.write_text(json.dumps(split))
    _mark_written(root, sizes)
    return root


class _WindowProbe:
    """Stands in for ``make_train_step_multi`` in the trainer module for one
    CLI run: makes the windowed step as it does, keeps each step made,
    records the metrics of each window, and with ``keep_first`` keeps a
    copy, on the card, of the first window's staged batches (``first``)."""

    def __init__(self, make, keep_first: bool = False):
        self.make, self.steps, self.windows = make, [], []
        self.keep_first, self.first = keep_first, None

    def __call__(self, *args, **kw):
        step = self.make(*args, **kw)
        self.steps.append(step)

        def call(*a, **k):
            if self.keep_first and self.first is None:
                self.first = {name: t.clone() for name, t in a[3].items()}
            state, metrics = step(*a, **k)
            self.windows.append(metrics)
            return state, metrics
        return call


def _cli_run(argv: list, keep_first: bool = False):
    """(trainer, window probe) of one in-process run of the port's CLI."""
    from mvlpt_torch.train import trainer as trainer_mod

    probe = _WindowProbe(trainer_mod.make_train_step_multi, keep_first)
    return _cli_probed(argv, probe), probe


def _test_logits(trainer):
    """The test split's logits of a trainer's current prompt (the
    cached-text eval, as its test() runs it; CoCoOp both towers a batch)."""
    import torch

    from mvlpt_torch.utils.pipeline import pipelined_inference

    if trainer._eval_text_fn is not None:
        trainer._eval_text = trainer._eval_text_fn(
            trainer.backbone, trainer.state.prompt_params, trainer.consts)
    try:
        return torch.cat([torch.from_numpy(logits[:batch["n_valid"]]) for logits, batch in
                          pipelined_inference(trainer.test_loader, trainer.model_inference)])
    finally:
        trainer._eval_text = None


def drive_trainer_cli() -> dict:
    """The port's training CLI end to end (trainer_cli): ``main(build_parser()
    .parse_args([...]))`` in-process on a random-init ViT-B/16
    (MVLPT_TPU_RANDOM_CLIP) with the synthetic vocab, --trainer MVLPT
    --dataset-coop on the dataset of ``write_cli_dataset``,
    configs/trainers/MVLPT/vit_b16_tpu_fast.yaml (uint8 staging with the
    normalisation folded on the card, pre-embedded windows) with CLI_OPTS,
    two epochs of 50 batches: windows of 20 and 20 and a tail of 10 (at
    least TRAIN.WINDOW_MIN_TAIL, so one window served by the first
    capture), best-val selection, the final test. Asserts one capture
    over both epochs; #1-#6 launched (the wrappers count the first
    window's eager warm-up step and its capture, and test()'s no-grad
    forwards); model-best.pth.tar and model.pth.tar-2 written; a results
    line in log.txt that parses; an --eval-only --model-dir rerun with
    bit-equal test logits and the same accuracy; the first window's
    step-0 loss within 1e-2 of an 'off' run's (one epoch, TEST.NO_TEST).
    Prints each epoch's wall time, training img/s on the host clock with
    the loading, the shares of the epoch spent waiting on the loader and
    staging batches on the card (the batches go through
    ``prefetch_to_device``), test() img/s and peak memory, beside the
    card's name and power limit and PR 15's figures; records the first
    window's digest and step-0 loss for ``drive_trainer_cli_native``."""
    import PIL
    import torch

    from mvlpt_torch.ops import _build

    path, card = "trainer_cli", card_line()
    data = write_cli_dataset(ROOT / "build" / "trainer_cli_data")
    out_dir = ROOT / "build" / "trainer_cli_out"
    common = ["--root", str(data), "--trainer", "MVLPT", "--dataset-coop",
              "--dataset", "OxfordPets", "--shots", str(CLI_SHOTS), "--seed", "1",
              "--cut-contextlen",
              "--config-file", str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml")]
    print(f"{path}: decoder PIL {PIL.__version__} (JPEG decode, bicubic resample)", flush=True)
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    os.environ.pop("MVLPT_TPU_RANDOM_CLIP_ARCH", None)
    os.environ.pop("MVLPT_TPU_CLIP_CKPT", None)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        trainer, probe = _cli_run([*common, "--output-dir", str(out_dir / "train"), *CLI_OPTS,
                                   "OPTIM.MAX_EPOCH", "2"], keep_first=True)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak = _peak_gib()
        logits = _test_logits(trainer)
        # the CLI's --eval-only rerun from the trained run's directory
        evaluated, _ = _cli_run([*common, "--output-dir", str(out_dir / "eval"), "--eval-only",
                                 "--model-dir", str(out_dir / "train"), *CLI_OPTS])
        logits_again = _test_logits(evaluated)
        _build.reset_launch_counts()
        plain, plain_probe = _cli_run([*common, "--output-dir", str(out_dir / "off"), *CLI_OPTS,
                                       "OPTIM.MAX_EPOCH", "1", "TEST.NO_TEST", "True",
                                       "TPU.USE_PALLAS", "off"])
    finally:
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)

    steps = [s for s in probe.steps]
    if len(steps) != 1 or steps[0].captures != 1:
        raise AssertionError(f"{path}: {[s.captures for s in steps]} captures of "
                             f"{len(steps)} windowed steps, want one step with 1 capture")
    sizes = [int(m["loss"].shape[0]) for m in probe.windows]
    if sizes != [20, 20, 10] * 2:
        raise AssertionError(f"{path}: windows of {sizes}, want [20, 20, 10] an epoch")
    want = ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd", "attn_fwd_infer", "mlp_fwd_infer")
    missing = [name for name in want if not launches.get(name)]
    others = {name: n for name, n in launches.items() if n and name not in want}
    if missing or others:
        raise AssertionError(f"{path}: launches {launches}: {missing} not launched, "
                             f"{others} launched")
    for name in ("model-best.pth.tar", "model.pth.tar-2"):
        if not (out_dir / "train" / "prompt_learner" / name).is_file():
            raise AssertionError(f"{path}: no prompt_learner/{name}")
    results = _results_of(out_dir / "train" / "log.txt")
    if not results or "accuracy" not in results[-1]:
        raise AssertionError(f"{path}: no results line with an accuracy in log.txt")
    eval_results = _results_of(out_dir / "eval" / "log.txt")
    if not torch.equal(logits, logits_again) or eval_results[-1] != results[-1]:
        raise AssertionError(f"{path}: the --eval-only rerun's test logits differ by "
                             f"{(logits - logits_again).abs().max().item()} (results "
                             f"{eval_results[-1]} against {results[-1]})")
    if not (logits.shape == (CLI_CLASSES * CLI_TEST, CLI_CLASSES)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{path}: test logits {tuple(logits.shape)}, or not finite")
    loss0 = probe.windows[0]["loss"][0].item()
    loss0_plain = plain_probe.windows[0]["loss"][0].item()
    _near(path, "first window's step-0 loss", loss0, loss0_plain)
    if plain.train_step_multi is None or plain_probe.steps[0].captures != 1:
        raise AssertionError(f"{path}: the 'off' run did not run its windows from a graph")

    out = dict(path=path, card=card, decoder=f"PIL {PIL.__version__}", run_s=run_s,
               windows=sizes, captures=steps[0].captures, replays=steps[0].replays,
               launches={k: v for k, v in launches.items() if v}, **_cli_timings(trainer),
               results=results[-1], first_losses=probe.windows[0]["loss"][:4].tolist(),
               first_loss=loss0, first_loss_off=loss0_plain, peak_mem_gib=peak,
               first_window_sha256=_window_digest(probe.first))
    _print_cli_timings(path, card, out)
    print("main-path " + json.dumps(out), flush=True)
    return out


# PR 15's trainer_cli on the same card, its range over the final proof's
# and the earlier runs' epochs (PERF.md §5-6): the loader-wait share and
# the training img/s with the loading, for comparison in this run's lines.
PR15_TRAINER_CLI = {"loader_wait_share": (0.566, 0.691), "img_per_s": (525.1, 715.7)}


def _cli_timings(trainer) -> dict:
    """A CLI run's epochs and test() passes from ``trainer.timings``: each
    epoch's wall, img/s with the loading, the share of its wall waiting on
    the loader for host batches and the share staging them on the card
    (pinned copies, waits for a pinned buffer); test() img/s."""
    epochs, tests = trainer.timings["epochs"], trainer.timings["tests"]
    return dict(
        epoch_wall_s=[e["wall_s"] for e in epochs],
        train_img_per_s=[e["images"] / e["wall_s"] for e in epochs],
        loader_wait_share=[e["loader_s"] / e["wall_s"] for e in epochs],
        staging_share=[e["stage_s"] / e["wall_s"] for e in epochs],
        test_img_per_s={f"{t['split']}{i}": t["images"] / t["wall_s"]
                        for i, t in enumerate(tests)},
        test_wall_s=[t["wall_s"] for t in tests],
        img_per_s=sum(e["images"] for e in epochs) / sum(e["wall_s"] for e in epochs))


def _print_cli_timings(path: str, card: str, out: dict) -> None:
    share, rate = PR15_TRAINER_CLI["loader_wait_share"], PR15_TRAINER_CLI["img_per_s"]
    print(f"{path} [{card}]: epochs of {', '.join(f'{s:.2f}' for s in out['epoch_wall_s'])} s, "
          f"{', '.join(f'{r:.1f}' for r in out['train_img_per_s'])} img/s with the loading, "
          f"loader wait {', '.join(f'{100 * s:.1f}%' for s in out['loader_wait_share'])}, "
          f"staging {', '.join(f'{100 * s:.2f}%' for s in out['staging_share'])} of each epoch "
          f"(PR 15's trainer_cli: loader wait {100 * share[0]:.1f}-{100 * share[1]:.1f}%, "
          f"{rate[0]}-{rate[1]} img/s); test() "
          f"{', '.join(f'{k} {v:.1f}' for k, v in out['test_img_per_s'].items())} img/s",
          flush=True)


def _window_digest(batches: dict) -> str:
    """sha256 over a staged window's images and labels, as the host reads
    them."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name in ("image", "label"):
        t = batches[name].cpu().contiguous()
        h.update(f"{name} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def drive_trainer_cli_native(cli: dict) -> dict:
    """trainer_cli's data, flags and cuts on DATALOADER.BACKEND "native"
    (trainer_cli_native), one epoch and the final test: the C++ core
    built from the checkout's sources and loaded (its toolchain printed:
    g++, the route, the libjpeg and libpng it resolves), every image of
    the dataset on the core's fast path (``native.probe``), the loaders'
    transforms the native ones, the first window's staged uint8 images
    and labels the same digest as ``cli``'s (trainer_cli's) and its step-0
    loss equal bit for bit, and the tokenizer's native BPE core live.
    Prints the epoch's wall, img/s with the loading, loader-wait and
    staging shares and test() img/s, beside trainer_cli's."""
    import torch

    from mvlpt_torch import native
    from mvlpt_torch.data.native_transform import NativeEvalTransform, NativeTrainTransform
    from mvlpt_torch.data.zipio import read_bytes
    from mvlpt_torch.ops import _build
    from mvlpt_torch.tokenizer import get_tokenizer

    path, card = "trainer_cli_native", card_line()
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"{path}: the native core did not build: {native.error()}")
    tool = native.toolchain()
    build_s = time.perf_counter() - t0
    print(f"{path} toolchain: {tool['compiler']}; route {tool['route']}; linked "
          f"{'; '.join(tool['linked'])}; {tool['library']} ({build_s:.1f} s to build or load)",
          flush=True)
    if not tool["linked"] or len(tool["linked"]) < 2:
        raise AssertionError(f"{path}: the core resolves no libjpeg/libpng: {tool}")
    tok = get_tokenizer()
    if tok._native is None:
        raise AssertionError(f"{path}: the tokenizer's native BPE is off: {tok.native_error}")
    data = write_cli_dataset(ROOT / "build" / "trainer_cli_data")
    images = sorted((data / "oxford_pets" / "images").glob("*.jpg"))
    off_path = [p.name for p in images if native.probe(read_bytes(str(p))) is None]
    if len(images) != CLI_CLASSES * (CLI_SHOTS + CLI_VAL + CLI_TEST) or off_path:
        raise AssertionError(f"{path}: {len(off_path)} of {len(images)} images off the fast "
                             f"path: {off_path[:5]}")
    common = ["--root", str(data), "--trainer", "MVLPT", "--dataset-coop",
              "--dataset", "OxfordPets", "--shots", str(CLI_SHOTS), "--seed", "1",
              "--cut-contextlen",
              "--config-file", str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml")]
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        trainer, probe = _cli_run([*common, "--output-dir", str(ROOT / "build" / path),
                                   *CLI_OPTS, "OPTIM.MAX_EPOCH", "1", "DATALOADER.BACKEND",
                                   "native"], keep_first=True)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    finally:
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)
    if set(launches) != set(cli["launches"]):
        raise AssertionError(f"{path}: launches {launches}, trainer_cli's {cli['launches']}")
    transforms = {name: type(getattr(trainer, name).dataset.transform).__name__
                  for name in ("train_loader_x", "val_loader", "test_loader")}
    if not (isinstance(trainer.train_loader_x.dataset.transform, NativeTrainTransform) and
            isinstance(trainer.test_loader.dataset.transform, NativeEvalTransform)):
        raise AssertionError(f"{path}: the loaders run {transforms}, not the native core")
    digest = _window_digest(probe.first)
    loss0 = probe.windows[0]["loss"][0].item()
    if digest != cli["first_window_sha256"] or loss0 != cli["first_loss"]:
        raise AssertionError(f"{path}: the first window's digest {digest} and step-0 loss "
                             f"{loss0!r} against trainer_cli's {cli['first_window_sha256']} and "
                             f"{cli['first_loss']!r}")
    out = dict(path=path, card=card, run_s=run_s, launches=launches, toolchain=tool,
               native_bpe=True,
               transforms=transforms, images_on_fast_path=len(images),
               first_window_sha256=digest, first_loss=loss0, **_cli_timings(trainer),
               peak_mem_gib=_peak_gib())
    _print_cli_timings(path, card, out)
    print(f"{path}: the first window's staged images and labels (sha256 {digest[:16]}) and "
          f"step-0 loss {loss0!r} equal trainer_cli's; every one of {len(images)} images on "
          f"the core's fast path; the tokenizer's native BPE live; transforms {transforms}; "
          f"trainer_cli's epochs {', '.join(f'{r:.1f}' for r in cli['train_img_per_s'])} img/s "
          f"with the loading, loader wait "
          f"{', '.join(f'{100 * s:.1f}%' for s in cli['loader_wait_share'])}", flush=True)
    print("main-path " + json.dumps(out), flush=True)
    return out

# The ELEVATER phases (trainer_elevater, trainer_elevater_transfer,
# zeroshot_cli): the 20 tasks of scripts/mvlpt/main_mt_elevater_cut.sh in
# the local manifest layout under build/ (``write_elevater_dataset``), with
# their real class names from metadata.json (1151 classes); ELEV_SHOTS
# train and ELEV_TEST test images a class (cut from the script's 20 shots
# and the tasks' test sets), CLI_IMAGE_SIZE square JPEGs, ELEV_EPOCHS
# epochs (cut from the yaml's 200). The script's own flags: UPT with
# NCTX 16 on both sides, 'middle', --cut-contextlen, --act-ckpt 4,
# best_val.
ELEV_SHOTS, ELEV_TEST, ELEV_EPOCHS = 2, 1, 2
ELEV_CTX = 16  # the script's NCTX: CoOp and VPT context tokens
ELEV_OPTS = ["TRAINER.MVLPT.COOP.N_CTX", str(ELEV_CTX), "TRAINER.MVLPT.VPT.N_CTX", str(ELEV_CTX),
             "TRAINER.MVLPT.COOP.CLASS_TOKEN_POSITION", "middle", "TEST.FINAL_MODEL", "best_val"]
# main_single_elevater_cut.sh's transfer task and the ZeroshotCLIP2 task.
ELEV_TRANSFER_TASK = "oxford-flower-102"
ELEV_ZS_TASK = "oxford-flower-102"
# Steps of the replayed window that is traced (a trace loses records past
# about 10^5 kernels).
ELEV_TRACE_K = 8


def elevater_classnames(tasks=None) -> list:
    """The class names of ``tasks`` (the 20 by default) in the multitask
    manager's global order."""
    from mvlpt_torch.data.elevater import ELEVATER_20_TASKS, class_map, first_classname

    return [first_classname(c) for t in tasks or ELEVATER_20_TASKS for c in class_map(t)]


def elevater_text_shape(tasks=None, n_ctx: int = ELEV_CTX) -> tuple[int, int, int]:
    """(s, G, rows) of the text tower over ``tasks``' classes (the 20 by
    default) at CoOp ctx ``n_ctx`` with the vocab in use."""
    from mvlpt_torch.core.text import packing
    from mvlpt_torch.prompts import compute_cut_context_length

    names = elevater_classnames(tasks)
    s = compute_cut_context_length(names, n_ctx)
    g, rows = packing(len(names), s)
    return s, g, rows


def elevater_image_tokens(vpt_ctx: int = ELEV_CTX) -> int:
    """The ViT-B/16 image tower's S at 224 px with ``vpt_ctx`` VPT rows."""
    return 1 + 14 * 14 + vpt_ctx


def write_elevater_dataset(root: Path, tasks=None, test: int = ELEV_TEST,
                           shots: int = ELEV_SHOTS) -> Path:
    """The 20 ELEVATER tasks (or ``tasks`` of them) under ``root`` in the
    local manifest layout (``write_task_manifest``; no classnames:
    metadata.json's apply): ``shots`` train and ``test`` val images a
    class (the yaml's DATASET.TEST_SET is "val"), smooth seeded noise plus
    a class colour, as CLI_IMAGE_SIZE JPEGs; voc-2007-classification's
    items carry one or two more classes (multilabel). Written by 8
    threads. A marker holds the sizes it was written with; data of other
    sizes is written anew."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mvlpt_torch.data.elevater import ELEVATER_20_TASKS, class_map, write_task_manifest

    sizes = {"shots": shots, "test": test, "image_size": CLI_IMAGE_SIZE}
    if tasks is not None:
        sizes["tasks"] = list(tasks)
    if _fresh_data(root, sizes):
        return root
    jobs = []
    for t, task in enumerate(ELEVATER_20_TASKS):
        if tasks is not None and task not in tasks:
            continue
        items = write_task_manifest(str(root / task), len(class_map(task)),
                                    {"train": shots, "val": test},
                                    np.random.RandomState(1000 + t),
                                    multilabel=task == "voc-2007-classification")
        jobs += [(root / task / rel, label) for rel, label in items]

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: _write_class_jpeg(jobs[k][0], np.random.RandomState(k),
                                                  jobs[k][1]), range(len(jobs))))
    _mark_written(root, sizes)
    return root


def _state_copy(state) -> tuple:
    """(prompt leaves, optimizer slots and update count, dropout seed) of a
    WindowState, cloned."""
    from mvlpt_torch.utils.tree import tree_leaves

    return ([t.detach().clone() for t in tree_leaves(state.prompt_params)],
            [b.clone() for b in state.opt.tensors()], state.seed.clone())


def _restore(state, copy: tuple) -> None:
    """Write a ``_state_copy`` back into ``state``'s tensors, in place."""
    import torch

    from mvlpt_torch.utils.tree import tree_leaves

    leaves, tensors, seed = copy
    with torch.no_grad():
        for dst, src in zip(tree_leaves(state.prompt_params), leaves):
            dst.copy_(src)
        for dst, src in zip(state.opt.tensors(), tensors):
            dst.copy_(src)
        state.seed.copy_(seed)


class _TimedWindowProbe(_WindowProbe):
    """A ``_WindowProbe`` that also records, for each window: its host ms
    (a sync before and after the call) and its ms between CUDA events, its
    peak memory (the allocator's peak reset at the call); for the windows
    in ``copies``, the state before and after it (``_state_copy``,
    ``states[window]``); and keeps the staged batches of window ``keep``."""

    def __init__(self, make, keep: int = -1, copies: tuple = (0,)):
        super().__init__(make)
        self.keep, self.copies, self.kept, self.timings, self.states = keep, copies, None, [], {}
        self.state = None  # the WindowState of the first window, which the graph reads

    def __call__(self, *args, **kw):
        import torch

        step = self.make(*args, **kw)
        self.steps.append(step)

        def call(state, backbone, consts, batches):
            if self.state is None:
                self.state = state
            window = len(self.windows)
            before = _state_copy(state) if window in self.copies else None
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            start.record()
            state, metrics = step(state, backbone, consts, batches)
            end.record()
            torch.cuda.synchronize()
            k = int(metrics["loss"].shape[0])
            self.timings.append(dict(steps=k, host_ms=1e3 * (time.perf_counter() - t0),
                                     device_ms=start.elapsed_time(end), peak_gib=_peak_gib()))
            if before is not None:
                self.states[window] = (before, _state_copy(state))
            if window == self.keep:
                self.kept = batches
            self.windows.append(metrics)
            return state, metrics
        return call


def _cli_probed(argv: list, probe, epochs: int = 0):
    """(trainer) of one in-process run of the port's CLI with ``probe``
    standing in for ``make_train_step_multi``; then ``epochs`` more epochs
    of the trainer's by ``run_epoch`` (for a --no-train run)."""
    from mvlpt_torch.cli.train import build_parser, main
    from mvlpt_torch.train import trainer as trainer_mod

    trainer_mod.make_train_step_multi = probe
    try:
        trainer = main(build_parser().parse_args(argv))
        for trainer.epoch in range(epochs):
            trainer.run_epoch()
        return trainer
    finally:
        trainer_mod.make_train_step_multi = probe.make


def _results_of(log: Path) -> list[dict]:
    import ast

    return [ast.literal_eval(line[len("results "):]) for line in log.read_text().splitlines()
            if line.startswith("results ")]


def _equal_windows(path: str, what: str, a: dict, b: dict, leaves_a, leaves_b,
                   steps: int | None = None) -> None:
    """Bit equality of two windows' metrics (the first ``steps``) and of
    the prompt leaves after them."""
    import torch

    from mvlpt_torch.train.train_step import WINDOW_METRICS

    for name in WINDOW_METRICS:
        x, y = a[name][:steps], b[name][:steps]
        if not torch.equal(x, y):
            raise AssertionError(f"{path}: {what}: {name} {x.tolist()} against {y.tolist()}")
    for j, (p, q) in enumerate(zip(leaves_a, leaves_b)):
        if not torch.equal(p, q):
            raise AssertionError(f"{path}: {what}: prompt leaf {j} differs by "
                                 f"{(p - q).abs().max().item()}")


def _check_row_shapes(path: str, trainer, text: tuple, text_row: tuple,
                      image_tokens: int) -> None:
    """That a CLI run's kernel shapes are those of its check rows
    (``half_block_shapes``): its text tower's (s, G, rows), its image
    tower's S, and its train and eval batches."""
    cfg = trainer.cfg.DATALOADER
    got = (text, image_tokens, cfg.TRAIN_X.BATCH_SIZE, cfg.TEST.BATCH_SIZE)
    want = (text_row, elevater_image_tokens(), 32, EVAL_BATCH)
    if got != want:
        raise AssertionError(f"{path}: the run's (text (s, G, rows), image S, train batch, "
                             f"eval batch) {got} are not its check rows' {want}")


def drive_trainer_elevater() -> dict:
    """The ELEVATER phases through the port's CLI, in-process on a random
    ViT-B/16 (MVLPT_TPU_RANDOM_CLIP) with the vocab in use, on the data of
    ``write_elevater_dataset``, configs/trainers/MVLPT/vit_b16_tpu_fast.yaml
    (uint8 staging, pre-embedded windows, STEPS_PER_DISPATCH 120 clamped to
    the epoch) and ELEV_OPTS.

    trainer_elevater (main_mt_elevater_cut.sh, UPT): --multi-task
    --multi-task-label_pertask over the 20 tasks, --act-ckpt 4, ELEV_EPOCHS
    epochs. Holds: one windowed step with one capture, windows of one
    shape; the wrappers' launches #1-#6 only, attn_fwd and mlp_fwd twice
    as often as attn_bwd and mlp_bwd (remat); epoch 2's window, replayed,
    equal bit for bit to the same window run eagerly (capture=False) from
    the state before it; that window's first ELEV_TRACE_K steps replayed
    again under a device trace, with no wrapper called, launching #1 and
    #3 twice a layer and #2 and #4 once (TRACE_MARKS), with the metrics of
    the run; the first window equal bit for bit (losses, accuracies, grad
    norms and prompt leaves after it) to the same window of an --act-ckpt
    1 run of the same flags (its trainer built by the CLI with --no-train,
    then two epochs by ``run_epoch``); an --eval-only --model-dir rerun's
    test logits bit-equal; every loss, logit and result finite. Prints s,
    G and the text rows; each epoch's wall, img/s with the loading and the
    loader-wait share; the replayed window's ms a step on the host clock
    and on CUDA events, with and without remat, their peak memory; MFU by
    utils/flops.py at 1151 classes, the run's s, G and image tokens (model
    FLOPs only: remat's recomputed forwards are not counted); every task's
    test metric and the average.

    trainer_elevater_transfer (main_single_elevater_cut.sh):
    ELEV_TRANSFER_TASK alone, warm-started with --model-dir from the
    multitask run's best prompt, --act-ckpt 4, one epoch: the prompt it
    starts from equal to model-best.pth.tar's, one capture, a finite
    results line of the task's metric.

    zeroshot_cli (zeroshot.sh, --eval-only --no-train): ZeroshotCLIP on
    trainer_cli's CoOp dataset and ZeroshotCLIP2 on ELEV_ZS_TASK; each
    launches #5 and #6 only, and prints its test() img/s and accuracy."""
    import PIL
    import torch

    from mvlpt_torch.checkpoint import prompt_io
    from mvlpt_torch.core.text import packing
    from mvlpt_torch.data.elevater import ELEVATER_20_TASKS
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import init_train_state, make_train_step_multi
    from mvlpt_torch.train.train_step import WINDOW_METRICS
    from mvlpt_torch.utils import flops
    from mvlpt_torch.utils.tree import tree_keys, tree_leaves

    path, card = "trainer_elevater", card_line()
    t_data = time.perf_counter()
    data = write_elevater_dataset(ROOT / "build" / "trainer_elevater_data")
    data_s = time.perf_counter() - t_data
    out_dir = ROOT / "build" / "trainer_elevater_out"
    yaml = str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml")
    common = ["--root", str(data), "--trainer", "MVLPT", "--multi-task",
              "--multi-task-label_pertask", "--dataset", ",".join(ELEVATER_20_TASKS),
              "--shots", str(ELEV_SHOTS), "--seed", "1", "--cut-contextlen",
              "--config-file", yaml]
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    os.environ.pop("MVLPT_TPU_RANDOM_CLIP_ARCH", None)
    os.environ.pop("MVLPT_TPU_CLIP_CKPT", None)
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        probe = _TimedWindowProbe(make_train_step_multi, keep=1, copies=(0, 1))
        t0 = time.perf_counter()
        trainer = _cli_probed([*common, "--output-dir", str(out_dir / "train"), "--act-ckpt",
                               "4", *ELEV_OPTS, "OPTIM.MAX_EPOCH", str(ELEV_EPOCHS)], probe)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak_after = _peak_gib()
        logits = _test_logits(trainer)
        evaluated, _ = _cli_run([*common, "--output-dir", str(out_dir / "eval"), "--eval-only",
                                 "--model-dir", str(out_dir / "train"), *ELEV_OPTS])
        logits_again = _test_logits(evaluated)
        del evaluated

        # the same flags under --act-ckpt 1: the trainer from the CLI, its
        # epochs by run_epoch
        probe1 = _TimedWindowProbe(make_train_step_multi)
        plain = _cli_probed([*common, "--output-dir", str(out_dir / "act_ckpt1"), "--act-ckpt",
                             "1", "--no-train", *ELEV_OPTS, "OPTIM.MAX_EPOCH",
                             str(ELEV_EPOCHS)], probe1, epochs=ELEV_EPOCHS)
        if plain.model.remat or not trainer.model.remat:
            raise AssertionError(f"{path}: remat {trainer.model.remat} under --act-ckpt 4, "
                                 f"{plain.model.remat} under 1")
        del plain

        # the transfer run, warm-started from the multitask run's best prompt
        tprobe = _TimedWindowProbe(make_train_step_multi)
        _build.reset_launch_counts()
        transfer = _cli_probed(["--root", str(data), "--trainer", "MVLPT", "--dataset",
                                ELEV_TRANSFER_TASK, "--shots", str(ELEV_SHOTS), "--seed", "1",
                                "--cut-contextlen", "--config-file", yaml, "--act-ckpt", "4",
                                "--model-dir", str(out_dir / "train"), "--output-dir",
                                str(out_dir / "transfer"), *ELEV_OPTS, "OPTIM.MAX_EPOCH", "1"],
                               tprobe)
        t_launches = {name: n for name, n in _build.LAUNCHES.items() if n}
    finally:
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)

    # one windowed step, one capture, windows of one shape
    sizes = [int(m["loss"].shape[0]) for m in probe.windows]
    if (len(probe.steps) != 1 or probe.steps[0].captures != 1 or len(set(sizes)) != 1
            or len(sizes) != ELEV_EPOCHS):
        raise AssertionError(f"{path}: {[s.captures for s in probe.steps]} captures of "
                             f"{len(probe.steps)} windowed steps, windows {sizes}: want one "
                             f"step with 1 capture and one window an epoch")
    want = ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd", "attn_fwd_infer", "mlp_fwd_infer")
    missing = [name for name in want if not launches.get(name)]
    others = {name: n for name, n in launches.items() if n and name not in want}
    if missing or others or launches["attn_fwd"] != 2 * launches["attn_bwd"] \
            or launches["mlp_fwd"] != 2 * launches["mlp_bwd"]:
        raise AssertionError(f"{path}: launches {launches}: {missing} not launched, {others} "
                             "launched, or the forwards not twice the backwards (remat)")

    # epoch 2's window, replayed from the graph, against the same window
    # run eagerly from the state before it
    k = sizes[1]
    before, after = probe.states[1]
    eager_state = init_train_state(trainer.state.prompt_params, trainer.cfg.OPTIM,
                                   trainer.steps_per_epoch)
    _restore(eager_state, before)
    eager = make_train_step_multi(trainer.model, trainer.task_ranges,
                                  pre_embed=bool(trainer.cfg.TPU.PRE_EMBED_WINDOW),
                                  normalize=trainer._normalize, capture=False)
    _, eager_m = eager(eager_state, trainer.backbone, trainer.consts, probe.kept)
    _equal_windows(path, "the replayed window against the eager window", probe.windows[1],
                   eager_m, after[0], tree_leaves(eager_state.prompt_params))
    del eager_state, eager
    # its first ELEV_TRACE_K steps replayed again, traced, on the state
    # the graph was captured against (load_model gave the trainer another)
    _restore(probe.state, before)
    layers = trainer.clip_cfg.vision_layers + trainer.clip_cfg.transformer_layers
    want_marks = {name: 0 for name in TRACE_MARKS}
    want_marks.update(attn_fwd=2 * layers * ELEV_TRACE_K, mlp_fwd=2 * layers * ELEV_TRACE_K,
                      attn_bwd=layers * ELEV_TRACE_K, mlp_bwd=layers * ELEV_TRACE_K)
    (_, traced_m), trace, trace_tries = _traced_replay(lambda: probe.steps[0](
        probe.state, trainer.backbone, trainer.consts,
        {name: t[:ELEV_TRACE_K] for name, t in probe.kept.items()}), probe.state, want_marks)
    called = {name: n for name, n in _build.LAUNCHES.items() if n}
    marked = _marked(trace)
    if called or marked != want_marks or probe.steps[0].captures != 1:
        raise AssertionError(f"{path}: the traced replay called the wrappers {called} and "
                             f"launched {marked}, want {want_marks}")
    for name in WINDOW_METRICS:
        if not torch.equal(traced_m[name][:ELEV_TRACE_K], probe.windows[1][name][:ELEV_TRACE_K]):
            raise AssertionError(f"{path}: the traced replay's {name} differs from the run's")

    # remat against none: the first window bit for bit
    _equal_windows(path, "the first window under --act-ckpt 4 against --act-ckpt 1",
                   probe.windows[0], probe1.windows[0], probe.states[0][1][0],
                   probe1.states[0][1][0])

    results = _results_of(out_dir / "train" / "log.txt")
    eval_results = _results_of(out_dir / "eval" / "log.txt")
    n_tasks = len(ELEVATER_20_TASKS)
    final = dict(zip([*ELEVATER_20_TASKS, "average"], results[-(n_tasks + 1):]))
    if not torch.equal(logits, logits_again) or eval_results[-1] != results[-1]:
        raise AssertionError(f"{path}: the --eval-only rerun's test logits differ by "
                             f"{(logits - logits_again).abs().max().item()} (results "
                             f"{eval_results[-1]} against {results[-1]})")
    n_test = len(trainer.test_loader.dataset.items)
    values = [v for r in final.values() for v in r.values()]
    losses = torch.cat([m["loss"] for m in probe.windows])
    if not (logits.shape == (n_test, trainer.num_classes) and trainer.num_classes == 1151
            and bool(torch.isfinite(logits).all()) and bool(torch.isfinite(losses).all())
            and all(math.isfinite(v) for v in values)):
        raise AssertionError(f"{path}: test logits {tuple(logits.shape)} of "
                             f"{trainer.num_classes} classes, or a loss, logit or result not "
                             f"finite: {final}")

    s = trainer.spec.context_length
    g, rows = packing(trainer.num_classes, s)
    image_tokens = 1 + trainer.clip_cfg.grid_size ** 2 + trainer.spec.vpt_n_ctx
    _check_row_shapes(path, trainer, (s, g, rows), elevater_text_shape(), image_tokens)
    step_flops = flops.flagship_step_flops(batch=32, n_cls=trainer.num_classes,
                                           image_tokens=image_tokens, text_tokens_per_cls=s,
                                           text_pack_classes=g)
    peak_flops = PEAK_FLOPS["bfloat16"]

    def window_numbers(timings: list) -> dict:
        """The replayed window's times (the last) and the capture window's
        peak memory (the first: the eager warm-up step and the capture
        allocate what a step needs; a replay allocates nothing)."""
        t = timings[-1]
        host, dev = t["host_ms"] / t["steps"], t["device_ms"] / t["steps"]
        return dict(ms_per_step=host, device_ms_per_step=dev, img_per_s=32e3 / host,
                    mfu_host=step_flops / (host * 1e-3) / peak_flops,
                    mfu_device=step_flops / (dev * 1e-3) / peak_flops,
                    peak_mem_gib=timings[0]["peak_gib"], replay_peak_mem_gib=t["peak_gib"],
                    capture_window_host_ms=timings[0]["host_ms"])

    epochs = trainer.timings["epochs"]
    remat_w, plain_w = window_numbers(probe.timings), window_numbers(probe1.timings)
    out = {path: dict(
        path=path, card=card, decoder=f"PIL {PIL.__version__}", data_written_s=data_s,
        run_s=run_s, classes=trainer.num_classes, tasks=n_tasks, text_s=s, text_g=g,
        text_rows=rows, image_tokens=image_tokens, train_images=len(
            trainer.train_loader_x.dataset.items), test_images=n_test, windows=sizes,
        captures=probe.steps[0].captures, replays=probe.steps[0].replays,
        launches={k: v for k, v in launches.items() if v},
        traced_replay_launches={k: v for k, v in marked.items() if v}, trace_tries=trace_tries,
        traced_replay_steps=ELEV_TRACE_K,
        epoch_wall_s=[e["wall_s"] for e in epochs],
        train_img_per_s=[e["images"] / e["wall_s"] for e in epochs],
        loader_wait_share=[e["loader_s"] / e["wall_s"] for e in epochs],
        test_img_per_s={f"{t['split']}{i}": t["images"] / t["wall_s"]
                        for i, t in enumerate(trainer.timings["tests"])},
        flops_per_step=step_flops, flops_counted="model FLOPs only (remat's recompute left out)",
        peak_tflops=peak_flops / 1e12, **remat_w,
        act_ckpt1=plain_w,
        remat_equals_act_ckpt1=True, replay_equals_eager=True, eval_only_logits_equal=True,
        first_losses=probe.windows[0]["loss"][:4].tolist(), peak_mem_gib_run=max(
            [peak_after] + [t["peak_gib"] for t in probe.timings]),
        results=final)}
    print("main-path " + json.dumps(out[path]), flush=True)

    # the transfer run
    tpath = "trainer_elevater_transfer"
    best = prompt_io.load_prompt_checkpoint(prompt_io.checkpoint_path(str(out_dir / "train")))
    start = dict(zip(tree_keys(transfer.state.prompt_params), tprobe.states[0][0][0]))
    for key, value in best["state_dict"].items():
        if key in start and not torch.equal(start[key].cpu(), torch.as_tensor(value)):
            raise AssertionError(f"{tpath}: the run did not start from the multitask prompt "
                                 f"({key})")
    t_results = _results_of(out_dir / "transfer" / "log.txt")
    t_sizes = [int(m["loss"].shape[0]) for m in tprobe.windows]
    if (len(tprobe.steps) != 1 or tprobe.steps[0].captures != 1 or not t_results
            or list(t_results[-1]) != ["mean-per-class"]
            or not math.isfinite(t_results[-1]["mean-per-class"])):
        raise AssertionError(f"{tpath}: captures {[st.captures for st in tprobe.steps]}, "
                             f"results {t_results}")
    t_s = transfer.spec.context_length
    _check_row_shapes(tpath, transfer, (t_s, *packing(transfer.num_classes, t_s)),
                      elevater_text_shape((ELEV_TRANSFER_TASK,)),
                      1 + transfer.clip_cfg.grid_size ** 2 + transfer.spec.vpt_n_ctx)
    t_epoch = transfer.timings["epochs"][0]
    out[tpath] = dict(
        path=tpath, card=card, task=ELEV_TRANSFER_TASK, classes=transfer.num_classes,
        text_s=transfer.spec.context_length, windows=t_sizes,
        captures=tprobe.steps[0].captures, launches=t_launches,
        warm_started_from="trainer_elevater's best prompt",
        epoch_wall_s=t_epoch["wall_s"], train_img_per_s=t_epoch["images"] / t_epoch["wall_s"],
        **window_numbers(tprobe.timings), results=t_results[-1])
    print("main-path " + json.dumps(out[tpath]), flush=True)
    del transfer, trainer
    out["zeroshot_cli"] = drive_zeroshot_cli(data)
    return out


def drive_zeroshot_cli(elevater_data: Path) -> dict:
    """zeroshot.sh through the port's CLI (--eval-only --no-train):
    ZeroshotCLIP on trainer_cli's CoOp dataset, ZeroshotCLIP2 on
    ELEV_ZS_TASK; each must launch #5 and #6 and no other kernel, and give
    a finite accuracy. Prints each one's test() img/s and accuracy."""
    import torch

    from mvlpt_torch.ops import _build

    path, card = "zeroshot_cli", card_line()
    yaml = str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml")
    runs = {
        "ZeroshotCLIP[OxfordPets]": [
            "--root", str(write_cli_dataset(ROOT / "build" / "trainer_cli_data")), "--trainer",
            "ZeroshotCLIP", "--dataset-coop", "--dataset", "OxfordPets",
            "--dataset-config-file", str(ROOT / "configs/datasets/oxford_pets.yaml")],
        f"ZeroshotCLIP2[{ELEV_ZS_TASK}]": [
            "--root", str(elevater_data), "--trainer", "ZeroshotCLIP2", "--dataset",
            ELEV_ZS_TASK]}
    out = dict(path=path, card=card, launches={})
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    try:
        for name, argv in runs.items():
            run_dir = ROOT / "build" / "zeroshot_cli_out" / name.split("[")[0]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            trainer, _ = _cli_run([*argv, "--config-file", yaml, "--output-dir", str(run_dir),
                                   "--eval-only", "--no-train"])
            launches = _launches_of(f"{path} {name}", dict(_build.LAUNCHES),
                                    ("attn_fwd_infer", "mlp_fwd_infer"),
                                    _build.LAUNCHES["attn_fwd_infer"])
            if not launches["attn_fwd_infer"]:
                raise AssertionError(f"{path} {name}: #5 and #6 not launched")
            for kname, n in launches.items():
                out["launches"][kname] = out["launches"].get(kname, 0) + n
            cfg = trainer.cfg
            image_tokens = 1 + trainer.clip_cfg.grid_size ** 2
            if (image_tokens, cfg.DATALOADER.TEST.BATCH_SIZE) != (elevater_image_tokens(0),
                                                                  EVAL_BATCH):
                raise AssertionError(f"{path} {name}: image S {image_tokens}, eval batch "
                                     f"{cfg.DATALOADER.TEST.BATCH_SIZE}: not its check rows'")
            test = trainer.timings["tests"][-1]
            results = _results_of(run_dir / "log.txt")[-1]
            if type(trainer).__name__ != name.split("[")[0] or not all(
                    math.isfinite(v) for v in results.values()):
                raise AssertionError(f"{path} {name}: {type(trainer).__name__}, {results}")
            out[name] = dict(images=test["images"], img_per_s=test["images"] / test["wall_s"],
                             accuracy=results["accuracy"], classes=len(trainer.dm.classnames),
                             peak_mem_gib=_peak_gib(),
                             launches={kname: n for kname, n in launches.items() if n})
    finally:
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)
    print("main-path " + json.dumps(out), flush=True)
    return out


# The CoCoOp phases (trainer_cocoop, trainer_cocoop_window): base-to-new
# on a synthetic ImageNet of COCOOP_CLASSES wnid folders the phase writes
# under build/ (``write_imagenet_dataset``), as scripts/cocoop/
# base2new_train.sh and base2new_test.sh run it with
# configs/trainers/CoCoOp/vit_b16.yaml (N_CTX 16, no CTX_INIT, fp16 ->
# bf16, s = 77, batch 32 and 100). Cuts: COCOOP_SHOTS train images a class
# (the script: 16), COCOOP_TEST val images a class (ImageNet's 50),
# CLI_IMAGE_SIZE square JPEGs, COCOOP_EPOCHS epochs (the yaml: 200).
COCOOP_CLASSES, COCOOP_SHOTS, COCOOP_TEST, COCOOP_EPOCHS = 1000, 1, 1, 1
COCOOP_CTX = 16  # the yaml's TRAINER.COCOOP.N_CTX
# The window run's TRAIN.STEPS_PER_DISPATCH, and the steps of its traced
# replay (each CoCoOp step launches about 4 x 10^3 kernels).
COCOOP_WINDOW_K, COCOOP_TRACE_K = 5, 2
# The memory probe: SUN397 base (397 classes, the first 199), the most
# conditioned rows a step (32 x 199 = 6368) that the 8192-row rule leaves
# without the chunk checkpoint among configs/datasets/.
COCOOP_PROBE_CLASSES = 199


def cocoop_base_classes() -> int:
    """The base half of COCOOP_CLASSES (the first ceil(n / 2))."""
    return (COCOOP_CLASSES + 1) // 2


def cocoop_chunk_rows(batch: int, n_cls: int) -> int:
    """The text tower's rows a call at ``batch`` images and ``n_cls``
    classes: _auto_chunk's images a chunk times the classes."""
    from mvlpt_torch.models.custom_clip import _auto_chunk

    return _auto_chunk(batch, n_cls) * n_cls


def cocoop_step_flops(batch: int, n_cls: int, s: int, image_tokens: int) -> int:
    """Model FLOPs of one CoCoOp train step by utils/flops.py: the text
    tower forward and dx-only backward over batch x n_cls sequences of s
    tokens (causal blocks counted whole, as flagship_step_flops does); the
    image tower and the stem forward only (no trained parameter reaches
    them: the meta-net reads their output); the logits. Remat's recomputed
    forwards are not counted."""
    from mvlpt_torch.utils import flops

    seqs = batch * n_cls
    text = flops.transformer_matmul_flops(seqs * s, 512, 12, attn_token_blocks=[s] * seqs)
    image = batch * flops.transformer_matmul_flops(image_tokens, 768, 12, bwd=False)
    stem = batch * 2 * 196 * 768 * 768
    return text + image + stem + 2 * 2 * batch * 512 * n_cls


def write_imagenet_dataset(root: Path) -> Path:
    """A synthetic ImageNet under ``root`` in the layout the port's reader
    takes (data/coop/datasets.py: ImageNet): imagenet/classnames.txt with
    COCOOP_CLASSES seeded wnids and names, and imagenet/images/{train,val}/
    <wnid>/ with COCOOP_SHOTS and COCOOP_TEST JPEGs a class (smooth seeded
    noise plus a class colour, CLI_IMAGE_SIZE square), written by 8
    threads. A marker holds the sizes it was written with; data of other
    sizes is written anew (the reader's caches with it)."""
    import string
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    sizes = {"classes": COCOOP_CLASSES, "shots": COCOOP_SHOTS, "test": COCOOP_TEST,
             "image_size": CLI_IMAGE_SIZE}
    if _fresh_data(root, sizes):
        return root
    ddir = root / "imagenet"
    rng = np.random.RandomState(0)
    wnids = [f"n{id_:08d}" for id_ in sorted(rng.choice(10 ** 8, COCOOP_CLASSES, replace=False))]
    letters = np.array(list(string.ascii_lowercase))
    names = [" ".join("".join(rng.choice(letters, rng.randint(3, 10)))
                      for _ in range(rng.randint(1, 4))) for _ in wnids]
    jobs = []
    for label, wnid in enumerate(wnids):
        for split, count in (("train", COCOOP_SHOTS), ("val", COCOOP_TEST)):
            (ddir / "images" / split / wnid).mkdir(parents=True, exist_ok=True)
            jobs += [(ddir / "images" / split / wnid / f"{wnid}_{i}.JPEG", label)
                     for i in range(count)]
    (ddir / "classnames.txt").write_text(
        "".join(f"{wnid} {name}\n" for wnid, name in zip(wnids, names)))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: _write_class_jpeg(jobs[k][0], np.random.RandomState(k),
                                                  jobs[k][1]), range(len(jobs))))
    _mark_written(root, sizes)
    return root


def _cocoop_argv(data: Path, out: Path, sub: str, flags=(), opts=()) -> list:
    """scripts/cocoop/base2new_{train,test}.sh imagenet 1's flags with the
    phase's cuts, DATASET.SUBSAMPLE_CLASSES ``sub``, ``flags`` and ``opts``."""
    return ["--root", str(data), "--seed", "1", "--trainer", "CoCoOp", "--dataset-coop",
            "--dataset-config-file", str(ROOT / "configs/datasets/imagenet.yaml"),
            "--config-file", str(ROOT / "configs/trainers/CoCoOp/vit_b16.yaml"),
            "--output-dir", str(out), *flags, "DATASET.NUM_SHOTS", str(COCOOP_SHOTS),
            "DATASET.SUBSAMPLE_CLASSES", sub, "OPTIM.MAX_EPOCH", str(COCOOP_EPOCHS), *opts]


class _TimedStepProbe:
    """Stands in for a step factory (``make_train_step`` in the trainer
    module, ``make_finetune_step`` in the finetune module) for one CLI
    run: makes the step as it does and records, for each call, its host ms
    (a sync before and after) and its ms between CUDA events, and its
    metrics; keeps the first call's batch and the params before it."""

    def __init__(self, make):
        self.make, self.timings, self.metrics, self.first = make, [], [], None

    def __call__(self, *args, **kw):
        import torch

        from mvlpt_torch.utils.tree import tree_map

        step = self.make(*args, **kw)

        def call(state, backbone, consts, batch):
            if self.first is None:
                self.first = (batch, tree_map(lambda t: t.detach().clone(), state.prompt_params))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out = step(state, backbone, consts, batch)
            end.record()
            torch.cuda.synchronize()
            self.timings.append((1e3 * (time.perf_counter() - t0), start.elapsed_time(end)))
            self.metrics.append(out[1])
            return out
        return call


def _free_cuda() -> None:
    """Collect garbage and hand the allocator's cached blocks back, so that
    the next run of the phase starts from an empty card (a CoCoOp step's
    peak is most of it)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _check_cocoop_shapes(path: str, got: dict) -> None:
    """That a CoCoOp run's kernel shapes are those of its check rows
    (``half_block_shapes``): s, the text rows a call in training and at
    test, the image tower's S, the train and test batches."""
    want = dict(s=77, train_rows=cocoop_chunk_rows(32, cocoop_base_classes()),
                test_rows=cocoop_chunk_rows(EVAL_BATCH, COCOOP_CLASSES - cocoop_base_classes()),
                image_tokens=elevater_image_tokens(0), train_batch=32, test_batch=EVAL_BATCH)
    if got != want:
        raise AssertionError(f"{path}: the run's shapes {got} are not its check rows' {want}")


def drive_trainer_cocoop() -> dict:
    """CoCoOp through the port's CLI, in-process on a random ViT-B/16
    (MVLPT_TPU_RANDOM_CLIP) with the vocab in use, on the data of
    ``write_imagenet_dataset``, configs/trainers/CoCoOp/vit_b16.yaml (float
    images normalised on the host, batch 32, test batch 100), N_CTX 16,
    s = 77 (no --cut-contextlen), so the text tower is causal, G = 1.

    trainer_cocoop: base2new_train.sh imagenet 1 (the base classes, one
    step a call: 32 x 500 = 16,000 text sequences a step, _auto_chunk 8,
    4 chunks of 4000, each checkpointed past 8192 rows), its final test()
    on the base classes, then base2new_test.sh imagenet 1 (--eval-only
    --model-dir, the new classes at batch 100: chunks of 5 x 500 = 2500,
    20 a batch). Holds: #1-#6 launched as the steps and test batches
    need, and nothing else (per step: the text tower's 4 chunks x 12
    layers #1 and #3 twice, #2 and #4 once; the image tower's 12 layers #1
    and #3 once, no backward: no trained parameter reaches it; per test
    batch 20 x 12 + 12 of #5 and #6); finite losses and results; the
    shapes of its check rows. Prints ms a step on the host clock and on
    CUDA events (the first step left out), img/s, MFU by model FLOPs
    (``cocoop_step_flops``), peak memory, each test() img/s.

    trainer_cocoop_window: the same training with TRAIN.STEPS_PER_DISPATCH
    COCOOP_WINDOW_K (TEST.NO_TEST): one capture, windows of K; window 2's
    first COCOOP_TRACE_K steps replayed again under a trace from the state
    before it, calling no wrapper and launching #1-#4 as above; then, the
    graph freed, window 2 run eagerly (capture=False) and one step a call
    (make_train_step on the window's own pre-embedded tokens) from the
    same state: both equal to the replay bit for bit (losses, accuracies,
    grad norms, prompt leaves). Prints the replayed windows' ms a step
    (host and events), img/s, MFU and the capture window's peak memory.

    Then cocoop_memory (``drive_cocoop_memory``)."""
    import PIL
    import torch

    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import init_train_state, make_train_step, make_train_step_multi
    from mvlpt_torch.train import trainer as trainer_mod
    from mvlpt_torch.train.train_step import WINDOW_METRICS
    from mvlpt_torch.utils.tree import tree_leaves

    path, wpath, card = "trainer_cocoop", "trainer_cocoop_window", card_line()
    _free_cuda()
    t_data = time.perf_counter()
    data = write_imagenet_dataset(ROOT / "build" / "trainer_cocoop_data")
    data_s = time.perf_counter() - t_data
    out_dir = ROOT / "build" / "trainer_cocoop_out"
    n_base, n_new = cocoop_base_classes(), COCOOP_CLASSES - cocoop_base_classes()
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    os.environ.pop("MVLPT_TPU_RANDOM_CLIP_ARCH", None)
    os.environ.pop("MVLPT_TPU_CLIP_CKPT", None)
    try:
        # base2new_train.sh: one step a call, timed by _TimedStepProbe
        steps_probe = _TimedStepProbe(trainer_mod.make_train_step)
        trainer_mod.make_train_step = steps_probe
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            trainer, _ = _cli_run(_cocoop_argv(data, out_dir / "train_base", "base"))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            trainer_mod.make_train_step = steps_probe.make
        launches, peak = dict(_build.LAUNCHES), _peak_gib()
        shapes = dict(s=trainer.spec.context_length,
                      train_rows=cocoop_chunk_rows(trainer.cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
                                                   trainer.num_classes),
                      image_tokens=1 + trainer.clip_cfg.grid_size ** 2 + trainer.spec.vpt_n_ctx,
                      train_batch=trainer.cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
                      test_batch=trainer.cfg.DATALOADER.TEST.BATCH_SIZE)
        layers = trainer.clip_cfg.vision_layers
        chunks = 32 * n_base // shapes["train_rows"]
        n_steps, classes = len(steps_probe.timings), trainer.num_classes
        epochs, tests = trainer.timings["epochs"], trainer.timings["tests"]
        n_train, n_test = (len(trainer.train_loader_x.dataset.items),
                           len(trainer.test_loader.dataset.items))
        remat = trainer.model.remat
        del trainer
        _free_cuda()

        # base2new_test.sh: the new classes, --eval-only from the train run
        _build.reset_launch_counts()
        tested, _ = _cli_run(_cocoop_argv(data, out_dir / "test_new", "new", flags=(
            "--model-dir", str(out_dir / "train_base"), "--eval-only")))
        test_launches = dict(_build.LAUNCHES)
        shapes["test_rows"] = cocoop_chunk_rows(tested.cfg.DATALOADER.TEST.BATCH_SIZE,
                                                tested.num_classes)
        new_classes, new_tests = tested.num_classes, tested.timings["tests"]
        n_test_new = len(tested.test_loader.dataset.items)
        del tested
        _free_cuda()

        # the window run
        probe = _TimedWindowProbe(make_train_step_multi, keep=1, copies=(1,))
        _build.reset_launch_counts()
        wtrainer = _cli_probed(_cocoop_argv(
            data, out_dir / "window", "base",
            opts=("TRAIN.STEPS_PER_DISPATCH", str(COCOOP_WINDOW_K), "TEST.NO_TEST", "True")),
            probe)
        w_launches = dict(_build.LAUNCHES)
    finally:
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)

    # trainer_cocoop: launches, results, shapes
    _check_cocoop_shapes(path, shapes)
    text_calls = chunks * layers
    per_step = dict(attn_fwd=2 * text_calls + layers, mlp_fwd=2 * text_calls + layers,
                    attn_bwd=text_calls, mlp_bwd=text_calls)
    test_batches = -(-n_test // EVAL_BATCH)
    per_batch = (EVAL_BATCH * n_base // shapes["test_rows"]) * layers + layers
    want = {name: 0 for name in launches}
    want.update({name: n * n_steps for name, n in per_step.items()},
                attn_fwd_infer=per_batch * test_batches, mlp_fwd_infer=per_batch * test_batches)
    if (classes, new_classes, chunks, remat) != (n_base, n_new, 4, False) or launches != want:
        raise AssertionError(f"{path}: {classes} base and {new_classes} new classes, {chunks} "
                             f"chunks a step, remat {remat}; launches {launches}, want {want}")
    want_test = {name: 0 for name in test_launches}
    test_batches_new = -(-n_test_new // EVAL_BATCH)
    want_test.update(attn_fwd_infer=per_batch * test_batches_new,
                     mlp_fwd_infer=per_batch * test_batches_new)
    if test_launches != want_test:
        raise AssertionError(f"{path}: the test run launched {test_launches}, want {want_test}")
    results = _results_of(out_dir / "train_base" / "log.txt")
    results_new = _results_of(out_dir / "test_new" / "log.txt")
    if not (results and results_new and math.isfinite(results[-1]["accuracy"])
            and math.isfinite(results_new[-1]["accuracy"])):
        raise AssertionError(f"{path}: results {results[-1:]} (base), {results_new[-1:]} (new)")
    step_flops = cocoop_step_flops(32, n_base, shapes["s"], shapes["image_tokens"])
    peak_flops = PEAK_FLOPS["bfloat16"]

    def rates(host_ms: float, dev_ms: float) -> dict:
        return dict(ms_per_step=host_ms, device_ms_per_step=dev_ms, img_per_s=32e3 / host_ms,
                    mfu_host=step_flops / (host_ms * 1e-3) / peak_flops,
                    mfu_device=step_flops / (dev_ms * 1e-3) / peak_flops)

    timed_steps = steps_probe.timings[1:]
    out = {path: dict(
        path=path, card=card, decoder=f"PIL {PIL.__version__}", data_written_s=data_s,
        run_s=run_s, classes=classes, new_classes=new_classes, text_s=shapes["s"],
        text_rows_a_step=32 * n_base, text_rows_a_chunk=shapes["train_rows"],
        test_rows_a_chunk=shapes["test_rows"], image_tokens=shapes["image_tokens"],
        train_images=n_train, steps=n_steps,
        launches={k: v + test_launches[k] for k, v in launches.items() if v or test_launches[k]},
        train_run_launches={k: v for k, v in launches.items() if v},
        test_run_launches={k: v for k, v in test_launches.items() if v},
        flops_per_step=step_flops, flops_counted="model FLOPs only (remat's recompute left out)",
        peak_tflops=peak_flops / 1e12,
        **rates(sum(h for h, _ in timed_steps) / len(timed_steps),
                sum(d for _, d in timed_steps) / len(timed_steps)),
        step_ms_host=[h for h, _ in steps_probe.timings], peak_mem_gib=peak,
        epoch_wall_s=[e["wall_s"] for e in epochs],
        train_img_per_s=[e["images"] / e["wall_s"] for e in epochs],
        loader_wait_share=[e["loader_s"] / e["wall_s"] for e in epochs],
        test_img_per_s={"base": [t["images"] / t["wall_s"] for t in tests],
                        "new": [t["images"] / t["wall_s"] for t in new_tests]},
        test_images={"base": n_test, "new": n_test_new},
        results_base=results[-1], results_new=results_new[-1])}
    print("main-path " + json.dumps(out[path]), flush=True)

    # trainer_cocoop_window: one capture, windows of K, the traced replay
    sizes = [int(m["loss"].shape[0]) for m in probe.windows]
    step = probe.steps[0] if len(probe.steps) == 1 else None
    if (step is None or step.captures != 1 or set(sizes) != {COCOOP_WINDOW_K}
            or sum(sizes) != n_steps):
        raise AssertionError(f"{wpath}: {[st.captures for st in probe.steps]} captures of "
                             f"{len(probe.steps)} windowed steps, windows {sizes}: want one "
                             f"step with 1 capture and windows of {COCOOP_WINDOW_K} over "
                             f"{n_steps} steps")
    want_w = {name: 0 for name in w_launches}
    want_w.update({name: 2 * n for name, n in per_step.items()})  # the warm-up step, the capture
    if w_launches != want_w:
        raise AssertionError(f"{wpath}: launches {w_launches}, want {want_w}")
    before, after = probe.states[1]
    _restore(probe.state, before)
    want_marks = {name: 0 for name in TRACE_MARKS}
    want_marks.update({name: n * COCOOP_TRACE_K for name, n in per_step.items()})
    (_, traced_m), trace, trace_tries = _traced_replay(lambda: step(
        probe.state, wtrainer.backbone, wtrainer.consts,
        {name: t[:COCOOP_TRACE_K] for name, t in probe.kept.items()}), probe.state, want_marks)
    called = {name: n for name, n in _build.LAUNCHES.items() if n}
    marked = _marked(trace)
    if called or marked != want_marks or step.captures != 1:
        raise AssertionError(f"{wpath}: the traced replay called the wrappers {called} and "
                             f"launched {marked}, want {want_marks}")
    for name in WINDOW_METRICS:
        if not torch.equal(traced_m[name], probe.windows[1][name][:COCOOP_TRACE_K]):
            raise AssertionError(f"{wpath}: the traced replay's {name} differs from the run's")
    timings, k = probe.timings, sizes[1]
    replayed = timings[1:]
    w_rates = rates(sum(t["host_ms"] for t in replayed) / sum(t["steps"] for t in replayed),
                    sum(t["device_ms"] for t in replayed) / sum(t["steps"] for t in replayed))
    capture_peak, replay_peak = timings[0]["peak_gib"], max(t["peak_gib"] for t in replayed)
    windows = probe.windows
    kept, model, backbone, consts = probe.kept, wtrainer.model, wtrainer.backbone, wtrainer.consts
    state_args = (wtrainer.state.prompt_params, wtrainer.cfg.OPTIM, wtrainer.steps_per_epoch)
    eager_kw = dict(pre_embed=bool(wtrainer.cfg.TPU.PRE_EMBED_WINDOW),
                    normalize=wtrainer._normalize)
    task_ranges = wtrainer.task_ranges
    # free the graph (its pool holds a step's peak) before the eager runs
    probe.steps.clear()
    del step, wtrainer
    _free_cuda()

    eager_state = init_train_state(*state_args)
    _restore(eager_state, before)
    eager = make_train_step_multi(model, task_ranges, capture=False, **eager_kw)
    _, eager_m = eager(eager_state, backbone, consts, kept)
    _equal_windows(wpath, "the replayed window against the eager window", windows[1], eager_m,
                   after[0], tree_leaves(eager_state.prompt_params))
    tokens = eager._window_inputs(backbone, kept)
    step_state = init_train_state(*state_args)
    _restore(step_state, before)
    one = make_train_step(model, task_ranges, normalize=eager_kw["normalize"],
                          pre_embedded=eager_kw["pre_embed"])
    per = [one(step_state, backbone, consts, {name: t[i] for name, t in tokens.items()})[1]
           for i in range(k)]
    _equal_windows(wpath, "one step a call against the eager window",
                   {name: torch.stack([m[name] for m in per]) for name in WINDOW_METRICS},
                   eager_m, tree_leaves(step_state.prompt_params),
                   tree_leaves(eager_state.prompt_params))
    losses = torch.cat([m["loss"] for m in windows])
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{wpath}: a loss is not finite: {losses.tolist()}")
    out[wpath] = dict(
        path=wpath, card=card, windows=sizes, captures=1, launches={
            k_: v for k_, v in w_launches.items() if v},
        traced_replay_launches={k_: v for k_, v in marked.items() if v},
        trace_tries=trace_tries,
        traced_replay_steps=COCOOP_TRACE_K, **w_rates, peak_mem_gib=capture_peak,
        replay_peak_mem_gib=replay_peak, capture_window_host_ms=timings[0]["host_ms"],
        replay_equals_eager=True, eager_equals_per_step=True,
        first_losses=windows[0]["loss"].tolist())
    print("main-path " + json.dumps(out[wpath]), flush=True)
    del eager, eager_state, step_state, one, per, tokens, kept, model, backbone, consts
    _free_cuda()

    out.update(drive_cocoop_memory(card, peak))
    return out


def drive_cocoop_memory(card: str, imagenet_peak: float) -> dict:
    """cocoop_memory: one CoCoOp train step (``cocoop_step_memory``) at
    COCOOP_PROBE_CLASSES (SUN397 base) under the rule (no chunk checkpoint
    at 32 x 199 = 6368 rows) and with the checkpoint forced. Holds: loss
    and prompt leaves bit-equal; each step's text-tower calls at the
    text_cocoop_probe row's shape and its image tower at image_cocoop's;
    #1-#4 launched as the step needs them and nothing else. Prints each
    step's peak memory beside ``imagenet_peak`` (trainer_cocoop's)."""
    import torch

    path = "cocoop_memory"
    rule = cocoop_step_memory(COCOOP_PROBE_CLASSES)
    _free_cuda()
    forced = cocoop_step_memory(COCOOP_PROBE_CLASSES, chunk_remat=True)
    _free_cuda()
    if rule["chunk_remat"] or rule["loss"] != forced["loss"] or not all(
            torch.equal(a, b) for a, b in zip(rule.pop("leaves"), forced.pop("leaves"))):
        raise AssertionError(f"{path}: chunk checkpoint {rule['chunk_remat']} under the rule, "
                             f"or the forced one not bit-equal to none")
    probe_rows, s_image = cocoop_chunk_rows(32, COCOOP_PROBE_CLASSES), elevater_image_tokens(0)
    for run in (rule, forced):
        # the text tower's chunks x its layers, their forwards twice under
        # the checkpoint; the image tower's layers forward only
        want_shapes = {(probe_rows, 77)}
        text_calls = 32 * COCOOP_PROBE_CLASSES // probe_rows * run.pop("text_layers")
        fwd = text_calls * (1 + run["chunk_remat"]) + run.pop("image_layers")
        want = {name: 0 for name in run["launches"]}
        want.update(attn_fwd=fwd, mlp_fwd=fwd, attn_bwd=text_calls, mlp_bwd=text_calls)
        if (set(run["text_shapes"]) != want_shapes or run["image_shape"] != (32, s_image)
                or run["launches"] != want):
            raise AssertionError(
                f"{path}: text calls {run['text_shapes']}, image {run['image_shape']}, "
                f"launches {run['launches']}; want {want_shapes}, {(32, s_image)}, {want}")
        run["text_shapes"] = sorted(set(run["text_shapes"]))
        run["launches"] = {name: n for name, n in run["launches"].items() if n}
    names = set(rule["launches"]) | set(forced["launches"])
    launches = {name: rule["launches"].get(name, 0) + forced["launches"].get(name, 0)
                for name in sorted(names)}
    out = dict(path=path, card=card, no_chunk_remat=rule, chunk_remat=forced,
               imagenet_base_peak_mem_gib=imagenet_peak,
               card_gib=torch.cuda.get_device_properties(0).total_memory / 2 ** 30,
               launches={name: n for name, n in launches.items() if n})
    print("main-path " + json.dumps(out), flush=True)
    return {path: out}


def cocoop_step_memory(n_cls: int, chunk_remat: bool | None = None) -> dict:
    """One CoCoOp train step (make_train_step, 32 float images from a seed)
    of configs/trainers/CoCoOp/vit_b16.yaml's CoCoOp (N_CTX 16, s = 77,
    bf16) on a random ViT-B/16 at full width over ``n_cls`` classes:
    its peak memory (the allocator's peak reset before it), host ms, loss,
    the prompt leaves after it, the wrappers' launches in the step and the
    (rows, s) of each text-tower call and the image tower's (B, S).
    ``chunk_remat`` forces each chunk's checkpoint on or off (None: the
    model's rule)."""
    import numpy as np
    import torch

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.core.clip import CLIPConfig, cast_backbone, init_clip_params
    from mvlpt_torch.models import MVLPTModel, custom_clip
    from mvlpt_torch.ops import _build
    from mvlpt_torch.ops.attention import select_attn_fn
    from mvlpt_torch.prompts import PromptSpec, build_prompt_consts, init_prompt_params
    from mvlpt_torch.train import init_train_state, make_train_step
    from mvlpt_torch.utils.tree import tree_leaves

    clip_cfg = CLIPConfig.for_backbone("ViT-B/16")
    backbone = cast_backbone(init_clip_params(torch.Generator().manual_seed(0), clip_cfg,
                                              device="cuda"), torch.bfloat16)
    spec = PromptSpec(n_cls=n_cls, cocoop_n_ctx=COCOOP_CTX,
                      context_length=clip_cfg.context_length,
                      vision_layers=clip_cfg.vision_layers, vision_width=clip_cfg.vision_width,
                      text_width=clip_cfg.transformer_width, embed_dim=clip_cfg.embed_dim,
                      vision_patch_size=clip_cfg.vision_patch_size)
    pp = init_prompt_params(torch.Generator().manual_seed(1), spec, device="cuda")
    consts = build_prompt_consts([f"class number {i}" for i in range(n_cls)], spec, backbone,
                                 torch.bfloat16)
    model = MVLPTModel(clip_cfg, spec, kernels=select_attn_fn("auto"),
                       compute_dtype=torch.bfloat16)
    text_shapes, image_shape = [], []

    def encode_text_prompts(backbone, prompts, eot_idx):
        text_shapes.append(tuple(prompts.shape[:2]))
        return MVLPTModel.encode_text_prompts(model, backbone, prompts, eot_idx)

    def encode_image(backbone, prompt_params, images, *args, **kw):
        grid = images.shape[1] // clip_cfg.vision_patch_size
        image_shape.append((images.shape[0], 1 + grid * grid + spec.vpt_n_ctx))
        return MVLPTModel.encode_image(model, backbone, prompt_params, images, *args, **kw)

    model.encode_text_prompts, model.encode_image = encode_text_prompts, encode_image
    state = init_train_state(pp, optim_config(**OPTIM), 100)
    rng = np.random.RandomState(3)
    res = clip_cfg.image_resolution
    batch = {"image": torch.from_numpy(rng.randn(32, res, res, 3).astype(np.float32)).cuda(),
             "label": torch.from_numpy(rng.randint(0, n_cls, 32)).cuda()}
    rule = custom_clip.COCOOP_REMAT_ROWS
    if chunk_remat is not None:
        custom_clip.COCOOP_REMAT_ROWS = -1 if chunk_remat else 1 << 62
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = make_train_step(model)(state, backbone, consts, batch)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        launches = dict(_build.LAUNCHES)
    finally:
        custom_clip.COCOOP_REMAT_ROWS = rule
    return dict(n_cls=n_cls, rows=32 * n_cls, chunk=custom_clip._auto_chunk(32, n_cls),
                text_layers=clip_cfg.transformer_layers, image_layers=clip_cfg.vision_layers,
                chunk_remat=32 * n_cls > rule if chunk_remat is None else chunk_remat,
                peak_gib=_peak_gib(), step_ms=step_ms, loss=metrics["loss"].item(),
                launches=launches, text_shapes=text_shapes, image_shape=image_shape[0],
                leaves=[t.detach().clone() for t in tree_leaves(state.prompt_params)])


# The linear probe (``drive_lpclip``): python -m mvlpt_torch.cli.lpclip
# extract-features with RN50 (the reference's lpclip/feat_extractor.py:145)
# at batch 128 on trainer_cli's 100-class dataset, then probe on those
# features with the sweep cut to LP_RUNS runs of LP_STEPS binary-search
# steps at LP_SHOTS (the CLI's default: 10 runs, 8 steps, shots 1 2 4 8
# 16; shots 1 and 4 here, so that the mesh phases fit the run's time: the
# 16-shot fit took about a minute on the host). PERF.md §2 stated, before
# the first run, each row's cosine of at
# least LP_COS for the CLI's bf16 features against the fp32 tower on the
# card, TF32 off; on random weights it fails (the features are printed
# with the bound, PERF.md §6) and is not held. What is held is the bf16
# trunk, the map the attention pool reads, at LP_COS: a check added after
# that failure. Random kernels saturate the pool's softmax
# (``_pool_peak``), and the same weights with BatchNorm statistics
# calibrated on the batch (``calibrate_rn_bn``) amplify bf16's rounding
# block by block; both are printed.
LP_BATCH, LP_COS = 128, 0.999
LP_RUNS, LP_STEPS, LP_SHOTS = 1, 1, (1, 4)
# RN50 as an OpenAI-layout state_dict (tests/torch_port_util.py).
RN50_SD = dict(layers=(3, 4, 6, 3), width=64, resolution=224, embed=1024, text_width=512,
               text_layers=12)
# ELEVATER feature extraction (``drive_extract_features``): the CLI's
# defaults (ViT-B/32, batch 128) on one of the 20 tasks with its real
# class names, --knowledge wiki gpt3, with EXTRACT_TEST test images a
# class, so that the test split runs several full batches.
EXTRACT_TASK, EXTRACT_TEST = "oxford-flower-102", 10


def extract_image_tokens() -> int:
    """The image tower's S under the extraction's ViT-B/32: CLS + patches."""
    from mvlpt_torch.core.clip import VIT_ARCHS

    arch = VIT_ARCHS["ViT-B/32"]
    return 1 + (arch["image_resolution"] // arch["vision_patch_size"]) ** 2


class _Timed:
    """Wraps a module function: records each call's host seconds (the card
    synchronized at both ends) in ``seconds``."""

    def __init__(self, module, name: str):
        self.module, self.name, self.fn, self.seconds = module, name, getattr(module, name), []

    def __enter__(self):
        import torch

        def timed_call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*a, **k)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed_call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class _BatchTimes:
    """Wraps ``utils.pipeline.pipelined_inference``: records, for each pass
    over a split, the host time at which each batch's features reach the
    host and the batch's valid rows."""

    def __enter__(self):
        from mvlpt_torch.utils import pipeline

        self.fn, self.passes = pipeline.pipelined_inference, []

        def timed(loader, dispatch):
            times = []
            self.passes.append(times)
            for f, batch in self.fn(loader, dispatch):
                times.append((time.perf_counter(), batch.get("n_valid", len(batch["image"]))))
                yield f, batch

        pipeline.pipelined_inference = timed
        return self

    def __exit__(self, *exc):
        from mvlpt_torch.utils import pipeline

        pipeline.pipelined_inference = self.fn

    def steady_img_per_s(self) -> float:
        """Images a second after each pass's first batch, the loader's start
        with it: a batch reaches the host once the next is loaded and
        dispatched, so batch i's interval holds one batch's loading and one
        batch's tower; the last batch, which waits for no loading, is left
        out too. Passes of three batches or more."""
        runs = [t for t in self.passes if len(t) > 2]
        if not runs:
            raise AssertionError("no split ran three batches")
        return (sum(n for t in runs for _, n in t[1:-1])
                / sum(t[-2][0] - t[0][0] for t in runs))


def _test_helpers():
    """tests/torch_port_util.py of this checkout, loaded from its file (a
    ``tests`` package elsewhere on the path would shadow the name)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_port_util",
                                                  ROOT / "tests" / "torch_port_util.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _split_counts(out_dir: Path, dim: int) -> dict:
    """Rows of each split's npz in ``out_dir``; each must hold finite fp32
    features of width ``dim`` and one label a row."""
    import numpy as np

    counts = {}
    for split in ("train", "val", "test"):
        f = out_dir / f"{split}.npz"
        if not f.exists():
            continue
        with np.load(f) as z:
            x, y = z["feature_list"], z["label_list"]
        if x.dtype != np.float32 or x.shape[1] != dim or len(y) != len(x) or not np.isfinite(
                x).all():
            raise AssertionError(f"{f}: features {x.dtype} {x.shape}, {len(y)} labels")
        counts[split] = len(x)
    return counts


def _pool_peak(p: dict, trunk, n_heads: int) -> float:
    """The attention pool's mean, over images and heads, of the largest
    softmax probability of the mean token's query (fp32): near 1, each head
    attends to one key, and the features jump wherever a rounding moves
    that choice."""
    import torch

    x = trunk.flatten(2).transpose(1, 2).float()
    b, s, c = x.shape
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + p["pos_embedding"].float()
    q = x[:, :1] @ p["q_proj"]["kernel"].float() + p["q_proj"]["bias"].float()
    k = x @ p["k_proj"]["kernel"].float() + p["k_proj"]["bias"].float()
    d = c // n_heads
    logits = torch.einsum("bqhd,bkhd->bhqk", q.reshape(b, 1, n_heads, d) * d ** -0.5,
                          k.reshape(b, s + 1, n_heads, d))
    return torch.softmax(logits, dim=-1).amax(dim=-1).mean().item()


def drive_lpclip() -> dict:
    """lpclip through the port's CLI: extract-features with a random RN50
    and with RN50 converted from an OpenAI-layout state_dict the phase
    writes (MVLPT_TPU_CLIP_CKPT), then probe. No kernel may launch (the
    tower is cuDNN's convolutions and plain ops, as XLA's are in the JAX
    package). Prints the tower's ms a batch of LP_BATCH (CUDA events and
    the host clock), img/s of the tower alone and of the extraction with
    its loading (whole splits, and after each split's first batch), peak
    memory, the bf16-vs-fp32 cosines (also of the converted weights with
    calibrated BatchNorm statistics), and for each shot count the probe's
    fits, their time and mean L-BFGS iterations a fit."""
    import shutil

    import numpy as np
    import torch

    from mvlpt_torch.checkpoint.convert import convert_openai_rn_state_dict
    from mvlpt_torch.cli import lpclip
    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.core import clip as clip_core
    from mvlpt_torch.core import resnet
    from mvlpt_torch.data.loader import eval_mode
    from mvlpt_torch.data.managers import build_data_manager
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train.trainer import load_clip_backbone
    from mvlpt_torch.utils import pipeline

    path, card = "lpclip", card_line()
    data = write_cli_dataset(ROOT / "build" / "trainer_cli_data")
    ckpt = ROOT / "build" / "lpclip" / "RN50-openai-layout.pt"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    helpers = _test_helpers()
    t0 = time.perf_counter()
    sd = helpers.openai_rn_state_dict(0, **RN50_SD)
    torch.save(sd, str(ckpt))
    out = dict(path=path, card=card, launches={}, state_dict_write_s=time.perf_counter() - t0)
    envs = {"random": ("MVLPT_TPU_RANDOM_CLIP", "1"), "checkpoint": ("MVLPT_TPU_CLIP_CKPT",
                                                                     str(ckpt))}
    for name, (key, value) in envs.items():
        os.environ[key] = value
        try:
            feat_dir = ROOT / "build" / "lpclip_out" / name / "OxfordPets"
            _free_cuda()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            argv = ["extract-features", "--root", str(data), "--dataset-coop", "--dataset",
                    "OxfordPets", "--output-dir", str(feat_dir), "--batch-size", str(LP_BATCH),
                    "--num-workers", "8"]
            with _Timed(pipeline, "dump_split_features") as dumps, _BatchTimes() as batches:
                lpclip.cli(argv)
            wall = time.perf_counter() - t0
            _launches_of(f"{path} {name}", dict(_build.LAUNCHES), (), 0)
            peak = _peak_gib()
            counts = _split_counts(feat_dir, RN50_SD["embed"])
            if counts != {"train": CLI_CLASSES * CLI_SHOTS, "val": CLI_CLASSES * CLI_VAL,
                          "test": CLI_CLASSES * CLI_TEST}:
                raise AssertionError(f"{path} {name}: rows {counts}")

            # The tower alone on the first train batch, and in fp32 (TF32 off)
            # against the rows the CLI wrote for that batch.
            cfg = get_cfg_default()
            cfg.DATASET.ROOT, cfg.DATASET.COOP = str(data), True
            cfg.DATASET.DATASET = cfg.DATASET.NAME = "OxfordPets"
            cfg.DATALOADER.TRAIN_X.BATCH_SIZE = cfg.DATALOADER.TEST.BATCH_SIZE = LP_BATCH
            cfg.DATALOADER.NUM_WORKERS = 8
            cfg.INPUT.TRANSFORMS = ()
            cfg.MODEL.BACKBONE.NAME = "RN50"
            batch = next(iter(eval_mode(build_data_manager(cfg).train_loader_x)))
            images = torch.from_numpy(batch["image"]).to("cuda")
            if images.dtype != torch.float32:
                raise AssertionError(f"{path}: the loader gave {images.dtype} images")
            feats, trunks = {}, {}
            for dtype in (torch.bfloat16, torch.float32):
                backbone, rn_cfg = load_clip_backbone(cfg, dtype)
                with torch.no_grad():
                    tower = lambda: clip_core.encode_image(backbone, images, rn_cfg)  # noqa: E731
                    feats[dtype] = tower().float()
                    trunks[dtype] = resnet.trunk_rn(backbone["visual"], images).float()
                    if dtype == torch.bfloat16:
                        med, lo, hi = cuda_times(tower)
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        for _ in range(REPS):
                            tower()
                        torch.cuda.synchronize()
                        host_ms = (time.perf_counter() - t1) / REPS * 1e3
                        # cuDNN's autotuned algorithms, beside its heuristics' (the default)
                        torch.backends.cudnn.benchmark = True
                        try:
                            bench_ms = cuda_times(tower)[0]
                        finally:
                            torch.backends.cudnn.benchmark = False
                    else:
                        peak_prob = _pool_peak(backbone["visual"]["attnpool"], trunks[dtype],
                                               rn_cfg.heads)
                del backbone
            with np.load(feat_dir / "train.npz") as z:
                cli_rows = torch.from_numpy(z["feature_list"][:LP_BATCH]).to("cuda")
            ref = feats[torch.float32]
            cos = torch.nn.functional.cosine_similarity(cli_rows, ref, dim=1)
            t16, t32 = trunks[torch.bfloat16].flatten(1), trunks[torch.float32].flatten(1)
            trunk_cos = torch.nn.functional.cosine_similarity(t16, t32, dim=1)
            trunk_rel = ((t16 - t32).norm() / t32.norm()).item()
            same = torch.equal(cli_rows, feats[torch.bfloat16])
            images_n = sum(counts.values())
            out[name] = dict(
                rows=counts, wall_s=wall, extract_s=sum(dumps.seconds), split_s=dumps.seconds,
                img_per_s_with_loading=images_n / sum(dumps.seconds),
                img_per_s_steady=batches.steady_img_per_s(),
                tower_ms=med, tower_ms_spread=[lo, hi], tower_host_ms=host_ms,
                tower_ms_cudnn_benchmark=bench_ms,
                tower_img_per_s=LP_BATCH / med * 1e3, peak_mem_gib=peak,
                trunk_cos_min_vs_fp32=trunk_cos.min().item(), trunk_rel_err_vs_fp32=trunk_rel,
                features_cos_min_vs_fp32=cos.min().item(), pool_mean_max_prob=peak_prob,
                cli_rows_equal_tower=same)
            if not trunk_cos.min().item() >= LP_COS:
                raise AssertionError(f"{path} {name}: the bf16 trunk against the fp32 one, "
                                     f"cosine {trunk_cos.min().item()} < {LP_COS}")
            print(f"{path} {name} [{card}]: RN50 tower {med:.3f} ms a batch of {LP_BATCH} "
                  f"(CUDA events; host {host_ms:.3f}; {bench_ms:.3f} with cudnn.benchmark), "
                  f"{LP_BATCH / med * 1e3:.1f} img/s alone, "
                  f"{images_n / sum(dumps.seconds):.1f} img/s with the loading (every split's "
                  f"loader start included; {batches.steady_img_per_s():.1f} after each split's "
                  f"first batch), peak {peak:.2f} GiB; bf16 vs fp32: trunk cosine >= "
                  f"{trunk_cos.min().item():.6f} (held at {LP_COS}; relative error "
                  f"{trunk_rel:.2e}), features after the pool >= {cos.min().item():.6f} "
                  f"(PERF.md §2's {LP_COS}, not held), the pool's mean max probability "
                  f"{peak_prob:.6f}", flush=True)
            if name == "random":
                _free_cuda()
                out[name]["read_turns"] = read_turns(
                    f"{path} {name}", card, lambda: lpclip.cli(argv), images_n,
                    out[name]["img_per_s_with_loading"])
        finally:
            os.environ.pop(key, None)

    # The converted weights with every BatchNorm's statistics calibrated by
    # one fp32 pass over the batch: measured and printed, not held.
    calibrated = {k: v.clone() for k, v in sd.items()}
    helpers.calibrate_rn_bn(calibrated, images.permute(0, 3, 1, 2))
    feats, trunks = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        backbone, rn_cfg, _ = convert_openai_rn_state_dict(calibrated, dtype=dtype, device="cuda")
        with torch.no_grad():
            feats[dtype] = clip_core.encode_image(backbone, images, rn_cfg).float()
            trunks[dtype] = resnet.trunk_rn(backbone["visual"], images).float()
        if dtype == torch.float32:
            peak_prob = _pool_peak(backbone["visual"]["attnpool"], trunks[dtype], rn_cfg.heads)
        del backbone
    cos = torch.nn.functional.cosine_similarity(feats[torch.bfloat16], feats[torch.float32],
                                                dim=1)
    t16, t32 = trunks[torch.bfloat16].flatten(1), trunks[torch.float32].flatten(1)
    out["calibrated"] = dict(
        trunk_cos_min_vs_fp32=torch.nn.functional.cosine_similarity(t16, t32, dim=1).min().item(),
        trunk_rel_err_vs_fp32=((t16 - t32).norm() / t32.norm()).item(),
        features_cos_min_vs_fp32=cos.min().item(), pool_mean_max_prob=peak_prob)
    print(f"{path} calibrated [{card}]: BatchNorm statistics from one fp32 pass over the batch; "
          f"bf16 vs fp32 (not held): trunk cosine >= {out['calibrated']['trunk_cos_min_vs_fp32']:.6f}"
          f" (relative error {out['calibrated']['trunk_rel_err_vs_fp32']:.2e}), features after "
          f"the pool >= {cos.min().item():.6f}, the pool's mean max probability {peak_prob:.6f}",
          flush=True)
    del feats, trunks, calibrated
    _free_cuda()

    feat_dir = ROOT / "build" / "lpclip_out" / "checkpoint" / "OxfordPets"
    report = ROOT / "build" / "lpclip_out" / "report"
    shutil.rmtree(report, ignore_errors=True)
    t0 = time.perf_counter()
    cut = ["--num-run", str(LP_RUNS), "--num-step", str(LP_STEPS), "--shots",
           *map(str, LP_SHOTS)]
    stats = lpclip.probe(lpclip.build_parser().parse_args(
        ["probe", "--feature-dir", str(feat_dir), "--dataset", "OxfordPets", "--report-dir",
         str(report), *cut]))
    probe_s = time.perf_counter() - t0
    lines = (report / f"OxfordPets_s{LP_STEPS}r{LP_RUNS}.txt").read_text().splitlines()
    accs = [float(re.search(r"Test acc stat: ([0-9.]+) \(", line).group(1)) for line in lines]
    if len(accs) != len(LP_SHOTS) or not all(0.0 <= a <= 100.0 for a in accs):
        raise AssertionError(f"{path} probe: {lines}")
    out["probe"] = dict(wall_s=probe_s, summary=lines, cut=" ".join(cut), shots={})
    print(f"{path} probe [{card}]: {probe_s:.2f} s ({' '.join(cut)})", flush=True)
    for shot, st in stats.items():
        its, evals = st["iterations"], st["evaluations"]
        row = out["probe"]["shots"][shot] = dict(
            fits=st["fits"], fit_s=st["fit_s"], mean_iterations=its / st["fits"],
            evaluations=evals, objective_ms=st["objective_s"] / evals * 1e3,
            solver_ms=(st["fit_s"] - st["objective_s"]) / its * 1e3)
        print(f"{path} probe {shot}-shot [{card}]: {st['fits']} fits in {st['fit_s']:.2f} s, "
              f"{row['mean_iterations']:.1f} L-BFGS iterations a fit; "
              f"{row['objective_ms']:.3f} ms an objective evaluation ({evals}), "
              f"{row['solver_ms']:.3f} ms of scipy's solver an iteration", flush=True)
    out["img_per_s"] = out["checkpoint"]["tower_img_per_s"]
    out["peak_mem_gib"] = max(out[n]["peak_mem_gib"] for n in envs)
    print("main-path " + json.dumps(out), flush=True)
    return out


def drive_lpclip_native(lp: dict) -> dict:
    """lpclip extract-features (lpclip_native) as ``drive_lpclip``'s random
    RN50 run, with a --config-file that sets DATALOADER.BACKEND "native":
    every split's features and labels equal that run's bit for bit
    (``lp``, the python backend in this call). Prints each split's img/s
    with the loading beside the python run's, and the transform each
    split ran: lpclip builds the eval transform for every split
    (INPUT.TRANSFORMS = ()), so ``data.loader.eval_mode``, which swaps
    only a training transform (NativeTrainTransform included) for PIL's
    EvalTransform, leaves each split on the core."""
    import numpy as np
    import torch

    from mvlpt_torch.cli import lpclip
    from mvlpt_torch.ops import _build
    from mvlpt_torch.utils import pipeline

    path, card = "lpclip_native", card_line()
    data = write_cli_dataset(ROOT / "build" / "trainer_cli_data")
    config = ROOT / "build" / "lpclip_native.yaml"
    config.write_text('DATALOADER:\n  BACKEND: "native"\n')
    feat_dir = ROOT / "build" / "lpclip_out" / "native" / "OxfordPets"
    python_dir = ROOT / "build" / "lpclip_out" / "random" / "OxfordPets"
    dump, seconds, transforms = pipeline.dump_split_features, [], []

    def timed_dump(loader, dispatch, out_path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = dump(loader, dispatch, out_path)  # eval_mode(loader) first, as the CLI's
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        transforms.append(type(loader.dataset.transform).__name__)
        return n

    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    pipeline.dump_split_features = timed_dump
    try:
        _free_cuda()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        lpclip.cli(["extract-features", "--root", str(data), "--dataset-coop", "--dataset",
                    "OxfordPets", "--output-dir", str(feat_dir), "--batch-size", str(LP_BATCH),
                    "--num-workers", "8", "--config-file", str(config)])
        wall = time.perf_counter() - t0
    finally:
        pipeline.dump_split_features = dump
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)
    _launches_of(path, dict(_build.LAUNCHES), (), 0)
    splits = ("train", "val", "test")
    counts = _split_counts(feat_dir, RN50_SD["embed"])
    for split in splits:
        with np.load(feat_dir / f"{split}.npz") as a, np.load(python_dir / f"{split}.npz") as b:
            if not (np.array_equal(a["feature_list"], b["feature_list"])
                    and np.array_equal(a["label_list"], b["label_list"])):
                diff = np.abs(a["feature_list"] - b["feature_list"]).max()
                raise AssertionError(f"{path}: {split} features differ from the python "
                                     f"backend's by up to {diff}")
    if not all(t == "NativeEvalTransform" for t in transforms):
        raise AssertionError(f"{path}: the splits ran {transforms}")
    rate = {s: counts[s] / t for s, t in zip(splits, seconds)}
    py = lp["random"]
    py_rate = {s: lp["random"]["rows"][s] / t for s, t in zip(splits, py["split_s"])}
    out = dict(path=path, card=card, launches={}, wall_s=wall, rows=counts, split_s=seconds,
               img_per_s_by_split=rate, python_img_per_s_by_split=py_rate,
               img_per_s_with_loading=sum(counts.values()) / sum(seconds),
               python_img_per_s_with_loading=py["img_per_s_with_loading"],
               transforms=dict(zip(splits, transforms)), features_equal_python=True)
    print(f"{path} [{card}]: img/s with the loading by split "
          f"{', '.join(f'{s} {rate[s]:.1f}' for s in splits)} (the python backend's run in this "
          f"call: {', '.join(f'{s} {py_rate[s]:.1f}' for s in splits)}); "
          f"{out['img_per_s_with_loading']:.1f} over all against "
          f"{py['img_per_s_with_loading']:.1f}; features and labels of every split equal the "
          f"python backend's bit for bit; transforms {out['transforms']} (lpclip builds the eval "
          f"transform for every split, so eval_mode, which would swap a training transform for "
          f"PIL's EvalTransform, leaves the train split on the core)", flush=True)
    print("main-path " + json.dumps(out), flush=True)
    return out


def drive_extract_features() -> dict:
    """ELEVATER's extract_features through the port's CLI on EXTRACT_TASK
    (real class names, EXTRACT_TEST test images a class, a random
    ViT-B/32, batch 128, --knowledge wiki gpt3): every split's image
    features through #5/#6, launched 12 times an image batch and no other
    kernel, and text.npz from the knowledge texts on the plain text tower.
    Prints image img/s over the whole splits and after each split's first
    batch, and the text step's ms."""
    import numpy as np
    import torch

    from mvlpt_torch.cli import extract_features
    from mvlpt_torch.data.elevater import class_map, knowledge
    from mvlpt_torch.ops import _build, block
    from mvlpt_torch.utils import pipeline

    path, card = "extract_features", card_line()
    data = write_elevater_dataset(ROOT / "build" / "extract_features_data", tasks=[EXTRACT_TASK],
                                  test=EXTRACT_TEST)
    out_dir = ROOT / "build" / "extract_features_out"
    # The (B, S, W, H) of every block the kernels run, for its check row.
    shapes, fused = set(), block.fused_residual_block

    def recording(x, p, n_heads, *a, **k):
        shapes.add((*x.shape, n_heads))
        return fused(x, p, n_heads, *a, **k)

    argv = ["--root", str(data), "--dataset", EXTRACT_TASK, "--backbone", "ViT-B/32",
            "--output-dir", str(out_dir), "--batch-size", str(LP_BATCH), "--knowledge", "wiki",
            "gpt3"]
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    block.fused_residual_block = recording
    try:
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        with _Timed(pipeline, "dump_split_features") as dumps, _BatchTimes() as timed, \
                _Timed(knowledge, "encode_class_text_features_with_knowledge") as text:
            extract_features.cli(argv)
        counts = _split_counts(out_dir, 512)
        batches = sum(-(-n // LP_BATCH) for n in counts.values())
        row = half_block_shapes()[0]["image_extract"][:4]
        if shapes != {row}:
            raise AssertionError(f"{path}: the run's blocks (B, S, W, H) {shapes} are not its "
                                 f"check row's {row}")
        launches = _launches_of(path, dict(_build.LAUNCHES), ("attn_fwd_infer", "mlp_fwd_infer"),
                                12 * batches)
        with np.load(out_dir / "text.npz", allow_pickle=True) as z:
            tf, names = z["text_features"], list(z["classnames"])
        if tf.shape != (len(class_map(EXTRACT_TASK)), 512) or not np.isfinite(tf).all() or not np.allclose(
                np.linalg.norm(tf, axis=1), 1.0, atol=1e-5):
            raise AssertionError(f"{path}: text features {tf.shape}")
        if len(text.seconds) != 1:
            raise AssertionError(f"{path}: the knowledge text step ran {len(text.seconds)} times")
        images_n = sum(counts.values())
        turns = read_turns(path, card, lambda: extract_features.cli(argv), images_n,
                           images_n / sum(dumps.seconds))
    finally:
        block.fused_residual_block = fused
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)
    images_n = sum(counts.values())
    out = dict(path=path, card=card, task=EXTRACT_TASK, classes=len(names), rows=counts,
               image_batches=batches, launches={k: n for k, n in launches.items() if n},
               img_per_s=images_n / sum(dumps.seconds),
               img_per_s_steady=timed.steady_img_per_s(), text_ms=text.seconds[0] * 1e3,
               peak_mem_gib=_peak_gib(), read_turns=turns)
    print(f"{path} [{card}]: {images_n} images ({counts}) in {batches} batches of {LP_BATCH}, "
          f"{out['img_per_s']:.1f} img/s with the loading (every split's loader start "
          f"included; {out['img_per_s_steady']:.1f} after each split's first batch); the "
          f"knowledge text step {out['text_ms']:.1f} ms for {len(names)} classes", flush=True)
    print("main-path " + json.dumps(out), flush=True)
    return out


# The model zoo through extract_features --model (``drive_zoo_extract``), at
# full width on EXTRACT_TASK, each from a random state dict in its family's
# key layout that tests/torch_port_util.py writes: name -> (writer, its
# arguments, the feature width). efficientnet_b0's arguments are B0's table
# (core/efficientnet.py, checked against EFFNET_CONFIGS by the converter's
# config). ZOO_COS: each bf16 feature row's least cosine to the fp32 one
# on the card (TF32 off), stated in PERF.md §2 before the first run;
# ZOO_CHECK_IMAGES test images are also held in fp32, card against CPU,
# within ZOO_FP32_REL x max|ref|.
ZOO_MODELS = {
    "vit_base_patch16_224": ("timm_vit_state_dict", dict(width=768, layers=12, patch=16,
                                                         resolution=224, num_classes=1000), 768),
    "resnet50": ("tv_resnet_state_dict", dict(layers=(3, 4, 6, 3), width=64, bottleneck=True,
                                              num_classes=1000), 2048),
    "efficientnet_b0": ("timm_effnet_state_dict", dict(
        stages=((1, 3, 1, 1, 16), (2, 3, 2, 6, 24), (2, 5, 2, 6, 40), (3, 3, 2, 6, 80),
                (3, 5, 1, 6, 112), (4, 5, 2, 6, 192), (1, 3, 1, 6, 320)),
        stem_ch=32, head_ch=1280, num_classes=1000), 1280)}
ZOO_COS, ZOO_CHECK_IMAGES, ZOO_FP32_REL = 0.999, 4, 1e-4
# The zoo models whose extraction also runs with the previous read, in turns
# (``read_turns``): the ViT, whose read waited on the next batch's tower.
ZOO_READ_TURNS = ("vit_base_patch16_224",)
# interpret_prompt's CoOp-layout checkpoint: N_CTX x the text width of the
# random ViT-B/16, from a seeded generator; its top-k against float64
# numpy on the host (indices equal but where two distances tie within
# INTERPRET_TIE, distances within INTERPRET_REL, both relative).
INTERPRET_CTX, INTERPRET_TOPK, INTERPRET_TIE, INTERPRET_REL = (16, 512), 5, 1e-6, 1e-5


def _zoo_batch(data: Path):
    """The first test batch of EXTRACT_TASK as the zoo's extraction loads it
    (224 px, ImageNet's statistics, eval mode), on the card."""
    import torch

    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.data.loader import eval_mode
    from mvlpt_torch.data.managers import build_data_manager
    from mvlpt_torch.models.zoo import _IMAGENET_MEAN, _IMAGENET_STD

    cfg = get_cfg_default()
    cfg.DATASET.ROOT, cfg.DATASET.DATASET = str(data), EXTRACT_TASK
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = cfg.DATALOADER.TEST.BATCH_SIZE = LP_BATCH
    cfg.INPUT.SIZE = (224, 224)
    cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD = list(_IMAGENET_MEAN), list(_IMAGENET_STD)
    batch = next(iter(eval_mode(build_data_manager(cfg, strict_classnames=False).test_loader)))
    return torch.from_numpy(batch["image"]).to("cuda")


def drive_zoo_extract(rows: dict) -> dict:
    """extract_features --model through the port's CLI (bf16, batch 128) for
    each of ZOO_MODELS on EXTRACT_TASK, from a full-width random state dict
    in its family's key layout (written by tests/torch_port_util.py, loaded
    by path): every split with ``rows`` rows (the CLIP extraction's on the
    same data) of finite features of the family's width, no kernel of the
    repo launched (the JAX zoo runs no Pallas), and the first
    ZOO_CHECK_IMAGES test images' fp32 features on the card (TF32 off)
    within ZOO_FP32_REL x max|ref| of the same module's on the CPU. Prints,
    with the card's name and power limit: img/s with the loading (whole
    splits, and after each split's first batch), the tower's ms a batch of
    128 alone (median of REPS CUDA-event runs) and its img/s, peak memory,
    the checkpoint's load-and-convert seconds (the CLI's get_model call)
    and the bf16-vs-fp32 cosine of the CLI's features, held at ZOO_COS."""
    import numpy as np
    import torch

    from mvlpt_torch.cli import extract_features
    from mvlpt_torch.data.transforms import device_normalize
    from mvlpt_torch.models import zoo
    from mvlpt_torch.ops import _build
    from mvlpt_torch.utils import pipeline

    path, card = "zoo_extract", card_line()
    data = write_elevater_dataset(ROOT / "build" / "extract_features_data", tasks=[EXTRACT_TASK],
                                  test=EXTRACT_TEST)
    helpers = _test_helpers()
    images = _zoo_batch(data)
    n = ZOO_CHECK_IMAGES
    out = dict(path=path, card=card, launches={}, task=EXTRACT_TASK, models={})
    for name, (writer, kwargs, dim) in ZOO_MODELS.items():
        ckpt = ROOT / "build" / "zoo" / f"{name}.pth"
        ckpt.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        torch.save(getattr(helpers, writer)(0, **kwargs), str(ckpt))
        write_s = time.perf_counter() - t0
        out_dir = ROOT / "build" / "zoo_out" / name
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        argv = ["--root", str(data), "--dataset", EXTRACT_TASK, "--model", name,
                "--model-checkpoint", str(ckpt), "--output-dir", str(out_dir), "--batch-size",
                str(LP_BATCH)]
        with _Timed(zoo, "get_model") as load, _Timed(pipeline, "dump_split_features") as dumps, \
                _BatchTimes() as batches:
            extract_features.cli(argv)
        _launches_of(f"{path} {name}", dict(_build.LAUNCHES), (), 0)
        peak = _peak_gib()
        counts = _split_counts(out_dir, dim)
        if counts != rows:
            raise AssertionError(f"{path} {name}: rows {counts}, want {rows}")

        # The tower alone in bf16, and fp32 on the card against the CPU.
        m16 = zoo.get_model(name, checkpoint=str(ckpt), dtype=torch.bfloat16)
        if name == "efficientnet_b0":  # the writer's table is B0's
            from mvlpt_torch.core.efficientnet import EFFNET_CONFIGS

            blocks = [len(stage) for stage in m16.params["stages"]]
            if blocks != [st[0] for st in EFFNET_CONFIGS[name].stages] or m16.feature_dim != dim:
                raise AssertionError(f"{path} {name}: blocks {blocks}, width {m16.feature_dim}")
        mean, std = m16.pixel_mean, m16.pixel_std
        x = device_normalize(images, mean, std)
        with torch.no_grad():
            med, lo, hi = cuda_times(lambda: m16.features(x))
            del m16
            m32 = zoo.get_model(name, checkpoint=str(ckpt), dtype=torch.float32)
            f32 = m32.features(x[:n]).float()
            del m32
            ref = zoo.get_model(name, checkpoint=str(ckpt), dtype=torch.float32,
                                device="cpu").features(x[:n].cpu())
        err = (f32.cpu() - ref).abs().max().item()
        tol = ZOO_FP32_REL * ref.abs().max().item()
        with np.load(out_dir / "test.npz") as z:
            cli_rows = torch.from_numpy(z["feature_list"][:n]).to("cuda")
        cos = torch.nn.functional.cosine_similarity(cli_rows, f32, dim=1).min().item()
        images_n = sum(counts.values())
        row = out["models"][name] = dict(
            rows=counts, state_dict_write_s=write_s, load_convert_s=load.seconds[0],
            img_per_s_with_loading=images_n / sum(dumps.seconds),
            img_per_s_steady=batches.steady_img_per_s(), tower_ms=med, tower_ms_spread=[lo, hi],
            tower_img_per_s=LP_BATCH / med * 1e3, peak_mem_gib=peak,
            fp32_card_vs_cpu_max_err=err, fp32_tol=tol, features_cos_min_vs_fp32=cos)
        print(f"{path} {name} [{card}]: {images_n} images ({counts}), "
              f"{row['img_per_s_with_loading']:.1f} img/s with the loading (every split's loader "
              f"start included; {row['img_per_s_steady']:.1f} after each split's first batch); "
              f"the bf16 tower {med:.3f} ms a batch of {LP_BATCH} (CUDA events, [{lo:.3f}, "
              f"{hi:.3f}]), {row['tower_img_per_s']:.1f} img/s alone; peak {peak:.2f} GiB; "
              f"load and convert {load.seconds[0]:.2f} s (state dict written in {write_s:.2f} "
              f"s); fp32 card vs CPU on {n} test images max|err| {err:.3e} (held at {tol:.3e}); "
              f"bf16 vs fp32 cosine >= {cos:.6f} (held at {ZOO_COS})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{path} {name}: fp32 features on the card against the CPU, "
                                 f"max|err| {err} > {tol}")
        if not cos >= ZOO_COS:
            raise AssertionError(f"{path} {name}: bf16 against fp32 features, cosine {cos} < "
                                 f"{ZOO_COS}")
        if name in ZOO_READ_TURNS:
            _free_cuda()
            row["read_turns"] = read_turns(f"{path} {name}", card,
                                           lambda: extract_features.cli(argv), images_n,
                                           row["img_per_s_with_loading"])
        _free_cuda()
    out["peak_mem_gib"] = max(m["peak_mem_gib"] for m in out["models"].values())
    print("main-path " + json.dumps(out), flush=True)
    return out


def drive_interpret_prompt() -> dict:
    """interpret_prompt through the port's CLI on the card with the random
    ViT-B/16 (MVLPT_TPU_RANDOM_CLIP) on a CoOp-layout prompt checkpoint the
    phase writes (the reference trainer's torch archive: ctx of
    INTERPRET_CTX from a seeded generator beside token_prefix and
    token_suffix): its top INTERPRET_TOPK words a ctx vector against a
    float64 numpy computation on the host over the same token embedding
    (indices equal but where two distances tie within INTERPRET_TIE,
    distances within INTERPRET_REL), no kernel of the repo launched."""
    import numpy as np
    import torch

    from mvlpt_torch.cli import interpret_prompt
    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.ops import _build
    from mvlpt_torch.tokenizer import get_tokenizer
    from mvlpt_torch.train.trainer import load_clip_backbone

    path, card = "interpret_prompt", card_line()
    ckpt = ROOT / "build" / "interpret_prompt" / "prompt_learner" / "model.pth.tar-50"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(0)
    n_ctx, width = INTERPRET_CTX
    ctx = torch.randn(INTERPRET_CTX, generator=gen) * 0.02
    affixes = {"token_prefix": torch.randn((2, 1, width), generator=gen),
               "token_suffix": torch.randn((2, 60, width), generator=gen)}
    torch.save({"state_dict": {"ctx": ctx, **affixes}, "epoch": 50}, str(ckpt))
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    try:
        _free_cuda()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        rows = interpret_prompt.cli([str(ckpt), str(INTERPRET_TOPK)])
        wall = time.perf_counter() - t0
        _launches_of(path, dict(_build.LAUNCHES), (), 0)
        cfg = get_cfg_default()
        cfg.MODEL.BACKBONE.NAME = "ViT-B/16"
        emb = load_clip_backbone(cfg, torch.float32, "cuda")[0]["text"]["token_embedding"]
        emb = emb.cpu().double().numpy()
    finally:
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)
    encoder = get_tokenizer().encoder
    c64 = ctx.double().numpy()
    worst_rel, ties = 0.0, 0
    if len(rows) != 1 or len(rows[0]) != n_ctx:
        raise AssertionError(f"{path}: {len(rows)} context sets of {len(rows[0])} rows")
    for i, row in enumerate(rows[0]):
        d64 = np.sqrt(((emb - c64[i]) ** 2).sum(axis=1))
        want = np.argsort(d64, kind="stable")[:INTERPRET_TOPK]
        got = [encoder[w] for w, _ in row]
        for k, (g, wnt, (_, dist)) in enumerate(zip(got, want, row)):
            rel = abs(dist - d64[g]) / d64[g]
            worst_rel = max(worst_rel, rel)
            if rel > INTERPRET_REL:
                raise AssertionError(f"{path}: ctx[{i}] #{k}: distance {dist} vs float64 "
                                     f"{d64[g]}")
            if g != wnt:
                if abs(d64[g] - d64[wnt]) > INTERPRET_TIE * d64[wnt]:
                    raise AssertionError(f"{path}: ctx[{i}] #{k}: token {g} vs float64's {wnt}")
                ties += 1
    out = dict(path=path, card=card, launches={}, wall_s=wall, ctx=list(INTERPRET_CTX),
               topk=INTERPRET_TOPK, max_rel_err_vs_fp64=worst_rel, ties=ties)
    print(f"{path} [{card}]: {n_ctx} ctx vectors x {emb.shape[0]} tokens, top {INTERPRET_TOPK} in "
          f"{wall:.2f} s (the CLI, the random ViT-B/16 built); distances within {worst_rel:.2e} "
          f"relative of float64's (held at {INTERPRET_REL}), indices equal ({ties} swapped ties)",
          flush=True)
    print("main-path " + json.dumps(out), flush=True)
    return out


# The phases of the optimizers, VPT dropout, FinetuneCLIP, --debug-nans and
# the post-run CLIs. trainer_adamw_dropout runs trainer_cli's flags with
# AdamW and VPT dropout; ADAM_RMS_K is the length of the Adam and RMSprop
# windows checked beside it.
DROPOUT_RATE = 0.1
DROPOUT_OPTS = ["OPTIM.NAME", "adamw", "TRAINER.MVLPT.VPT.DROPOUT", str(DROPOUT_RATE)]
ADAM_RMS_K = 8
# finetune_cli: FinetuneCLIP on one ELEVATER task (cifar-10, 10 classes),
# FT_SHOTS train images a class (a fifth of them carved out as val), FT_TEST
# test images a class, at 224 px, batch 32.
FT_TASK, FT_SHOTS, FT_TEST = "cifar-10", 20, 10
FT_OPTS = ["OPTIM.NAME", "adamw", "OPTIM.STAGED_LR", "True", "OPTIM.BASE_LR_MULT", "0.1",
           "OPTIM.LR", "1e-5", "OPTIM.WARMUP_EPOCH", "0", "OPTIM.MAX_EPOCH", "2",
           "TEST.FINAL_MODEL", "best_val", "DATALOADER.TRAIN_X.BATCH_SIZE", "32"]


class _MaskProbe:
    """Stands in for ``core.layers.keep_mask`` while installed: draws the
    mask as it does and keeps the mask tensors drawn while a CUDA graph is
    being captured, by stream; a replay of that graph rewrites them."""

    def __init__(self):
        from mvlpt_torch.core import layers

        self.layers, self.real, self.captured = layers, layers.keep_mask, {}

    def __call__(self, key, stream, shape, keep):
        import torch

        mask = self.real(key, stream, shape, keep)
        if torch.cuda.is_current_stream_capturing():
            self.captured[stream] = mask
        return mask

    def __enter__(self):
        self.layers.keep_mask = self
        return self

    def __exit__(self, *exc):
        self.layers.keep_mask = self.real


def _kept_share_ok(mask, keep: float) -> bool:
    """Whether the kept share of ``mask`` lies within 5 sigma of ``keep``."""
    n = mask.numel()
    return abs(mask.float().mean().item() - keep) <= 5 * (keep * (1 - keep) / n) ** 0.5


def _window_numbers(timings: list, batch: int = 32) -> dict:
    """The replayed windows' ms a step (host clock and CUDA events, over
    the full-length windows after the first, which captures), img/s, and
    the capture window's peak memory."""
    full = max(t["steps"] for t in timings)
    replayed = [t for t in timings[1:] if t["steps"] == full]
    steps = sum(t["steps"] for t in replayed)
    host = sum(t["host_ms"] for t in replayed) / steps
    dev = sum(t["device_ms"] for t in replayed) / steps
    return dict(ms_per_step=host, device_ms_per_step=dev, img_per_s=batch * 1e3 / host,
                timed_windows=len(replayed), timed_steps=steps,
                peak_mem_gib=timings[0]["peak_gib"])


def drive_trainer_adamw_dropout(sgd_window: dict | None) -> dict:
    """trainer_adamw_dropout: trainer_cli's CLI run (the flagship MVLPT UPT
    at full width on its dataset, windows of 20 and a tail window of 10
    under 'auto', two epochs, best_val) with DROPOUT_OPTS: OPTIM.NAME
    adamw and TRAINER.MVLPT.VPT.DROPOUT 0.1. Holds: one capture, #1-#6
    launched and no other kernel; (a) epoch 2's first window, replayed,
    equal bit for bit to the same window run eagerly (capture=False) from
    the state before it, dropout live; (b) that eager window equal bit for
    bit to one make_train_step call a batch on the window's pre-embedded
    tokens (losses, accuracies, grad norms, prompt leaves); (c) two
    consecutive one-step replays of the run's graph drew different masks,
    each the counter's mask for its step (``layers.keep_mask`` at the
    state's seed and count), each kept share within 5 sigma of 0.9; (d)
    the same eager window under the next seed gives other losses. Then an
    Adam and an RMSprop window of ADAM_RMS_K steps each, replayed from
    their own graphs, held by (a), and timed on a second replay. Prints
    ms/step (host and CUDA events), img/s and peak memory of the AdamW
    windows and of the Adam and RMSprop ones, beside the SGD window of
    train_window_k120[auto] (``sgd_window``), with the card's name and
    power limit."""
    import torch

    from mvlpt_torch.core.layers import dropout_key
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import init_train_state, make_train_step, make_train_step_multi
    from mvlpt_torch.train.train_step import WINDOW_METRICS
    from mvlpt_torch.utils.tree import tree_leaves

    path, card = "trainer_adamw_dropout", card_line()
    data = write_cli_dataset(ROOT / "build" / "trainer_cli_data")
    out_dir = ROOT / "build" / "trainer_adamw_dropout_out"
    common = ["--root", str(data), "--trainer", "MVLPT", "--dataset-coop",
              "--dataset", "OxfordPets", "--shots", str(CLI_SHOTS), "--seed", "1",
              "--cut-contextlen",
              "--config-file", str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml")]
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    os.environ.pop("MVLPT_TPU_RANDOM_CLIP_ARCH", None)
    os.environ.pop("MVLPT_TPU_CLIP_CKPT", None)
    try:
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        # windows 0-2 are epoch 1's, 3 epoch 2's first (replayed, kept)
        probe = _TimedWindowProbe(make_train_step_multi, keep=3, copies=(3,))
        t0 = time.perf_counter()
        with _MaskProbe() as masks:
            trainer = _cli_probed([*common, "--output-dir", str(out_dir / "train"), *CLI_OPTS,
                                   *DROPOUT_OPTS, "OPTIM.MAX_EPOCH", "2"], probe)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)

    sizes = [int(m["loss"].shape[0]) for m in probe.windows]
    if len(probe.steps) != 1 or probe.steps[0].captures != 1 or sizes != [20, 20, 10] * 2:
        raise AssertionError(f"{path}: {[s.captures for s in probe.steps]} captures, windows "
                             f"{sizes}: want one capture and [20, 20, 10] an epoch")
    want = ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd", "attn_fwd_infer", "mlp_fwd_infer")
    missing = [name for name in want if not launches.get(name)]
    others = {name: n for name, n in launches.items() if n and name not in want}
    if missing or others:
        raise AssertionError(f"{path}: launches {launches}: {missing} not launched, "
                             f"{others} launched")
    if trainer.state.opt.kind != "adam" or trainer.spec.vpt_dropout != DROPOUT_RATE:
        raise AssertionError(f"{path}: optimizer {trainer.state.opt.kind}, dropout "
                             f"{trainer.spec.vpt_dropout}")
    model, backbone, consts = trainer.model, trainer.backbone, trainer.consts
    norm, ocfg, spe = trainer._normalize, trainer.cfg.OPTIM, trainer.steps_per_epoch
    before, after = probe.states[3]
    kept = probe.kept
    k = int(kept["label"].shape[0])

    def state_at(copy, opt_cfg=None):
        """A new state holding ``copy``: all of it, or under another
        optimizer ``opt_cfg`` its prompt leaves and seed, the optimizer
        fresh."""
        st = init_train_state(trainer.state.prompt_params, opt_cfg or ocfg, spe)
        if opt_cfg is None:
            _restore(st, copy)
            return st
        with torch.no_grad():
            for dst, src in zip(tree_leaves(st.prompt_params), copy[0]):
                dst.copy_(src)
            st.seed.copy_(copy[2])
        return st

    # (a) the replayed window against the same window run eagerly
    eager = make_train_step_multi(model, trainer.task_ranges, pre_embed=True, normalize=norm,
                                  capture=False)
    eager_state = state_at(before)
    _, eager_m = eager(eager_state, backbone, consts, kept)
    _equal_windows(path, "(a) the replayed window against the eager window", probe.windows[3],
                   eager_m, after[0], tree_leaves(eager_state.prompt_params))
    # (b) the eager window against one step a call on its pre-embedded tokens
    step_state = state_at(before)
    step = make_train_step(model, trainer.task_ranges, pre_embedded=True)
    with torch.no_grad():
        tokens = model.embed_image(backbone, kept["image"].flatten(0, 1), normalize=norm)
    tokens = tokens.unflatten(0, kept["image"].shape[:2])
    per_step = [step(step_state, backbone, consts, {"image": tokens[i], "label": kept["label"][i]})
                [1] for i in range(k)]
    stacked = {name: torch.stack([m[name] for m in per_step]) for name in WINDOW_METRICS}
    _equal_windows(path, "(b) the eager window against one step a call", eager_m, stacked,
                   tree_leaves(eager_state.prompt_params), tree_leaves(step_state.prompt_params))
    # (d) the next seed: other losses
    seed_state = state_at(before)
    seed_state.seed.add_(1)
    _, seed_m = eager(seed_state, backbone, consts, kept)
    if torch.equal(seed_m["loss"], eager_m["loss"]):
        raise AssertionError(f"{path}: (d) a second seed gave the same losses")
    del eager_state, step_state, seed_state, tokens

    # (c) two consecutive one-step replays of the run's graph, their masks
    if sorted(masks.captured) != [0, 1]:
        raise AssertionError(f"{path}: the capture drew masks of streams {sorted(masks.captured)}")
    graph_step, graph_state = probe.steps[0], probe.state
    _restore(graph_state, before)
    drawn = []
    for i in range(2):
        seed, count = graph_state.seed.clone(), graph_state.opt.count.clone()
        replays = graph_step.replays
        with masks:  # a replay draws in the graph, past the probe
            graph_step(graph_state, backbone, consts, {n: t[i:i + 1] for n, t in kept.items()})
        if graph_step.replays != replays + 1 or graph_step.captures != 1:
            raise AssertionError(f"{path}: (c) a one-step window did not replay the graph")
        got = {s: m.clone() for s, m in masks.captured.items()}
        key = dropout_key(seed, count)
        for s, m in got.items():
            want_m = masks.real(key, s, tuple(m.shape), 1 - DROPOUT_RATE)
            if not torch.equal(m, want_m):
                raise AssertionError(f"{path}: (c) replay {i}'s stream-{s} mask is not the "
                                     f"counter's mask of its step")
            if not _kept_share_ok(m, 1 - DROPOUT_RATE):
                raise AssertionError(f"{path}: (c) replay {i}'s stream-{s} kept share "
                                     f"{m.float().mean().item()} outside 5 sigma of 0.9")
        drawn.append(got)
    if any(torch.equal(drawn[0][s], drawn[1][s]) for s in (0, 1)):
        raise AssertionError(f"{path}: (c) two consecutive replayed steps drew the same mask")
    shares = [[round(m.float().mean().item(), 4) for m in d.values()] for d in drawn]

    # Adam and RMSprop: a window each from its own graph against its eager self
    other = {}
    for name in ("adam", "rmsprop"):
        opt_cfg = ocfg.clone()
        opt_cfg.NAME = name
        window = {n: t[:ADAM_RMS_K] for n, t in kept.items()}
        graph = make_train_step_multi(model, trainer.task_ranges, pre_embed=True, normalize=norm)
        g_state = state_at(before, opt_cfg)
        e_state = state_at(before, opt_cfg)
        timings = []
        for _ in range(2):
            g0 = [t.detach().clone() for t in tree_leaves(g_state.prompt_params)]
            host, dev, g_m = _timed_window(graph, g_state, backbone, consts, window)
            timings.append(dict(steps=ADAM_RMS_K, host_ms=host, device_ms=dev,
                                peak_gib=_peak_gib()))
            _, e_m = eager(e_state, backbone, consts, window)
            _equal_windows(f"{path}[{name}]", "(a) the replayed window against the eager window",
                           g_m, e_m, tree_leaves(g_state.prompt_params),
                           tree_leaves(e_state.prompt_params))
            if all(torch.equal(a, b) for a, b in zip(g0, tree_leaves(g_state.prompt_params))):
                raise AssertionError(f"{path}[{name}]: the window moved no prompt leaf")
        if graph.captures != 1:
            raise AssertionError(f"{path}[{name}]: {graph.captures} captures")
        other[name] = dict(_window_numbers(timings), losses=e_m["loss"].tolist())
        del graph, g_state, e_state
        _free_cuda()

    results = _results_of(out_dir / "train" / "log.txt")
    losses = torch.cat([m["loss"] for m in probe.windows])
    if not bool(torch.isfinite(losses).all()) or not results or "accuracy" not in results[-1]:
        raise AssertionError(f"{path}: a loss not finite, or no results line")
    adamw = _window_numbers(probe.timings)
    sgd = {key: sgd_window[key] for key in ("ms_per_step", "device_ms_per_step", "img_per_s",
                                            "peak_mem_gib")} if sgd_window else None
    out = dict(path=path, card=card, run_s=run_s, windows=sizes,
               captures=probe.steps[0].captures, replays=probe.steps[0].replays,
               launches={key: v for key, v in launches.items() if v}, **adamw,
               adam=other["adam"], rmsprop=other["rmsprop"], sgd_window_k120=sgd,
               replay_equals_eager=True, eager_equals_per_step=True,
               replayed_mask_kept_shares=shares, second_seed_differs=True,
               first_losses=probe.windows[0]["loss"][:4].tolist(), results=results[-1])
    print(f"{path} [{card}]: AdamW + dropout {adamw['ms_per_step']:.2f} ms/step host, "
          f"{adamw['device_ms_per_step']:.2f} device, {adamw['img_per_s']:.1f} img/s, peak "
          f"{adamw['peak_mem_gib']:.2f} GiB; Adam {other['adam']['ms_per_step']:.2f}, RMSprop "
          f"{other['rmsprop']['ms_per_step']:.2f} ms/step (windows of {ADAM_RMS_K}); SGD "
          f"k120 {sgd and sgd['ms_per_step']}", flush=True)
    print("main-path " + json.dumps(out), flush=True)
    return out


def drive_debug_nans() -> dict:
    """debug_nans: the CLI's --debug-nans on trainer_cli's flags (--no-train,
    so the CLI builds the trainer and turns the checks on), then its
    per-step train step on a float batch of 32 with one NaN pixel: it must
    raise FloatingPointError naming the step, and leave the state; the same
    batch without the NaN then runs, to a finite loss. The mode is turned
    off after."""
    import numpy as np
    import torch

    from mvlpt_torch.ops import _build
    from mvlpt_torch.utils import profiler

    path, card = "debug_nans", card_line()
    data = write_cli_dataset(ROOT / "build" / "trainer_cli_data")
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    try:
        _free_cuda()
        trainer, _ = _cli_run(["--debug-nans", "--no-train", "--root", str(data), "--trainer",
                               "MVLPT", "--dataset-coop", "--dataset", "OxfordPets", "--shots",
                               str(CLI_SHOTS), "--seed", "1", "--cut-contextlen",
                               "--output-dir", str(ROOT / "build" / "debug_nans_out"),
                               "--config-file",
                               str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml"),
                               *CLI_OPTS])
        if not (profiler.nan_debugging() and torch.is_anomaly_enabled()):
            raise AssertionError(f"{path}: --debug-nans did not turn the checks on")
        rng = np.random.RandomState(5)
        size = trainer.cfg.INPUT.SIZE[0]
        image = rng.randn(32, size, size, 3).astype(np.float32)
        batch = {"image": torch.from_numpy(image).cuda(),
                 "label": torch.from_numpy(rng.randint(0, CLI_CLASSES, 32)).cuda()}
        nan_batch = dict(batch, image=batch["image"].clone())
        nan_batch["image"][7, size // 2, size // 4, 1] = float("nan")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        raised = None
        try:
            trainer.train_step(trainer.state, trainer.backbone, trainer.consts, nan_batch)
        except FloatingPointError as e:
            raised = str(e)
        if raised is None or not raised.startswith("step 1:") or trainer.state.step != 0:
            raise AssertionError(f"{path}: the NaN step raised {raised!r}, state at step "
                                 f"{trainer.state.step}")
        _, metrics = trainer.train_step(trainer.state, trainer.backbone, trainer.consts, batch)
        loss = metrics["loss"].item()
        step_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        if not math.isfinite(loss) or trainer.state.step != 1:
            raise AssertionError(f"{path}: the clean step's loss {loss}, step {trainer.state.step}")
    finally:
        profiler.enable_nan_debugging(False)
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)
    out = dict(path=path, card=card, raised=raised, clean_loss=loss, steps_s=step_s,
               launches={k: v for k, v in launches.items() if v})
    print(f"{path} [{card}]: the NaN step raised FloatingPointError ({raised}); the clean step "
          f"ran, loss {loss:.4f}", flush=True)
    print("main-path " + json.dumps(out), flush=True)
    return out


def drive_post_run() -> dict:
    """post_run: the post-run CLIs on the phases' output directories:
    ``avg_ckpt`` over trainer_cli's and trainer_adamw_dropout's prompt
    directories (the same prompt tree) into build/post_run_out/avg,
    ``export_ckpt`` of the average to a torch archive (every leaf equal to
    the average's, transposed where the reference's names take it so, and
    the mean of the two runs' leaves), an ``--eval-only`` run of the CLI on
    the average (#5 and #6 launched, no other kernel, a finite results
    line), and ``parse_test_res`` over the runs' directories (its mean of
    their final results, n of them)."""
    import numpy as np
    import torch

    from mvlpt_torch.checkpoint import prompt_io
    from mvlpt_torch.cli import avg_ckpt, export_ckpt, parse_test_res
    from mvlpt_torch.ops import _build

    path, card = "post_run", card_line()
    runs = [ROOT / "build" / "trainer_cli_out" / "train",
            ROOT / "build" / "trainer_adamw_dropout_out" / "train"]
    out_dir = ROOT / "build" / "post_run_out"
    t0 = time.perf_counter()
    avg_ckpt.cli(["--dirs", *map(str, runs), "--output-dir", str(out_dir / "avg")])
    avg = prompt_io.load_prompt_checkpoint(prompt_io.checkpoint_path(str(out_dir / "avg")))
    sources = [prompt_io.load_prompt_checkpoint(prompt_io.checkpoint_path(str(r))) for r in runs]
    for key, value in avg["state_dict"].items():
        mean = np.mean([s["state_dict"][key].astype(np.float64) for s in sources], axis=0)
        if not np.array_equal(value, mean.astype(value.dtype)):
            raise AssertionError(f"{path}: the average's {key} is not the runs' mean")
    archive = out_dir / "avg.pth.tar"
    export_ckpt.cli(["--input", str(out_dir / "avg"), "--output", str(archive)])
    exported = prompt_io.load_prompt_checkpoint(str(archive))["state_dict"]
    if exported.keys() != avg["state_dict"].keys() or any(
            not np.array_equal(exported[k], avg["state_dict"][k]) for k in exported):
        raise AssertionError(f"{path}: the exported archive does not read back as the average")
    cli_s = time.perf_counter() - t0
    data = write_cli_dataset(ROOT / "build" / "trainer_cli_data")
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    try:
        _free_cuda()
        _build.reset_launch_counts()
        t1 = time.perf_counter()
        evaluated, _ = _cli_run(["--root", str(data), "--trainer", "MVLPT", "--dataset-coop",
                                 "--dataset", "OxfordPets", "--shots", str(CLI_SHOTS), "--seed",
                                 "1", "--cut-contextlen", "--config-file",
                                 str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml"),
                                 "--output-dir", str(out_dir / "eval"), "--eval-only",
                                 "--model-dir", str(out_dir / "avg"), *CLI_OPTS])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t1
        launches = dict(_build.LAUNCHES)
    finally:
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)
    if not launches.get("attn_fwd_infer"):
        raise AssertionError(f"{path}: the --eval-only run launched {launches}")
    _launches_of(path, launches, ("attn_fwd_infer", "mlp_fwd_infer"), launches["attn_fwd_infer"])
    loaded = prompt_io.flatten_params(evaluated.state.prompt_params)
    if any(not np.array_equal(loaded[k], avg["state_dict"][k]) for k in avg["state_dict"]):
        raise AssertionError(f"{path}: the --eval-only run did not load the average")
    eval_results = _results_of(out_dir / "eval" / "log.txt")
    dirs = [str(d) for d in (*runs, out_dir / "eval")]
    summary = parse_test_res.aggregate(dirs)
    finals = [parse_test_res.final_metrics(d) for d in dirs]
    if (not eval_results or not all(math.isfinite(v) for v in eval_results[-1].values())
            or summary.get("accuracy", {}).get("n") != len(dirs)
            or not math.isclose(summary["accuracy"]["mean"],
                                sum(f["accuracy"] for f in finals) / len(dirs))):
        raise AssertionError(f"{path}: results {eval_results[-1:]}, parse_test_res {summary}")
    out = dict(path=path, card=card, averaged=[str(r) for r in runs], cli_s=cli_s,
               eval_s=eval_s, eval_results=eval_results[-1], parse_test_res=summary,
               launches={k: v for k, v in launches.items() if v}, peak_mem_gib=_peak_gib())
    print(f"{path} [{card}]: avg_ckpt + export_ckpt {cli_s:.2f} s; --eval-only on the average "
          f"{eval_s:.2f} s ({eval_results[-1]}); parse_test_res {summary}", flush=True)
    print("main-path " + json.dumps(out), flush=True)
    return out


def drive_finetune_cli() -> dict:
    """finetune_cli: ``--trainer FinetuneCLIP`` through the port's CLI on
    FT_TASK (written by ``write_elevater_dataset``), a random ViT-B/16 at
    full width, configs/trainers/MVLPT/vit_b16_tpu_fast.yaml with FT_OPTS
    (224 px, batch 32, AdamW, STAGED_LR with BASE_LR_MULT 0.1, two epochs,
    best_val). Holds: per-batch steps (the windowed-dispatch message
    printed), none of the repo's kernels launched (the plain path, as in
    the JAX package), a finite loss every step, the first step's bf16 loss
    within 1e-2 of an fp32 step's on the same batch and weights, the
    checkpoints written, and an --eval-only rerun's test logits bit-equal
    to the run's own. Prints ms/step (host and CUDA events, the first
    step left out), img/s, peak memory and the parameter count."""
    import torch

    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import finetune
    from mvlpt_torch.train.train_step import soft_cross_entropy
    from mvlpt_torch.utils.tree import tree_leaves

    path, card = "finetune_cli", card_line()
    data = write_elevater_dataset(ROOT / "build" / "finetune_data", tasks=[FT_TASK],
                                  test=FT_TEST, shots=FT_SHOTS)
    out_dir = ROOT / "build" / "finetune_out"
    common = ["--root", str(data), "--trainer", "FinetuneCLIP", "--dataset", FT_TASK,
              "--shots", str(FT_SHOTS), "--seed", "1", "--config-file",
              str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml")]
    probe = _TimedStepProbe(finetune.make_finetune_step)
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    finetune.make_finetune_step = probe
    try:
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        trainer, _ = _cli_run([*common, "--output-dir", str(out_dir / "train"), *FT_OPTS])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        peak = _peak_gib()
        logits = _test_logits(trainer)
        # the first step's bf16 loss against fp32 on the same batch and weights
        batch, params = probe.first
        model32 = finetune.FinetuneModel(trainer.clip_cfg, torch.float32,
                                         trainer.model.normalize)
        with torch.no_grad():
            loss32 = soft_cross_entropy(model32({}, params, None, batch["image"]),
                                        batch["label"]).item()
        del trainer, params, batch
        probe.first = None
        _free_cuda()
        evaluated, _ = _cli_run([*common, "--output-dir", str(out_dir / "eval"), "--eval-only",
                                 "--model-dir", str(out_dir / "train"), *FT_OPTS])
        logits_again = _test_logits(evaluated)
        n_params = sum(t.numel() for t in tree_leaves(evaluated.state.prompt_params))
        del evaluated
    finally:
        finetune.make_finetune_step = probe.make
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)
    if launches:
        raise AssertionError(f"{path}: launched {launches}: the fine-tune path is plain")
    log = (out_dir / "train" / "log.txt").read_text()
    if "FinetuneCLIP: TRAIN.STEPS_PER_DISPATCH=120 ignored" not in log:
        raise AssertionError(f"{path}: no windowed-dispatch message in log.txt")
    losses = [m["loss"].item() for m in probe.metrics]
    if len(losses) < 4 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{path}: losses {losses}")
    _near(path, "first bf16 loss against fp32", losses[0], loss32)
    for name in ("model-best.pth.tar", "model.pth.tar-2"):
        if not (out_dir / "train" / "prompt_learner" / name).is_file():
            raise AssertionError(f"{path}: no prompt_learner/{name}")
    results = _results_of(out_dir / "train" / "log.txt")
    if not torch.equal(logits, logits_again) or not results:
        raise AssertionError(f"{path}: the --eval-only rerun's test logits differ")
    if logits.shape != (10 * FT_TEST, 10) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{path}: test logits {tuple(logits.shape)}, or not finite")
    timed = probe.timings[1:]
    host = sum(t[0] for t in timed) / len(timed)
    dev = sum(t[1] for t in timed) / len(timed)
    out = dict(path=path, card=card, run_s=run_s, steps=len(losses), params=n_params,
               ms_per_step=host, device_ms_per_step=dev, img_per_s=32e3 / host,
               peak_mem_gib=peak, first_loss=losses[0], first_loss_fp32=loss32,
               losses=losses, results=results[-1], launches=launches,
               eval_only_logits_equal=True)
    print(f"{path} [{card}]: {n_params / 1e6:.1f}M params, {len(losses)} steps, {host:.2f} "
          f"ms/step host, {dev:.2f} device, {out['img_per_s']:.1f} img/s, peak {peak:.2f} "
          f"GiB; first loss {losses[0]:.5f} (fp32 {loss32:.5f})", flush=True)
    print("main-path " + json.dumps(out), flush=True)
    return out



# ---------------------------------------------------------------- the mesh
#
# mesh_cli (``drive_mesh_cli``): trainer_cli's data, flags and random
# ViT-B/16 through ``mvlpt_torch.cli.train.main`` as two ranks that share
# the card (torchrun's variables; gloo, since NCCL refuses two ranks on one
# device), on each MESH_CLI_RUNS mesh, then on one rank as the reference.
# Cut to fit its time: MESH_CLI_SHOTS shots (12 steps of 32, one window of
# 12), one epoch, best_val on the 200 val and 400 test images.
MESH_CLI_SHOTS = 4
MESH_CLI_RUNS = {"data": ("TPU.MESH_DATA", "2"),
                 "model": ("TPU.MESH_MODEL", "2", "TPU.MESH_DATA", "1")}
MESH_RANKS = 2
MESH_TIMEOUT_S = 480
# The mesh runs' test logits against the single rank's: max|difference| at
# most MESH_LOGIT_REL x max|logit| (PERF.md §6, written before the first
# run). Their accuracies differ by at most MESH_ACC_PP points, and
# by no more than the share of test images whose single-rank top-2 margin
# is under twice that difference (an argmax moves only where the margin
# is below it).
MESH_LOGIT_REL, MESH_ACC_PP = 0.05, 2.0
POD_CHECK_TIMEOUT_S = 420


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_cli_argv(data: Path, out_dir: Path, opts=()) -> list:
    return ["--root", str(data), "--trainer", "MVLPT", "--dataset-coop", "--dataset",
            "OxfordPets", "--shots", str(MESH_CLI_SHOTS), "--seed", "1", "--cut-contextlen",
            "--config-file", str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml"),
            "--output-dir", str(out_dir), *CLI_OPTS, "OPTIM.MAX_EPOCH", "1", *opts]


def _mesh_cli_rank(rank: int, world: int, workdir: str, ports: list) -> None:
    """One rank of mesh_cli, in its own spawned process: for each run of
    ``runs.json`` (name, argv, output dir), torchrun's variables for this
    rank (MASTER_PORT a new free port a run) and ``cli.train.main`` on the
    card, which joins the ranks and leaves the group at its end. Records
    each window's metrics and host time (the card synchronized at both
    ends) and the time in ``dist.all_reduce`` within it, the launch counts
    of training and of test(), the final test()'s logits (computed after
    it, uncounted), the trainer's epoch timings, the peak memory, the
    paths it wrote under the output dir and the ``results`` lines it
    printed. Writes rank{rank}.json and rank{rank}.pt, or rank{rank}.err
    with the traceback."""
    import traceback

    work = Path(workdir)
    try:
        import torch
        import torch.distributed as dist

        from mvlpt_torch.cli import train as cli_mod
        from mvlpt_torch.ops import _build
        from mvlpt_torch.train import trainer as trainer_mod

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        runs = json.loads((work / "runs.json").read_text())
        write_probe = _test_helpers().WriteProbe
        report, logits = {}, {}
        make, test, all_reduce = (trainer_mod.make_train_step_multi,
                                  trainer_mod.PromptTrainer.test, dist.all_reduce)
        for (name, argv, out_dir), port in zip(runs, ports):
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                              LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(port), MVLPT_TPU_RANDOM_CLIP="1")
            windows, reduce_s, tests = [], [0.0], []
            end = {}

            def timed_all_reduce(*a, **k):
                t0 = time.perf_counter()
                try:
                    return all_reduce(*a, **k)
                finally:
                    reduce_s[0] += time.perf_counter() - t0

            def probed(*a, **k):
                step = make(*a, **k)

                def call(*sa, **sk):
                    torch.cuda.synchronize()
                    r0, t0 = reduce_s[0], time.perf_counter()
                    state, m = step(*sa, **sk)
                    torch.cuda.synchronize()
                    ms = 1e3 * (time.perf_counter() - t0)
                    windows.append(dict(k=int(m["loss"].shape[0]), ms=ms,
                                        all_reduce_ms=1e3 * (reduce_s[0] - r0),
                                        loss=m["loss"].tolist(), grad_norm=m["grad_norm"].tolist()))
                    return state, m
                probed.steps.append(step)
                return call
            probed.steps = []

            def tested(self, split=None):
                before = dict(_build.LAUNCHES)
                result = test(self, split)
                after = dict(_build.LAUNCHES)
                tests.append({k: after.get(k, 0) - before.get(k, 0) for k in after})
                end.update(after)
                if split in (None, "test"):
                    logits[name] = _test_logits(self).cpu()
                return result

            trainer_mod.make_train_step_multi, trainer_mod.PromptTrainer.test = probed, tested
            dist.all_reduce = timed_all_reduce
            saved = sys.stdout
            log = work / f"{name}.rank{rank}.out"
            try:
                with open(log, "w") as f, write_probe(out_dir) as writes:
                    sys.stdout = f
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    _build.reset_launch_counts()
                    t0 = time.perf_counter()
                    trainer = cli_mod.main(cli_mod.build_parser().parse_args(argv))
                    run_s = time.perf_counter() - t0
            finally:
                sys.stdout = saved
                trainer_mod.make_train_step_multi, trainer_mod.PromptTrainer.test = make, test
                dist.all_reduce = all_reduce
            in_tests = {k: sum(t.get(k, 0) for t in tests) for k in end}
            report[name] = dict(
                run_s=run_s, windows=windows, captures=[s.captures for s in probed.steps],
                launches_train={k: v - in_tests[k] for k, v in end.items() if v - in_tests[k]},
                launches_test={k: v for k, v in in_tests.items() if v},
                epochs=trainer.timings["epochs"], tests=trainer.timings["tests"],
                peak_mem_gib=_peak_gib(), writes=sorted(set(writes.paths)),
                results=[line[len("results "):].strip() for line in log.read_text().splitlines()
                         if line.startswith("results ")])
            del trainer
            _free_cuda()
        (work / f"rank{rank}.json").write_text(json.dumps(report))
        torch.save(logits, work / f"rank{rank}.pt")
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _logit_bound(path: str, what: str, got, ref) -> dict:
    """``got`` test logits against the reference ``ref`` (the single rank's):
    max|difference| held at MESH_LOGIT_REL x max|ref|; the test images whose
    reference top-2 margin is under twice it (the only ones whose argmax
    can move), and the accuracy bound, in percentage points: their share,
    at most MESH_ACC_PP."""
    import torch

    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{path}: {what} logits {tuple(got.shape)} against "
                             f"{tuple(ref.shape)}, or not finite")
    diff = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    top2 = ref.float().topk(2, dim=1).values
    near = int(((top2[:, 0] - top2[:, 1]) < 2 * diff).sum())
    out = dict(max_abs_diff=diff, max_abs_ref=scale, near_rows=near,
               acc_bound_pp=min(MESH_ACC_PP, 100.0 * near / ref.shape[0]))
    if not diff <= MESH_LOGIT_REL * scale:
        raise AssertionError(f"{path}: {what} test logits differ from one rank's by {diff}, "
                             f"over {MESH_LOGIT_REL} x {scale}")
    return out


def drive_mesh_cli() -> dict:
    """mesh_cli: the training CLI under a mesh as two ranks on the one card
    (``_mesh_cli_rank``), on trainer_cli's dataset at full ViT-B/16 width
    (bf16, MVLPT UPT, vit_b16_tpu_fast.yaml, windows on), once for each of
    MESH_CLI_RUNS, then the same argv on one rank in this process, and an
    --eval-only run of the single-rank CLI from the data-axis run's rank 0
    directory. Holds: every rank exits 0; only rank 0 wrote files; both
    ranks print the same results lines; the first window's first loss and
    grad norm within TP_REL (bf16) of the single rank's; the final test's
    logits and accuracy within the bound of ``_logit_bound`` (so is the
    --eval-only run's); the windows run eagerly (no capture); on the data
    axis only #1-#4 launch in training, 24 a step each, and only #5/#6 in
    test(); on the model axis only #7-#10 in training, 24 a step each, and
    only #7/#9 in test(). Prints each rank's step ms, img/s with the
    loading, the share of the windows' time in dist.all_reduce and peak
    memory, with the card's name and power limit: two ranks time-slice one
    card and all-reduce through host memory, so these are no scaling
    figures."""
    import ast
    import shutil

    import torch
    import torch.multiprocessing as mp

    path, card = "mesh_cli", card_line()
    data = write_cli_dataset(ROOT / "build" / "trainer_cli_data")
    work = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    runs = [[name, _mesh_cli_argv(data, work / name, opts), str(work / name)]
            for name, opts in MESH_CLI_RUNS.items()]
    (work / "runs.json").write_text(json.dumps(runs))
    ports = [_free_port() for _ in runs]
    _free_cuda()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mesh_cli_rank, args=(r, MESH_RANKS, str(work), ports))
             for r in range(MESH_RANKS)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    try:
        for proc in procs:
            proc.join(max(1.0, MESH_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    errs = {r: (work / f"rank{r}.err").read_text() for r in range(MESH_RANKS)
            if (work / f"rank{r}.err").is_file()}
    if hung or errs or any(proc.exitcode != 0 for proc in procs):
        raise AssertionError(f"{path}: ranks still running after {MESH_TIMEOUT_S} s: {hung}; "
                             f"exit codes {[proc.exitcode for proc in procs]}; errors {errs}")
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(MESH_RANKS)]
    logits = [torch.load(work / f"rank{r}.pt", weights_only=True) for r in range(MESH_RANKS)]

    # The single rank, then --eval-only from the data-axis run's directory.
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    try:
        single, probe = _cli_run(_mesh_cli_argv(data, work / "single"))
        ref_logits = _test_logits(single)
    finally:
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)
    ref_results = _results_of(work / "single" / "log.txt")
    ref_first = {k: probe.windows[0][k][0].item() for k in ("loss", "grad_norm")}
    steps = int(probe.windows[0]["loss"].shape[0])
    del single
    _free_cuda()
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    try:
        ev, _ = _cli_run(["--eval-only", "--model-dir", str(work / "data")]
                         + _mesh_cli_argv(data, work / "eval_only"))
        eval_logits = _test_logits(ev)
    finally:
        os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)
    del ev
    eval_results = _results_of(work / "eval_only" / "log.txt")
    _free_cuda()

    want_train = {"data": ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd"), "model": TP_KERNELS}
    want_test = {"data": ("attn_fwd_infer", "mlp_fwd_infer"),
                 "model": ("attn_fwd_tp", "mlp_fwd_tp")}
    from mvlpt_torch.core.clip import CLIPConfig

    vit = CLIPConfig.for_backbone("ViT-B/16")
    layers = vit.vision_layers + vit.transformer_layers  # blocks a step, each tower's
    out = dict(path=path, card=card, ranks_wall_s=ranks_s, steps=steps,
               single=dict(first=ref_first, results=ref_results[-1]), runs={},
               launches={})
    for name in MESH_CLI_RUNS:
        got = [r[name] for r in ranks]
        res = [[ast.literal_eval(x) for x in g["results"]] for g in got]
        if not res[0] or res[0] != res[1]:
            raise AssertionError(f"{path} {name}: results lines {got[0]['results']} and "
                                 f"{got[1]['results']} of the two ranks")
        if got[1]["writes"]:
            raise AssertionError(f"{path} {name}: rank 1 wrote {got[1]['writes']}")
        for rel in ("log.txt", "prompt_learner/model-best.pth.tar"):
            if str(work / name / rel) not in got[0]["writes"]:
                raise AssertionError(f"{path} {name}: rank 0 did not write {rel}")
        for r, g in enumerate(got):
            if any(g["captures"]) or [w["k"] for w in g["windows"]] != [steps]:
                sizes = [w["k"] for w in g["windows"]]
                raise AssertionError(f"{path} {name} rank {r}: windows {sizes}, captures "
                                     f"{g['captures']}; want one eager window of {steps}")
            if g["launches_train"] != {k: layers * steps for k in want_train[name]}:
                raise AssertionError(f"{path} {name} rank {r}: training launches "
                                     f"{g['launches_train']}, want {layers * steps} of each of "
                                     f"{want_train[name]}")
            if set(g["launches_test"]) != set(want_test[name]):
                raise AssertionError(f"{path} {name} rank {r}: test() launches "
                                     f"{g['launches_test']}, want {want_test[name]}")
        first = {k: got[0]["windows"][0][k][0] for k in ("loss", "grad_norm")}
        for what in ("loss", "grad_norm"):
            rel = TP_REL["bfloat16"][what]
            if not (math.isfinite(first[what])
                    and abs(first[what] - ref_first[what]) <= rel * abs(ref_first[what])):
                raise AssertionError(f"{path} {name}: rank 0's first {what} {first[what]} vs one "
                                     f"rank's {ref_first[what]} ({rel} relative)")
        bound = _logit_bound(f"{path} {name}", "rank 0's", logits[0][name], ref_logits)
        if not torch.equal(logits[0][name], logits[1][name]):
            raise AssertionError(f"{path} {name}: the two ranks' test logits differ")
        acc, acc_ref = res[0][-1]["accuracy"], ref_results[-1]["accuracy"]
        if not abs(acc - acc_ref) <= bound["acc_bound_pp"] + 1e-9:
            raise AssertionError(f"{path} {name}: test accuracy {acc} vs one rank's {acc_ref}, "
                                 f"over the {bound['acc_bound_pp']} points of {bound['near_rows']} "
                                 "near rows")
        win = [g["windows"][0] for g in got]
        epochs = [g["epochs"][0] for g in got]
        row = out["runs"][name] = dict(
            results=res[0][-1], first=first, logits=bound,
            step_ms=[w["ms"] / w["k"] for w in win],
            all_reduce_share=[w["all_reduce_ms"] / w["ms"] for w in win],
            img_per_s_with_loading=[e["images"] / e["wall_s"] for e in epochs],
            peak_mem_gib=[g["peak_mem_gib"] for g in got], run_s=[g["run_s"] for g in got],
            launches_train=got[0]["launches_train"], launches_test=got[0]["launches_test"],
            writes_rank0=len(got[0]["writes"]))
        train, test = got[0]["launches_train"], got[0]["launches_test"]
        out["launches"][name] = {k: train.get(k, 0) + test.get(k, 0)
                                 for k in set(train) | set(test)}
        print(f"{path} {name} [{card}]: two ranks time-slice this card over gloo (all-reduces "
              f"through host memory; no scaling figure): step "
              f"{', '.join(f'{x:.1f}' for x in row['step_ms'])} ms a rank (an eager window of "
              f"{steps}), {', '.join(f'{100 * x:.1f}%' for x in row['all_reduce_share'])} of it in "
              f"dist.all_reduce; {', '.join(f'{x:.1f}' for x in row['img_per_s_with_loading'])} "
              f"img/s with the loading a rank (of its rows); peak "
              f"{', '.join(f'{x:.2f}' for x in row['peak_mem_gib'])} GiB a rank; first loss "
              f"{first['loss']:.6f} (one rank {ref_first['loss']:.6f}), grad norm "
              f"{first['grad_norm']:.6f} ({ref_first['grad_norm']:.6f}); test logits max|diff| "
              f"{bound['max_abs_diff']:.4g} of max {bound['max_abs_ref']:.4g}, accuracy {acc} "
              f"(one rank {acc_ref}; bound {bound['acc_bound_pp']:.2f} points)", flush=True)
    bound = _logit_bound(f"{path} --eval-only", "the --eval-only run's", eval_logits,
                         logits[0]["data"])
    acc_eval = eval_results[-1]["accuracy"]
    acc_data = out["runs"]["data"]["results"]["accuracy"]
    if not abs(acc_eval - acc_data) <= bound["acc_bound_pp"] + 1e-9:
        raise AssertionError(f"{path}: --eval-only of rank 0's checkpoint gives {acc_eval}, rank "
                             f"0's run {acc_data} (bound {bound['acc_bound_pp']} points)")
    out["eval_only"] = dict(results=eval_results[-1], logits=bound,
                            results_equal=eval_results[-1] == out["runs"]["data"]["results"])
    print(f"{path}: --eval-only on one rank from the data-axis run's rank 0 checkpoint: "
          f"{eval_results[-1]} (rank 0 {out['runs']['data']['results']}; logits max|diff| "
          f"{bound['max_abs_diff']:.4g})", flush=True)
    print("main-path " + json.dumps(out), flush=True)
    return out


def drive_pod_loss_check() -> dict:
    """scripts/torch_port_pod_loss_check.py on the card: a (1, 2) mesh of two
    ranks sharing it, ViT-B/16 in bf16, 3 SGD steps under 'on' then 'off',
    every rank's per-step losses within TP_REL's loss bound of one rank's.
    Under 'on' every rank launches #11/#12 alone, its image rows 32 x 6
    heads (H/tp); under 'off' none of the 12 launches. Prints each rank's
    step ms, the share in dist.all_reduce and peak memory, with the card's
    name and power limit."""
    import subprocess

    path, card = "pod_loss_check", card_line()
    out_json = ROOT / "build" / "pod_loss_check.json"
    cmd = [sys.executable, str(ROOT / "scripts" / "torch_port_pod_loss_check.py"), "--mesh",
           "1,2", "--backbone", "b16", "--kernels", "on", "off", "--steps", "3", "--tol", "0",
           "--rtol", str(TP_REL["bfloat16"]["loss"]), "--out", str(out_json), "--workdir",
           str(ROOT / "build" / "pod_loss_check")]
    _free_cuda()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=POD_CHECK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{path}: exit {proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(out_json.read_text())
    out = dict(path=path, card=card, wall_s=wall, checks={}, launches={})
    for check in line["checks"]:
        sel, ranks = check["kernels"], check["ranks"]
        image_rows = 32 * 12 // 2  # the batch x this rank's 6 of 12 heads
        for r, got in enumerate(ranks):
            if sel == "on" and not (set(got["launches"]) == {"attend_fwd", "attend_bwd"}
                                    and image_rows in got["attend_rows"]):
                raise AssertionError(f"{path} on rank {r}: launches {got['launches']}, "
                                     f"attention rows {got['attend_rows']}")
            if sel == "off" and got["launches"]:
                raise AssertionError(f"{path} off rank {r}: launches {got['launches']}")
        out["checks"][sel] = dict(
            single=check["single"]["losses"], ranks=[g["losses"] for g in ranks],
            max_excess=check["max_excess"], launches=ranks[0]["launches"],
            attend_rows=ranks[0]["attend_rows"],
            step_ms=[1e3 * sum(g["step_s"][1:]) / len(g["step_s"][1:]) for g in ranks],
            all_reduce_share=[sum(g["all_reduce_s"][1:]) / sum(g["step_s"][1:]) for g in ranks],
            single_step_ms=1e3 * sum(check["single"]["step_s"][1:])
            / len(check["single"]["step_s"][1:]),
            peak_mem_gib=[g["peak_mem_gib"] for g in ranks])
        out["launches"][sel] = ranks[0]["launches"]
        c = out["checks"][sel]
        print(f"{path} {sel} [{card}]: losses one rank {c['single']}, ranks {c['ranks']} "
              f"(within {TP_REL['bfloat16']['loss']} relative); two ranks time-slice the card "
              f"over gloo (no scaling figure): {', '.join(f'{x:.1f}' for x in c['step_ms'])} ms "
              f"a step a rank (one rank {c['single_step_ms']:.1f}), "
              f"{', '.join(f'{100 * x:.1f}%' for x in c['all_reduce_share'])} in dist.all_reduce; "
              f"peak {', '.join(f'{x or 0:.2f}' for x in c['peak_mem_gib'])} GiB; launches "
              f"{c['launches']}, attention rows {c['attend_rows']}", flush=True)
    if not line["ok"]:
        raise AssertionError(f"{path}: {line}")
    print("main-path " + json.dumps(out), flush=True)
    return out


def _parent_pipelined_inference(loader, dispatch):
    """``utils.pipeline.pipelined_inference`` as it read before its repair,
    the baseline of ``read_turns``: batch i read with ``.cpu()`` after batch i+1's
    dispatch, so on the one stream the read waits for batch i+1's tower."""
    import torch

    def read(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    pend = None
    for batch in loader:
        dev = dispatch(batch)
        if pend is not None:
            yield read(pend[0]), pend[1]
        pend = (dev, batch)
    if pend is not None:
        yield read(pend[0]), pend[1]


def read_turns(path: str, card: str, run, images_n: int, shipped: float) -> dict:
    """The extraction ``run`` again, in turns after the phase's run with the
    shipped read (``shipped`` img/s): with the previous read, then with the
    shipped one. Returns and prints img/s with the loading of each."""
    from mvlpt_torch.utils import pipeline

    rates = {"shipped": [shipped], "parent": []}
    for way in ("parent", "shipped"):
        saved = pipeline.pipelined_inference
        if way == "parent":
            pipeline.pipelined_inference = _parent_pipelined_inference
        try:
            with _Timed(pipeline, "dump_split_features") as dumps:
                run()
        finally:
            pipeline.pipelined_inference = saved
        rates[way].append(images_n / sum(dumps.seconds))
    print(f"{path} [{card}]: img/s with the loading, in turns: shipped read "
          f"{rates['shipped'][0]:.1f}, the previous read {rates['parent'][0]:.1f}, shipped read "
          f"{rates['shipped'][1]:.1f}", flush=True)
    return rates


def kernel_entries(results: list[dict], paths: dict) -> list[dict]:
    """One entry a kernel of KERNELS: its bf16 check row's numbers and its
    launches on each path."""
    out = []
    for name, (source, replaces, (kname, mode, shape)) in KERNELS.items():
        r = next(x for x in results if (x["name"], x["mode"], x["tower"], x["dtype"])
                 == (kname, mode, shape, "bfloat16"))
        by_path = {path: p["launches"].get(name, 0) for path, p in paths.items()
                   if p["launches"].get(name, 0)}
        out.append({"name": name, "route": "cuda", "source": f"mvlpt_torch/csrc/{source}.cu",
                    "replaces": replaces, "launches": sum(by_path.values()),
                    "launches_by_path": by_path, "shape": r["shape"],
                    "max_abs_err": r["max_abs_err"],
                    # The bf16 rule's numbers (verdict).
                    **{k: r[k] for k in ("max_abs_err64", "twin_err64", "tol", "ok_old")
                       if k in r},
                    "ms": r["ms"], "ms_spread": r["ms_spread"],
                    "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    # The row's route by dtype (block's *_ROUTES, attention.ROUTES)
                    # and its products' cuBLAS yardstick, where the row has them.
                    **({"dtype_route": r["route"]} if "route" in r else {}),
                    **({"gemm_library_ms": r["gemm_library_ms"]} if "gemm_library_ms" in r
                       else {})})
    return out


def text_and_image_shapes():
    """(text length s, classes a packed row G, packed rows, the image
    tower's S at ViT-B/16 and at ViT-L/14@336px, the packed rows' mask)."""
    from mvlpt_torch.core.text import block_causal_mask, packing
    from mvlpt_torch.prompts import compute_cut_context_length

    s = compute_cut_context_length([f"class number {i}" for i in range(100)], 4)
    g, rows = packing(100, s)
    s_img = 1 + 14 * 14 + 4  # CLS + patches + VPT rows
    s_l336 = 1 + 24 * 24 + 4  # ViT-L/14@336px: the same, 24 x 24 patches
    return s, g, rows, s_img, s_l336, block_causal_mask(g, s, device="cuda")


def half_block_shapes() -> tuple[dict, dict]:
    """The shapes of check_kernels' and check_tp_kernels' rows."""
    from mvlpt_torch.core.layers import causal_mask

    from mvlpt_torch.core.text import block_causal_mask

    s, g, rows, s_img, s_l336, packed_mask = text_and_image_shapes()
    s_e, g_e, rows_e = elevater_text_shape()
    n_e = len(elevater_classnames())
    mask_e = block_causal_mask(g_e, s_e, device="cuda")
    s_t, g_t, rows_t = elevater_text_shape((ELEV_TRANSFER_TASK,))
    n_t = len(elevater_classnames((ELEV_TRANSFER_TASK,)))
    mask_t = block_causal_mask(g_t, s_t, device="cuda")
    s_ei, s_zs = elevater_image_tokens(), elevater_image_tokens(0)
    s_x = extract_image_tokens()
    rows_c = cocoop_chunk_rows(32, cocoop_base_classes())
    rows_ce = cocoop_chunk_rows(EVAL_BATCH, COCOOP_CLASSES - cocoop_base_classes())
    rows_p = cocoop_chunk_rows(32, COCOOP_PROBE_CLASSES)
    mask_c = causal_mask(77, device="cuda")
    every, no_residual = ("train", "no-residual"), ("no-residual",)
    attn_only = (("attn_fwd", "train"), ("attn_fwd", "no-residual"), ("attn_bwd", "train"))
    kernel_shapes = {
        "image": (32, s_img, 768, 12, None, s_img, 32, every),
        "image_eval": (EVAL_BATCH, s_img, 768, 12, None, s_img, EVAL_BATCH, no_residual),
        "text": (rows, g * s, 512, 8, packed_mask, s, 100, every),
        # ViT-L/14@336px's attention half-blocks at batch 4.
        "vitl336": (4, s_l336, 1024, 16, None, s_l336, 4, attn_only),
        # The attention half-blocks at S = 1024 (causal), four windows of
        # the bf16 cores' keys (or queries).
        "s1024": (2, 1024, 768, 12, causal_mask(1024, device="cuda"), 1024, 2, attn_only),
        # The ELEVATER-20 text tower of trainer_elevater (1151 classes,
        # CoOp ctx 16): its s, G and packed rows, causal within each class.
        "text_elevater": (rows_e, g_e * s_e, 512, 8, mask_e, s_e, n_e, every),
        # Their image tower (VPT ctx 16): the train batch and the eval batch.
        "image_elevater": (32, s_ei, 768, 12, None, s_ei, 32, every),
        "image_eval_elevater": (EVAL_BATCH, s_ei, 768, 12, None, s_ei, EVAL_BATCH, no_residual),
        # The text tower of trainer_elevater_transfer (ELEV_TRANSFER_TASK).
        "text_elevater_transfer": (rows_t, g_t * s_t, 512, 8, mask_t, s_t, n_t, every),
        # The zero-shot image tower (no VPT rows): zeroshot[*], zeroshot_cli,
        # and trainer_cocoop's test batches.
        "image_eval_zeroshot": (EVAL_BATCH, s_zs, 768, 12, None, s_zs, EVAL_BATCH, no_residual),
        # trainer_cocoop's text tower (s = 77, causal, G = 1): a train
        # chunk of 8 images x 500 base classes, a test chunk of 5 x 500
        # new ones; its image tower without VPT rows at the train batch.
        "text_cocoop": (rows_c, 77, 512, 8, mask_c, 77, rows_c, every),
        "text_eval_cocoop": (rows_ce, 77, 512, 8, mask_c, 77, rows_ce, no_residual),
        "image_cocoop": (32, s_zs, 768, 12, None, s_zs, 32, every),
        # cocoop_memory's text chunk: 16 images x COCOOP_PROBE_CLASSES
        # (SUN397 base), the train kernels only (one train step).
        "text_cocoop_probe": (rows_p, 77, 512, 8, mask_c, 77, rows_p, ("train",)),
        # extract_features' ViT-B/32 image tower (no VPT rows) at batch 128.
        "image_extract": (LP_BATCH, s_x, 768, 12, None, s_x, LP_BATCH, no_residual)}
    tp_shapes = {
        "image": (32, s_img, 768, 12, None, s_img, 32, TP_KERNELS),
        "text": (rows, g * s, 512, 8, packed_mask, s, 100, TP_KERNELS),
        "vitl336": (4, s_l336, 1024, 16, None, s_l336, 4, ("attn_fwd_tp", "attn_bwd_tp")),
        "s1024": (2, 1024, 768, 12, causal_mask(1024, device="cuda"), 1024, 2,
                  ("attn_fwd_tp", "attn_bwd_tp"))}
    return kernel_shapes, tp_shapes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "mvlpt_torch" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout (mvlpt_torch/ is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mvlpt_torch.core.layers import causal_mask
    from mvlpt_torch.ops import _build

    print(card_line(), flush=True)  # name, power limit (nvidia-smi)
    print(setup_vocab(), flush=True)
    t0 = time.perf_counter()
    info = _build.build_kernels()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, one process "
          f"a source): {', '.join(info['built']) or 'none, all cached'}", flush=True)
    for name, log in info["ptxas"].items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
        print(f"ptxas {name}{'' if name in info['built'] else ' (cached build)'}: {len(regs)} "
              f"kernels, at most {max(regs, default=0)} registers a thread, {spill} bytes of "
              f"spills", flush=True)
    check_tc_spills(info["ptxas"])
    check_hgmma()

    s, g, rows, s_img, s_l336, packed_mask = text_and_image_shapes()
    s_e, g_e, rows_e = elevater_text_shape()
    kernel_shapes, tp_shapes = half_block_shapes()
    results = check_kernels(kernel_shapes)
    results += check_tp_kernels(tp_shapes)
    # The MLP backward's K-major GEMM alone: the image and packed text
    # rows, ViT-L/14@336px at its train batch of 8, and a ragged edge
    # below one tile.
    results += check_gemm_kmajor({"image": (32 * s_img, 768), "text": (rows * g * s, 512),
                                  "vitl336": (VITL336["batch"] * s_l336, 1024),
                                  "edge": (51, 64)})
    both, fb = ("bfloat16", "float32"), ("attend_fwd", "attend_bwd")
    results += check_attend({
        "image_train": (32 * 12, s_img, 64, None, both, fb),
        "image_eval": (EVAL_BATCH * 12, s_img, 64, None, both, fb),
        "text_packed": (rows * 8, g * s, 64, packed_mask, both, fb),
        "text_clip": (100 * 8, 77, 64, causal_mask(77, device="cuda"), both, fb),
        # The tiling's edges: below one mma tile, ragged, ViT-L/14 with 4
        # VPT rows (8 images x 16 heads); the bf16 buckets' largest S and
        # one past it (the CUDA-core route), the fp32 route's largest S
        # before this PR; ViT-L/14@336px (4 images x 16 heads) and S = 1024.
        "edge_s1": (64, 1, 64, None, both, fb),
        "edge_s17": (64, 17, 64, causal_mask(17, device="cuda"), both, fb),
        "vitl_s261": (8 * 16, 1 + 16 * 16 + 4, 64, None, both, fb),
        "max_fwd_bf16": (64, 352, 64, None, ("bfloat16",), ("attend_fwd",)),
        "past_fwd_bf16": (64, 353, 64, None, ("bfloat16",), ("attend_fwd",)),
        "max_fwd_fp32": (64, 348, 64, None, ("float32",), ("attend_fwd",)),
        "max_bwd_bf16": (64, 280, 64, causal_mask(280, device="cuda"), ("bfloat16",),
                         ("attend_bwd",)),
        "past_bwd_bf16": (64, 281, 64, causal_mask(281, device="cuda"), ("bfloat16",),
                          ("attend_bwd",)),
        "max_bwd_fp32": (64, 278, 64, None, ("float32",), ("attend_bwd",)),
        "vitl336_s581": (4 * 16, s_l336, 64, None, both, fb),
        "s1024": (64, 1024, 64, causal_mask(1024, device="cuda"), both, fb)})
    print(f"text tower: s={s}, G={g}, {rows} packed rows of {g * s} tokens", flush=True)
    paths = drive_paths({"visual": (32, s_img, None), "text": (rows, g * s, packed_mask)},
                        (s, g))
    paths["trainer_cli"] = drive_trainer_cli()
    paths["trainer_cli_native"] = drive_trainer_cli_native(paths["trainer_cli"])
    paths["trainer_adamw_dropout"] = drive_trainer_adamw_dropout(
        paths.get("train_window_k120[auto]"))
    paths["debug_nans"] = drive_debug_nans()
    paths["post_run"] = drive_post_run()
    paths["finetune_cli"] = drive_finetune_cli()
    print(f"ELEVATER-20 text tower: s={s_e}, G={g_e}, {rows_e} rows of {g_e * s_e} tokens",
          flush=True)
    paths.update(drive_trainer_elevater())
    paths.update(drive_trainer_cocoop())
    paths["lpclip"] = drive_lpclip()
    paths["lpclip_native"] = drive_lpclip_native(paths["lpclip"])
    paths["extract_features"] = drive_extract_features()
    paths["zoo_extract"] = drive_zoo_extract(paths["extract_features"]["rows"])
    paths["interpret_prompt"] = drive_interpret_prompt()
    # The mesh runs last: two ranks share the card with this process, and
    # the traced replays above run as they did before these phases existed.
    mesh = drive_mesh_cli()
    for name, launches in mesh["launches"].items():
        paths[f"mesh_cli[{name}]"] = dict(mesh["runs"][name], launches=launches)
    pod = drive_pod_loss_check()
    for name, launches in pod["launches"].items():
        paths[f"pod_loss_check[{name}]"] = dict(launches=launches)

    summary = {"card": card_line()}
    for path, out in paths.items():
        summary[path] = {k: out[k] for k in ("ms_per_step", "device_ms_per_step", "img_per_s",
                                             "mfu_host", "mfu_device", "peak_mem_gib")
                         if k in out}
    print("summary " + json.dumps(summary), flush=True)

    print(json.dumps({"kernels": kernel_entries(results, paths)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
