"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py).

The JAX package is the reference: the same numpy inputs go through it
and through ``mvlpt_torch`` on the CPU, in fp32. Its Pallas kernels run
in interpret mode there, as in its own tests.
"""

from __future__ import annotations

import time
import traceback
from pathlib import Path

import numpy as np
import pytest


@pytest.fixture(scope="module")
def synthetic_vocab(tmp_path_factory):
    """A generated merges file in place of the real CLIP vocab, handed to
    both tokenizers: the JAX side by replacing its default tokenizer
    (its search paths are fixed when it is imported), the port by its
    own default."""
    from mvlpt_torch.tokenizer import bpe as tbpe

    path = str(tmp_path_factory.mktemp("vocab") / "synthetic_bpe_vocab.txt.gz")
    tbpe.write_synthetic_vocab(path, seed=0)
    from mvlpt_tpu.tokenizer import bpe as jbpe

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MVLPT_TPU_NO_NATIVE_BPE", "1")
        mp.setattr(jbpe, "_DEFAULT", jbpe.ClipBpeTokenizer(path))
        mp.setattr(tbpe, "_DEFAULT", tbpe.ClipBpeTokenizer(path))
        yield path


def spawn_ranks(target, world: int, *args) -> list:
    """Start ``target(rank, *args)`` in one process a rank (start method
    ``spawn``, so a child imports only what ``target``'s module imports:
    never JAX); returns the processes."""
    import torch

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args)) for r in range(world)]
    for proc in procs:
        proc.start()
    return procs


def collect_ranks(procs: list, workdir, deadline: float) -> None:
    """Join the ranks of :func:`spawn_ranks` by ``deadline`` (on
    ``time.monotonic``), kill the ones still running, and assert that
    none hung, none wrote ``rank{r}.err`` in ``workdir`` and every one
    exited 0."""
    workdir = Path(workdir)
    for proc in procs:
        proc.join(max(1.0, deadline - time.monotonic()))
    hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    errs = {r: (workdir / f"rank{r}.err").read_text() for r in range(len(procs))
            if (workdir / f"rank{r}.err").is_file()}
    codes = [proc.exitcode for proc in procs]
    assert not hung and not errs and codes == [0] * len(procs), (hung, codes, errs)


def run_rank(rank: int, world: int, workdir: str, fn, *args) -> None:
    """The body of a spawned rank: one intra-op thread, a gloo group over
    a ``file://`` store under ``workdir``, then ``fn(rank, *args)``; the
    traceback of a failure goes to ``rank{rank}.err``, and the group is
    destroyed at the end."""
    import torch
    import torch.distributed as dist

    work = Path(workdir)
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                                world_size=world)
        fn(rank, *args)
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class WriteProbe:
    """Records the paths under ``root`` that this process opens for writing
    or creates as directories (``open``, ``io.open``, ``os.makedirs``,
    ``os.mkdir``) while it is entered: which rank wrote a run's files."""

    def __init__(self, root):
        import builtins
        import io
        import os

        self.root, self.paths = os.path.abspath(root), []
        self._saved = (builtins.open, io.open, os.makedirs, os.mkdir)

    def _note(self, path):
        import os

        if isinstance(path, (str, os.PathLike)):
            path = os.path.abspath(os.fspath(path))
            if path.startswith(self.root):
                self.paths.append(path)

    def __enter__(self):
        import builtins
        import io
        import os

        def opened(real):
            def call(file, mode="r", *a, **k):
                if any(c in mode for c in "wax+"):
                    self._note(file)
                return real(file, mode, *a, **k)
            return call

        def made(real):
            def call(name, *a, **k):
                if not os.path.isdir(name):
                    self._note(name)
                return real(name, *a, **k)
            return call

        o, io_o, mkd, mk = self._saved
        builtins.open, io.open, os.makedirs, os.mkdir = opened(o), opened(io_o), made(mkd), made(mk)
        return self

    def __exit__(self, *exc):
        import builtins
        import io
        import os

        builtins.open, io.open, os.makedirs, os.mkdir = self._saved


def block_params_np(rng: np.random.RandomState, w: int) -> dict:
    """One residual block's params in the JAX schema (tests/test_fused_block.py)."""
    def mk(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    return {
        "ln_1": {"scale": (1 + 0.1 * rng.randn(w)).astype(np.float32), "bias": mk(w)},
        "ln_2": {"scale": (1 + 0.1 * rng.randn(w)).astype(np.float32), "bias": mk(w)},
        "attn": {"qkv_w": mk(w, 3 * w), "qkv_b": mk(3 * w), "out_w": mk(w, w),
                 "out_b": mk(w)},
        "mlp": {"fc_w": mk(w, 4 * w), "fc_b": mk(4 * w), "proj_w": mk(4 * w, w),
                "proj_b": mk(w)},
    }


def to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# The tiny CLIP of the two-sided tests (two layers a tower, narrow widths,
# after __graft_entry__.py:_tiny_flagship).
TINY_DIMS = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
                 vision_patch_size=8, transformer_width=64, transformer_heads=2,
                 transformer_layers=2, vision_heads_override=2)
# A UPT spec on it: CoOp ctx 2 'middle', deep VPT 2, the coupler at dim 16.
UPT_SPEC = dict(coop_n_ctx=2, vpt_n_ctx=2, vpt_deep=True, class_token_position="middle",
                project_method="transformer", project_dim=16)


def two_sides(n_cls: int, **spec):
    """One model on both sides, fp32 on the CPU: the JAX package's with
    its fused-block kernels (interpret mode) and the port's with the
    half-block kernels' plain twins, the same backbone, prompt params and
    consts carried across by mvlpt_torch.checkpoint.from_jax. ``spec``
    overrides UPT_SPEC. Call it under the ``synthetic_vocab`` fixture.
    Returns dict(j=(model, backbone, params, consts), t=(...), s=the
    prompt length)."""
    import jax
    import jax.numpy as jnp
    import torch

    from mvlpt_tpu.core.clip import CLIPConfig as JCfg, init_clip_params
    from mvlpt_tpu.models.custom_clip import MVLPTModel as JModel
    from mvlpt_tpu.ops import block as jblock
    from mvlpt_tpu.prompts import (
        PromptSpec as JSpec, build_prompt_consts as jconsts,
        compute_cut_context_length as jcut, init_prompt_params as jinit)

    from mvlpt_torch.checkpoint import backbone_from_jax, prompt_params_from_jax
    from mvlpt_torch.core.clip import CLIPConfig
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.ops.attention import select_attn_fn
    from mvlpt_torch.prompts import PromptSpec, build_prompt_consts, compute_cut_context_length

    classnames = [f"c{i}" for i in range(n_cls)]
    spec = dict(UPT_SPEC, **spec)
    n_ctx = max(spec["coop_n_ctx"], spec.get("cocoop_n_ctx", 0))
    s = jcut(classnames, n_ctx)
    assert compute_cut_context_length(classnames, n_ctx) == s
    spec_kw = dict(spec, n_cls=n_cls, context_length=s, vision_layers=2, vision_width=64,
                   text_width=64, embed_dim=32, vision_patch_size=8)

    j_backbone = init_clip_params(jax.random.PRNGKey(0), JCfg(**TINY_DIMS))
    j_pp = jinit(jax.random.PRNGKey(1), JSpec(**spec_kw))
    j_consts = jconsts(classnames, JSpec(**spec_kw), j_backbone, jnp.float32)
    j_model = JModel(clip_cfg=JCfg(**TINY_DIMS), spec=JSpec(**spec_kw), attn_fn=jblock.FUSED,
                     compute_dtype=jnp.float32)

    backbone = backbone_from_jax(jax.tree_util.tree_map(np.asarray, j_backbone), "cpu")
    pp = prompt_params_from_jax(jax.tree_util.tree_map(np.asarray, j_pp), "cpu")
    t_spec = PromptSpec(**spec_kw)
    consts = build_prompt_consts(classnames, t_spec, backbone, torch.float32)
    model = MVLPTModel(CLIPConfig(**TINY_DIMS), t_spec, kernels=select_attn_fn("block"),
                       compute_dtype=torch.float32)
    return dict(j=(j_model, j_backbone, j_pp, j_consts), t=(model, backbone, pp, consts), s=s)


def write_elevater_task(root, task: str, n_classes: int, seed: int, n_train: int = 2,
                        n_test: int = 1, multilabel: bool = False, size: int = 32,
                        splits=("train", "test"), classnames=None) -> None:
    """<root>/<task>/manifest.json (the port's ``write_task_manifest``) and
    its JPEGs: ``n_train`` train and ``n_test`` items a class in each of
    ``splits`` (the first is "train"). Every draw comes from ``seed``
    (never from ``hash``, which varies with PYTHONHASHSEED)."""
    import os

    from mvlpt_torch.data.elevater import write_task_manifest
    from tests.util_fixtures import _write_image

    task_dir = os.path.join(root, task)
    counts = {split: n_train if split == "train" else n_test for split in splits}
    items = write_task_manifest(task_dir, n_classes, counts, np.random.RandomState(seed),
                                multilabel=multilabel, classnames=classnames)
    for k, (rel, label) in enumerate(items):
        _write_image(os.path.join(task_dir, rel), seed=seed * 100003 + k, size=(size, size),
                     class_signal=label)


def openai_rn_state_dict(seed: int, layers=(1, 1, 1, 1), width: int = 8,
                         resolution: int = 64, embed: int = 32, text_width: int = 64,
                         text_layers: int = 2, vocab: int = 49408, context: int = 77,
                         scale: float = 0.05) -> dict:
    """A random OpenAI-layout ModifiedResNet CLIP state_dict (torch
    tensors, fp32), with the keys and shapes that the reference's
    ModifiedResNet and text transformer give (clip/model.py) and that
    ``convert_openai_rn_state_dict`` reads in both packages: a 3-conv stem,
    ``layers`` Bottlenecks a stage at ``width`` (a downsample on each
    stage's first), the attention pool at ``width`` x 32 channels for
    ``resolution`` px, and a text tower of ``text_layers`` blocks at
    ``text_width`` (one head per 64 wide). BatchNorm running statistics
    are drawn away from identity. Every draw comes from ``seed``; the
    defaults are a tiny tower, and RN50's are layers (3, 4, 6, 3), width
    64, 224 px, embed 1024, a 512-wide 12-layer text tower."""
    import torch

    rng = np.random.RandomState(seed)

    def t(*shape, s=scale):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))

    def conv(cout, cin, k):
        return t(cout, cin, k, k, s=(2.0 / (cin * k * k)) ** 0.5)

    def bn(prefix, c):
        return {f"{prefix}.weight": 1 + t(c, s=0.1), f"{prefix}.bias": t(c),
                f"{prefix}.running_mean": t(c, s=0.1),
                f"{prefix}.running_var": torch.from_numpy(
                    (0.5 + rng.rand(c)).astype(np.float32)),
                f"{prefix}.num_batches_tracked": torch.tensor(0)}

    sd = {}
    for i, (cin, cout) in enumerate(((3, width // 2), (width // 2, width // 2),
                                     (width // 2, width)), start=1):
        sd[f"visual.conv{i}.weight"] = conv(cout, cin, 3)
        sd.update(bn(f"visual.bn{i}", cout))
    inplanes = width
    for b, n in zip((1, 2, 3, 4), layers):
        planes = width * 2 ** (b - 1)
        for i in range(n):
            p = f"visual.layer{b}.{i}"
            cin = inplanes if i == 0 else planes * 4
            sd[f"{p}.conv1.weight"] = conv(planes, cin, 1)
            sd.update(bn(f"{p}.bn1", planes))
            sd[f"{p}.conv2.weight"] = conv(planes, planes, 3)
            sd.update(bn(f"{p}.bn2", planes))
            sd[f"{p}.conv3.weight"] = conv(planes * 4, planes, 1)
            sd.update(bn(f"{p}.bn3", planes * 4))
            if i == 0:
                sd[f"{p}.downsample.0.weight"] = conv(planes * 4, inplanes, 1)
                sd.update(bn(f"{p}.downsample.1", planes * 4))
        inplanes = planes * 4
    c = width * 32
    sd["visual.attnpool.positional_embedding"] = t((resolution // 32) ** 2 + 1, c,
                                                   s=c ** -0.5)
    for name, out in (("q_proj", c), ("k_proj", c), ("v_proj", c), ("c_proj", embed)):
        sd[f"visual.attnpool.{name}.weight"] = t(out, c, s=c ** -0.5)
        sd[f"visual.attnpool.{name}.bias"] = t(out)
    w = text_width
    for i in range(text_layers):
        b = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = 1 + t(w, s=0.1), t(w)
        sd.update({f"{b}.attn.in_proj_weight": t(3 * w, w), f"{b}.attn.in_proj_bias": t(3 * w),
                   f"{b}.attn.out_proj.weight": t(w, w), f"{b}.attn.out_proj.bias": t(w),
                   f"{b}.mlp.c_fc.weight": t(4 * w, w), f"{b}.mlp.c_fc.bias": t(4 * w),
                   f"{b}.mlp.c_proj.weight": t(w, 4 * w), f"{b}.mlp.c_proj.bias": t(w)})
    sd.update({"token_embedding.weight": t(vocab, w, s=0.02),
               "positional_embedding": t(context, w, s=0.01),
               "ln_final.weight": 1 + t(w, s=0.1), "ln_final.bias": t(w),
               "text_projection": t(w, embed, s=w ** -0.5),
               "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32)})
    return sd


def calibrate_rn_bn(sd: dict, images):
    """Sets every BatchNorm's running statistics of the OpenAI-layout RN
    state_dict ``sd``, in place, to the batch statistics (mean, biased
    variance) of what reaches it in one fp32 pass over ``images`` (N, 3,
    H, W, normalised), stage by stage, so that each BatchNorm normalises
    its input as a trained network's statistics do: random kernels with
    statistics left at their draw let the activations grow through the
    blocks until the attention pool's softmax saturates. The pass follows
    the reference's ModifiedResNet (clip/model.py:10-150) by hand, not the
    port's tower, and runs on ``images``' device. Returns the map that the
    attention pool reads, (N, 32 width, H/32, W/32)."""
    import torch.nn.functional as F

    def w(key):
        return sd[key].to(images.device)

    def conv(x, key, stride=1):
        k = w(key)
        return F.conv2d(x, k, stride=stride, padding=k.shape[-1] // 2)

    def bn(x, prefix):
        mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
        sd[f"{prefix}.running_mean"].copy_(mean)
        sd[f"{prefix}.running_var"].copy_(var)
        return F.batch_norm(x, mean, var, w(f"{prefix}.weight"), w(f"{prefix}.bias"),
                            eps=1e-5)

    x = images.float()
    for i, stride in ((1, 2), (2, 1), (3, 1)):
        x = F.relu(bn(conv(x, f"visual.conv{i}.weight", stride), f"visual.bn{i}"))
    x = F.avg_pool2d(x, 2)
    stage = 1
    while f"visual.layer{stage}.0.conv1.weight" in sd:
        i = 0
        while f"visual.layer{stage}.{i}.conv1.weight" in sd:
            p, stride = f"visual.layer{stage}.{i}", 2 if stage > 1 and i == 0 else 1
            out = F.relu(bn(conv(x, f"{p}.conv1.weight"), f"{p}.bn1"))
            out = F.relu(bn(conv(out, f"{p}.conv2.weight"), f"{p}.bn2"))
            if stride > 1:
                out = F.avg_pool2d(out, stride)
            out = bn(conv(out, f"{p}.conv3.weight"), f"{p}.bn3")
            identity = x
            if f"{p}.downsample.0.weight" in sd:
                identity = F.avg_pool2d(x, stride) if stride > 1 else x
                identity = bn(conv(identity, f"{p}.downsample.0.weight"), f"{p}.downsample.1")
            x = F.relu(out + identity)
            i += 1
        stage += 1
    return x


# ---------------------------------------------------------------------------
# Random state dicts in the model zoo's torch key layouts (timm ViT/DeiT with
# MAE and MoCo-v3 wrappers, torchvision ResNet, timm EfficientNet), at any
# size: the layouts both packages' checkpoint/zoo_convert.py read.
# ---------------------------------------------------------------------------

def _zoo_draws(seed: int):
    """(t, bn) drawing torch fp32 tensors from ``seed``: t(*shape, s=std)
    normal; bn(prefix, c) a BatchNorm's weight, bias and running
    statistics away from identity, with num_batches_tracked."""
    import torch

    rng = np.random.RandomState(seed)

    def t(*shape, s=0.02):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))

    def bn(prefix, c):
        return {f"{prefix}.weight": 1 + t(c, s=0.1), f"{prefix}.bias": t(c, s=0.05),
                f"{prefix}.running_mean": t(c, s=0.1),
                f"{prefix}.running_var": torch.from_numpy(
                    (0.5 + rng.rand(c)).astype(np.float32)),
                f"{prefix}.num_batches_tracked": torch.tensor(0)}

    return t, bn


def timm_vit_state_dict(seed: int, width: int = 64, layers: int = 2, patch: int = 16,
                        resolution: int = 32, mlp_ratio: int = 4, distilled: bool = False,
                        wrapper: str | None = None, num_classes: int = 10) -> dict:
    """A random timm ViT/DeiT state dict (``patch_embed.proj``, ``cls_token``,
    ``dist_token`` when ``distilled``, ``pos_embed``, ``blocks.N.{norm1,
    attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}``, ``norm``, ``head``):
    linear kernels at fan-in scale, LayerNorms away from identity, every
    draw from ``seed``. ``wrapper``: None (bare timm keys); "mae" (MAE's
    pre-training file: {"model": ...} with ``mask_token`` and decoder
    keys); "mae_finetune" ({"model": ...} with ``fc_norm`` in place of
    ``norm``, the global pool); "mocov3" (MoCo-v3's file: {"state_dict":
    "module.base_encoder." keys with a projection-MLP head, the momentum
    encoder and predictor beside them, "epoch", "arch", "optimizer" and an
    argparse namespace, which ``weights_only=True`` refuses).
    ViT-B/16 is width 768, 12 layers, patch 16, 224 px, 1000 classes."""
    import argparse

    t, bn = _zoo_draws(seed)
    w, n_prefix = width, 2 if distilled else 1
    n_patches = (resolution // patch) ** 2

    def lin(prefix, out, inp):
        return {f"{prefix}.weight": t(out, inp, s=inp ** -0.5), f"{prefix}.bias": t(out)}

    def ln(prefix):
        return {f"{prefix}.weight": 1 + t(w, s=0.1), f"{prefix}.bias": t(w)}

    sd = {"patch_embed.proj.weight": t(w, 3, patch, patch, s=(3 * patch * patch) ** -0.5),
          "patch_embed.proj.bias": t(w), "cls_token": t(1, 1, w)}
    if distilled:
        sd["dist_token"] = t(1, 1, w)
    sd["pos_embed"] = t(1, n_prefix + n_patches, w)
    for i in range(layers):
        b = f"blocks.{i}"
        sd.update({**ln(f"{b}.norm1"), **lin(f"{b}.attn.qkv", 3 * w, w),
                   **lin(f"{b}.attn.proj", w, w), **ln(f"{b}.norm2"),
                   **lin(f"{b}.mlp.fc1", mlp_ratio * w, w),
                   **lin(f"{b}.mlp.fc2", w, mlp_ratio * w)})
    sd.update(ln("fc_norm" if wrapper == "mae_finetune" else "norm"))
    if wrapper == "mocov3":  # the projection MLP (Linear, BN, ReLU, Linear)
        sd.update({**lin("head.0", 2 * w, w), **bn("head.1", 2 * w), **lin("head.3", w, 2 * w)})
    else:
        sd.update(lin("head", num_classes, w))
        if distilled:
            sd.update(lin("head_dist", num_classes, w))
    if wrapper is None:
        return sd
    if wrapper == "mae":
        sd["mask_token"] = t(1, 1, w)
        sd.update({**lin("decoder_embed", w, w), "decoder_pos_embed": t(1, 1 + n_patches, w),
                   **lin("decoder_pred", patch * patch * 3, w)})
        return {"model": sd}
    if wrapper == "mae_finetune":
        return {"model": sd}
    if wrapper == "mocov3":
        wrapped = {f"module.base_encoder.{k}": v for k, v in sd.items()}
        wrapped.update({f"module.momentum_encoder.{k}": v.clone() for k, v in sd.items()})
        wrapped.update({f"module.predictor.{k}": v for k, v in
                        {**lin("0", 2 * w, w), **lin("3", w, 2 * w)}.items()})
        return {"epoch": 300, "arch": "vit_base", "state_dict": wrapped,
                "optimizer": {"state": {}, "param_groups": [{"lr": 1.5e-4}]},
                "args": argparse.Namespace(arch="vit_base", moco_t=0.2)}
    raise ValueError(f"unknown wrapper {wrapper!r}")


def tv_resnet_state_dict(seed: int, layers=(1, 1, 1, 1), width: int = 8,
                         bottleneck: bool = True, num_classes: int = 10,
                         wrapper: str | None = None) -> dict:
    """A random torchvision ResNet state dict (v1.5 layout: ``conv1/bn1``,
    ``layer{1..4}.{j}.conv*/bn*``, ``downsample.{0,1}`` on each stage's
    first block where the shape changes, ``fc``): He-normal kernels,
    BatchNorms away from identity, every draw from ``seed``. ``wrapper``
    "module" prefixes every key as DataParallel does; "state_dict" nests
    them under {"state_dict": ...}. ResNet50 is layers (3, 4, 6, 3),
    width 64, bottleneck, 1000 classes."""
    t, bn = _zoo_draws(seed)

    def conv(cout, cin, k):
        return t(cout, cin, k, k, s=(2.0 / (cin * k * k)) ** 0.5)

    expansion = 4 if bottleneck else 1
    sd = {"conv1.weight": conv(width, 3, 7), **bn("bn1", width)}
    c_in = width
    for stage, n in enumerate(layers):
        planes = width * 2 ** stage
        c_out = planes * expansion
        for j in range(n):
            p = f"layer{stage + 1}.{j}"
            if bottleneck:
                sd.update({f"{p}.conv1.weight": conv(planes, c_in, 1), **bn(f"{p}.bn1", planes),
                           f"{p}.conv2.weight": conv(planes, planes, 3), **bn(f"{p}.bn2", planes),
                           f"{p}.conv3.weight": conv(c_out, planes, 1), **bn(f"{p}.bn3", c_out)})
            else:
                sd.update({f"{p}.conv1.weight": conv(planes, c_in, 3), **bn(f"{p}.bn1", planes),
                           f"{p}.conv2.weight": conv(planes, planes, 3), **bn(f"{p}.bn2", planes)})
            if j == 0 and (stage > 0 or c_in != c_out):
                sd.update({f"{p}.downsample.0.weight": conv(c_out, c_in, 1),
                           **bn(f"{p}.downsample.1", c_out)})
            c_in = c_out
    sd.update({"fc.weight": t(num_classes, c_in, s=c_in ** -0.5), "fc.bias": t(num_classes)})
    if wrapper == "module":
        return {f"module.{k}": v for k, v in sd.items()}
    if wrapper == "state_dict":
        return {"state_dict": sd}
    if wrapper is not None:
        raise ValueError(f"unknown wrapper {wrapper!r}")
    return sd


def timm_effnet_state_dict(seed: int, stages, stem_ch: int, head_ch: int,
                           se_ratio: float = 0.25, num_classes: int = 10) -> dict:
    """A random timm EfficientNet state dict: ``conv_stem``/``bn1``,
    ``blocks.S.J.*`` (stage 0's expand-1 blocks DepthwiseSeparableConv:
    ``conv_dw``, ``bn1``, ``se``, ``conv_pw``, ``bn2``; the others
    InvertedResidual: ``conv_pw``, ``bn1``, ``conv_dw``, ``bn2``, ``se``,
    ``conv_pwl``, ``bn3``; SE ``conv_reduce``/``conv_expand`` with biases,
    ``se_ratio`` of the block's input channels), ``conv_head``/``bn2``,
    ``classifier``. ``stages`` holds (blocks, kernel, stride, expansion,
    out channels) a stage, as EffNetConfig's; efficientnet_b0 is
    ``core.efficientnet.EFFNET_CONFIGS["efficientnet_b0"]``'s. He-normal
    kernels, BatchNorms away from identity, every draw from ``seed``."""
    t, bn = _zoo_draws(seed)

    def conv(cout, cin, k):
        return t(cout, cin, k, k, s=(2.0 / (cin * k * k)) ** 0.5)

    def se(prefix, mid, rd):
        return {f"{prefix}.conv_reduce.weight": t(rd, mid, 1, 1, s=mid ** -0.5),
                f"{prefix}.conv_reduce.bias": t(rd),
                f"{prefix}.conv_expand.weight": t(mid, rd, 1, 1, s=rd ** -0.5),
                f"{prefix}.conv_expand.bias": t(mid)}

    sd = {"conv_stem.weight": conv(stem_ch, 3, 3), **bn("bn1", stem_ch)}
    c_in = stem_ch
    for s_idx, (n, k, _, expand, c_out) in enumerate(stages):
        for j in range(n):
            p = f"blocks.{s_idx}.{j}"
            rd = max(1, int(c_in * se_ratio))
            if expand == 1:
                sd.update({f"{p}.conv_dw.weight": conv(c_in, 1, k), **bn(f"{p}.bn1", c_in),
                           **se(f"{p}.se", c_in, rd),
                           f"{p}.conv_pw.weight": conv(c_out, c_in, 1), **bn(f"{p}.bn2", c_out)})
            else:
                mid = c_in * expand
                sd.update({f"{p}.conv_pw.weight": conv(mid, c_in, 1), **bn(f"{p}.bn1", mid),
                           f"{p}.conv_dw.weight": conv(mid, 1, k), **bn(f"{p}.bn2", mid),
                           **se(f"{p}.se", mid, rd),
                           f"{p}.conv_pwl.weight": conv(c_out, mid, 1), **bn(f"{p}.bn3", c_out)})
            c_in = c_out
    sd.update({"conv_head.weight": conv(head_ch, c_in, 1), **bn("bn2", head_ch),
               "classifier.weight": t(num_classes, head_ch, s=head_ch ** -0.5),
               "classifier.bias": t(num_classes)})
    return sd
