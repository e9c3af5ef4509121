"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py).

The JAX package is the reference: the same numpy inputs go through it
and through ``mvlpt_torch`` on the CPU, in fp32. Its Pallas kernels run
in interpret mode there, as in its own tests.
"""

from __future__ import annotations

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
