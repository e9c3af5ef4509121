"""The port's eval path against the JAX package, fp32 on the CPU.

The tiny UPT config of tests/test_torch_port_slice.py, with the kernel
selection passed explicitly to both sides (on the CPU the JAX "auto"
resolves to its XLA path): 'block' (fused half-blocks, the no-grad
forwards at eval) and 'on' (the standalone fused attention). The JAX
kernels run in interpret mode, the port's as plain twins. Logits are
held to 1e-4; three SGD steps under 'on' to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_slice import BATCH, N_CLS, sides  # noqa: F401 (fixture)
from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)

from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD

NORM = (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)


def _models(sides, selection):  # noqa: F811
    """(JAX model, port model) under one USE_PALLAS selection."""
    from mvlpt_tpu.ops import select_attn_fn as j_select
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.ops.attention import select_attn_fn

    j_model = sides["j"][0]
    model = sides["t"][0]
    return (dataclasses.replace(j_model, attn_fn=j_select(selection)),
            MVLPTModel(model.clip_cfg, model.spec, kernels=select_attn_fn(selection),
                       compute_dtype=model.compute_dtype))


def _batches(n=2, seed=7):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randint(0, 256, (BATCH, 32, 32, 3)).astype(np.uint8),
             "label": rng.randint(0, N_CLS, BATCH)} for _ in range(n)]


@pytest.mark.parametrize("selection", ["block", "on"])
def test_eval_steps_match_jax_and_each_other(sides, selection):  # noqa: F811
    from mvlpt_tpu.train.train_step import (
        make_cached_text_eval as j_cached, make_eval_step as j_eval)
    from mvlpt_torch.train import make_cached_text_eval, make_eval_step

    _, j_backbone, j_pp, j_consts = sides["j"]
    _, backbone, pp, consts = sides["t"]
    j_model, model = _models(sides, selection)
    j_step = j_eval(j_model, normalize=NORM)
    j_text_fn, j_eval_fn = j_cached(j_model, normalize=NORM)
    step = make_eval_step(model, normalize=NORM)
    text_fn, eval_fn = make_cached_text_eval(model, normalize=NORM)

    j_tf = j_text_fn(j_backbone, j_pp, j_consts)
    tf = text_fn(backbone, pp, consts)
    assert not tf.requires_grad
    np.testing.assert_allclose(tf.numpy(), np.asarray(j_tf), atol=1e-5)
    for bt in _batches():
        jb = {"image": jnp.asarray(bt["image"])}
        tb = {"image": torch.from_numpy(bt["image"])}
        want = np.asarray(j_step(j_backbone, j_pp, j_consts, jb))
        np.testing.assert_allclose(np.asarray(j_eval_fn(j_backbone, j_pp, j_tf, jb)), want,
                                   atol=1e-4)
        full = step(backbone, pp, consts, tb)
        cached = eval_fn(backbone, pp, tf, tb)
        assert not full.requires_grad and not cached.requires_grad
        np.testing.assert_allclose(full.numpy(), want, atol=1e-4)
        np.testing.assert_array_equal(cached.numpy(), full.numpy())


def test_inference_model_is_a_new_model(sides):  # noqa: F811
    from mvlpt_torch.ops.block import BlockKernels
    from mvlpt_torch.train.train_step import _inference_model

    _, block_model = _models(sides, "block")
    infer = _inference_model(block_model)
    assert infer is not block_model
    assert infer.kernels == BlockKernels(inference=True)
    assert block_model.kernels == BlockKernels(inference=False)
    assert (infer.clip_cfg, infer.spec, infer.compute_dtype) == (
        block_model.clip_cfg, block_model.spec, block_model.compute_dtype)
    assert _inference_model(infer) is infer
    for selection in ("on", "off"):
        _, model = _models(sides, selection)
        kernels = model.kernels
        assert _inference_model(model) is model and model.kernels is kernels


def test_block_eval_runs_the_no_grad_kernels(sides):  # noqa: F811
    """Under 'block' the eval towers go through the inference half-blocks
    (no residuals, so no backward): differentiating the eval forward
    outside no_grad fails loudly, as the JAX inference kernels do."""
    from mvlpt_torch.train.train_step import _inference_model

    _, backbone, pp, consts = sides["t"]
    _, model = _models(sides, "block")
    x = torch.from_numpy(np.random.RandomState(1).randn(BATCH, 32, 32, 3).astype(np.float32))
    logits = _inference_model(model)(backbone, pp, consts, x.requires_grad_(True))
    with pytest.raises(NotImplementedError, match="no-grad eval kernel"):
        logits.sum().backward()


def test_three_sgd_steps_match_under_standalone_attention(sides):  # noqa: F811
    from mvlpt_tpu.config import get_cfg_default
    from mvlpt_tpu.ops.attention import pallas_attention
    from mvlpt_tpu.train.optim import build_optimizer as j_build
    from mvlpt_tpu.train.train_step import init_train_state as j_init, make_train_step as j_step

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.ops.attention import fused_attention
    from mvlpt_torch.train import init_train_state, make_train_step
    from mvlpt_torch.utils.tree import tree_leaves

    _, j_backbone, j_pp, j_consts = sides["j"]
    _, backbone, pp, consts = sides["t"]
    j_model, model = _models(sides, "on")
    assert j_model.attn_fn is pallas_attention and model.kernels is fused_attention
    rng = np.random.RandomState(5)
    batches = [{"image": rng.randn(BATCH, 32, 32, 3).astype(np.float32),
                "label": rng.randint(0, N_CLS, BATCH)} for _ in range(3)]

    cfg = get_cfg_default()
    ocfg = optim_config(LR=0.05, LR_SCHEDULER="cosine", MAX_EPOCH=4)
    for key in ("LR", "LR_SCHEDULER", "MAX_EPOCH"):
        setattr(cfg.OPTIM, key, getattr(ocfg, key))
    tx, _ = j_build(cfg.OPTIM, steps_per_epoch=1)
    j_state = j_init(j_pp, tx)
    step = j_step(j_model, tx, donate=False)
    j_losses = []
    for bt in batches:
        j_state, m = step(j_state, j_backbone, j_consts,
                          {k: jnp.asarray(v) for k, v in bt.items()}, jax.random.PRNGKey(0))
        j_losses.append(float(m["loss"]))

    state = init_train_state(pp, ocfg, steps_per_epoch=1)
    t_step = make_train_step(model)
    losses = []
    for bt in batches:
        state, m = t_step(state, backbone, consts, {k: torch.from_numpy(v) for k, v in bt.items()})
        losses.append(m["loss"].item())

    np.testing.assert_allclose(losses, j_losses, atol=1e-5)
    for jp, tp in zip(jax.tree_util.tree_leaves(j_state.prompt_params),
                      tree_leaves(state.prompt_params)):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-5)
