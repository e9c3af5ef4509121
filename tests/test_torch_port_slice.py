"""The port's slice end to end against the JAX package, fp32 on the CPU.

A tiny UPT config (CoOp ctx 'middle', deep VPT, coupler; two layers a
tower, narrow widths, after __graft_entry__.py:_tiny_flagship) with the
fused-block kernels selected on the JAX side (interpret mode) and on the
port (plain twins on the CPU). The text tower runs class-packed with
padding. Weights and inputs come from the JAX side or from numpy seeds
and are carried across by mvlpt_torch.checkpoint.from_jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import synthetic_vocab, two_sides  # noqa: F401 (fixture)

N_CLS, BATCH = 20, 4


@pytest.fixture(scope="module")
def sides(synthetic_vocab):  # noqa: F811
    out = two_sides(N_CLS)
    rng = np.random.RandomState(0)
    out["images"] = rng.randn(BATCH, 32, 32, 3).astype(np.float32)
    out["labels"] = rng.randint(0, N_CLS, BATCH)
    return out


def test_text_tower_is_packed(sides):
    from mvlpt_torch.core.text import packing

    g, rows = packing(N_CLS, sides["s"])
    assert g > 1 and rows * g > N_CLS  # packed, with zero-padded classes


def test_consts_match(sides):
    _, _, _, jc = sides["j"]
    _, _, _, tc = sides["t"]
    np.testing.assert_array_equal(tc.tokenized, jc.tokenized)
    np.testing.assert_array_equal(tc.eot_idx.numpy(), np.asarray(jc.eot_idx))
    np.testing.assert_array_equal(tc.perm.numpy(), np.asarray(jc.perm))
    np.testing.assert_array_equal(tc.token_suffix.numpy(), np.asarray(jc.token_suffix))


def _loss_jax(j_model, j_backbone, j_consts, images, labels):
    from mvlpt_tpu.train.train_step import soft_cross_entropy

    def f(pp):
        logits = j_model(j_backbone, pp, j_consts, jnp.asarray(images))
        return soft_cross_entropy(logits, jnp.asarray(labels)), logits
    return f


def test_logits_loss_and_prompt_grads_match(sides):
    from mvlpt_torch.train import soft_cross_entropy
    from mvlpt_torch.utils.tree import tree_leaves, tree_map

    j_model, j_backbone, j_pp, j_consts = sides["j"]
    model, backbone, pp, consts = sides["t"]
    images, labels = sides["images"], sides["labels"]

    (j_loss, j_logits), j_grads = jax.jit(jax.value_and_grad(
        _loss_jax(j_model, j_backbone, j_consts, images, labels), has_aux=True))(j_pp)

    params = tree_map(lambda t: t.clone().requires_grad_(True), pp)
    leaves = tree_leaves(params)
    logits = model(backbone, params, consts, torch.from_numpy(images))
    loss = soft_cross_entropy(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, leaves)

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(j_leaves) == len(grads)
    for jg, tg in zip(j_leaves, grads):
        jg = np.asarray(jg)
        assert jg.shape == tuple(tg.shape)
        scale = max(1.0, float(np.abs(jg).max()))
        np.testing.assert_allclose(tg.numpy() / scale, jg / scale, atol=1e-4)


def test_three_sgd_steps_match(sides):
    from mvlpt_tpu.config import get_cfg_default
    from mvlpt_tpu.train.optim import build_optimizer as j_build
    from mvlpt_tpu.train.train_step import init_train_state as j_init, make_train_step as j_step

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train import init_train_state, make_train_step
    from mvlpt_torch.utils.tree import tree_leaves

    j_model, j_backbone, j_pp, j_consts = sides["j"]
    model, backbone, pp, consts = sides["t"]
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
        state, m = t_step(state, backbone, consts,
                          {k: torch.from_numpy(v) for k, v in bt.items()})
        losses.append(m["loss"].item())

    np.testing.assert_allclose(losses, j_losses, atol=1e-5)
    for jp, tp in zip(jax.tree_util.tree_leaves(j_state.prompt_params),
                      tree_leaves(state.prompt_params)):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-5)


def test_uint8_stem_with_normalize_fold_matches(sides):
    """embed_image on raw uint8 pixels, CLIP normalisation folded into the
    patch embedding, as the train step runs it with ``normalize``."""
    from mvlpt_tpu.core import vit as jvit
    from mvlpt_torch.core import vit
    from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD

    _, j_backbone, _, _ = sides["j"]
    _, backbone, _, _ = sides["t"]
    u8 = np.random.RandomState(3).randint(0, 256, (BATCH, 32, 32, 3)).astype(np.uint8)
    norm = (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
    want = jvit.embed_image(j_backbone["visual"], jnp.asarray(u8), 8, normalize=norm)
    got = vit.embed_image(backbone["visual"], torch.from_numpy(u8), 8, normalize=norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(
        vit.patchify(torch.from_numpy(u8), 8).numpy(), np.asarray(jvit.patchify(jnp.asarray(u8), 8)))


def test_task_mask_loss_and_accuracy_match():
    from mvlpt_tpu.models.custom_clip import TaskClassRanges as JRanges
    from mvlpt_tpu.models.custom_clip import _apply_task_mask as j_mask
    from mvlpt_tpu.train.train_step import accuracy as j_acc
    from mvlpt_tpu.train.train_step import soft_cross_entropy as j_ce
    from mvlpt_torch.models.custom_clip import TaskClassRanges, _apply_task_mask
    from mvlpt_torch.train import accuracy, soft_cross_entropy

    rng = np.random.RandomState(4)
    logits = (rng.randn(6, 10) * 5).astype(np.float32)
    tasks = rng.randint(0, 2, 6)
    start, end = np.array([0, 4]), np.array([4, 10])
    want = j_mask(jnp.asarray(logits), jnp.asarray(tasks),
                  JRanges(jnp.asarray(start), jnp.asarray(end)))
    got = _apply_task_mask(torch.from_numpy(logits), torch.from_numpy(tasks),
                           TaskClassRanges(torch.from_numpy(start), torch.from_numpy(end)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for labels in (rng.randint(0, 10, 6), (rng.rand(6, 10) > 0.7).astype(np.float32)):
        np.testing.assert_allclose(
            soft_cross_entropy(got, torch.from_numpy(labels)).item(),
            float(j_ce(want, jnp.asarray(labels))), rtol=1e-6)
        assert accuracy(got, torch.from_numpy(labels)).item() == float(
            j_acc(want, jnp.asarray(labels)))


def test_coop_ctx_init_from_words_matches(sides):
    """CoOp context initialised from the embeddings of init words."""
    from mvlpt_tpu.prompts import PromptSpec as JSpec, init_prompt_params as jinit
    from mvlpt_torch.prompts import PromptSpec, init_prompt_params

    _, j_backbone, _, _ = sides["j"]
    _, backbone, _, _ = sides["t"]
    kw = dict(n_cls=N_CLS, coop_n_ctx=3, vpt_n_ctx=0, text_width=64, project_method="identity")
    want = jinit(jax.random.PRNGKey(0), JSpec(**kw), j_backbone, coop_ctx_init="a_photo of")
    got = init_prompt_params(torch.Generator().manual_seed(0), PromptSpec(**kw), "cpu",
                             backbone, coop_ctx_init="a_photo of")
    assert list(got) == ["coop"]
    np.testing.assert_array_equal(got["coop"]["ctx"].numpy(), np.asarray(want["coop"]["ctx"]))


@pytest.mark.parametrize("method", ["transformer", "transformer_seq", "mlp", "identity"])
def test_upt_couple_matches(method):
    """The UPT coupler for each PROJECT_METHOD, fp32, on the same params."""
    from mvlpt_tpu.prompts import PromptSpec as JSpec, init_prompt_params as jinit
    from mvlpt_tpu.prompts import upt_couple as j_couple
    from mvlpt_torch.checkpoint import prompt_params_from_jax
    from mvlpt_torch.prompts import PromptSpec, upt_couple

    kw = dict(n_cls=3, coop_n_ctx=2, vpt_n_ctx=2, vpt_deep=True, project_method=method,
              project_dim=16, vision_layers=3, vision_width=24, text_width=20,
              vision_patch_size=4)
    j_pp = jinit(jax.random.PRNGKey(2), JSpec(**kw))
    pp = prompt_params_from_jax(jax.tree_util.tree_map(np.asarray, j_pp), "cpu")
    for want, got in zip(j_couple(j_pp, JSpec(**kw)), upt_couple(pp, PromptSpec(**kw))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_bf16_backbone_and_token_embedding_carry_over(sides):
    from mvlpt_tpu.core import text as jtext
    from mvlpt_tpu.core.clip import cast_backbone as j_cast
    from mvlpt_torch.checkpoint import backbone_from_jax
    from mvlpt_torch.core import text

    _, j_backbone, _, jc = sides["j"]
    jb16 = j_cast(j_backbone, jnp.bfloat16)
    b16 = backbone_from_jax(jax.tree_util.tree_map(np.asarray, jb16), "cpu")
    assert b16["text"]["token_embedding"].dtype == torch.bfloat16
    assert b16["logit_scale"].dtype == torch.float32
    ids = np.asarray(jc.tokenized)
    want = jtext.embed_tokens(jb16["text"], jnp.asarray(ids))
    got = text.embed_tokens(b16["text"], torch.from_numpy(ids))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
