"""CoCoOp in the port against the JAX package, fp32 on the CPU.

Two tiny configs on the two-sided CLIP of tests/torch_port_util.py
(two layers a tower, narrow widths; the JAX side's fused-block kernels
in interpret mode, the port's plain twins): the ``CoCoOp`` trainer's
spec (a conditioned context only) and MVLPT with deep VPT and
``TRAINER.MVLPT.COCOOP.N_CTX``. Weights come from the JAX side and are
carried across by mvlpt_torch.checkpoint.from_jax; images and labels
come from numpy seeds. Each image conditions its own prompts, so the
text tower runs B x n_cls prompts, ``chunk`` images' grids a call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import synthetic_vocab, two_sides  # noqa: F401 (fixture)

N_CLS, BATCH, STEPS, K = 6, 4, 3, 3
OPTIM = dict(LR=0.05, LR_SCHEDULER="cosine", MAX_EPOCH=4)
SPECS = {"cocoop": dict(coop_n_ctx=0, vpt_n_ctx=0, cocoop_n_ctx=2, project_method="identity"),
         "vpt_cocoop": dict(coop_n_ctx=0, vpt_n_ctx=2, cocoop_n_ctx=2,
                            project_method="identity")}


@pytest.fixture(scope="module")
def sides(synthetic_vocab):  # noqa: F811
    out = {name: two_sides(N_CLS, **kw) for name, kw in SPECS.items()}
    rng = np.random.RandomState(21)
    out["batches"] = [{"image": rng.randn(BATCH, 32, 32, 3).astype(np.float32),
                       "label": rng.randint(0, N_CLS, BATCH)} for _ in range(STEPS)]
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(model, remat):
    """The port's model with ``remat`` replaced."""
    from mvlpt_torch.models import MVLPTModel

    return MVLPTModel(model.clip_cfg, model.spec, kernels=model.kernels,
                      compute_dtype=model.compute_dtype, remat=remat)


def _set_chunk(monkeypatch, chunk):
    """Make the port's _auto_chunk give ``chunk`` images a text-tower call
    at BATCH x N_CLS (None: its own rule, here the whole batch)."""
    from mvlpt_torch.models import custom_clip

    if chunk is not None:
        monkeypatch.setattr(custom_clip, "COCOOP_CHUNK_ROWS", chunk * N_CLS)
    assert custom_clip._auto_chunk(BATCH, N_CLS) == (chunk or BATCH)


def _loss_and_grads(model, backbone, pp, consts, batch):
    from mvlpt_torch.train import soft_cross_entropy
    from mvlpt_torch.utils.tree import tree_leaves, tree_map

    params = tree_map(lambda t: t.clone().requires_grad_(True), pp)
    b = _torch(batch)
    logits = model(backbone, params, consts, b["image"])
    loss = soft_cross_entropy(logits, b["label"])
    return logits.detach(), loss.detach(), torch.autograd.grad(loss, tree_leaves(params))


def _jax_loss_and_grads(j_model, j_backbone, j_pp, j_consts, batch):
    from mvlpt_tpu.train.train_step import soft_cross_entropy

    def f(pp):
        logits = j_model(j_backbone, pp, j_consts, jnp.asarray(batch["image"]))
        return soft_cross_entropy(logits, jnp.asarray(batch["label"])), logits

    (loss, logits), grads = jax.value_and_grad(f, has_aux=True)(j_pp)
    return np.asarray(logits), float(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(
        grads)]


def _close_grads(grads, j_grads, rel=1e-4):
    assert len(grads) == len(j_grads)
    for tg, jg in zip(grads, j_grads):
        assert tuple(tg.shape) == jg.shape
        scale = max(1.0, float(np.abs(jg).max()))
        np.testing.assert_allclose(tg.numpy() / scale, jg / scale, atol=rel)


def test_params_and_consts_carry_over(sides):
    """The cocoop subtree (ctx, meta_net.linear{1,2}) has the same keys and
    shapes on both sides, from each package's own init, and the consts
    (prefix, suffix at n_ctx = COCOOP.N_CTX, EOT) are the same."""
    from mvlpt_tpu.prompts import init_prompt_params as jinit

    from mvlpt_torch.checkpoint import flatten_params
    from mvlpt_torch.prompts import init_prompt_params

    for name in SPECS:
        j_model, j_backbone, j_pp, j_consts = sides[name]["j"]
        model, backbone, pp, consts = sides[name]["t"]
        own = init_prompt_params(torch.Generator().manual_seed(1), model.spec, "cpu")
        j_flat = flatten_params(jax.tree_util.tree_map(np.asarray, jinit(
            jax.random.PRNGKey(1), j_model.spec)))
        flat = flatten_params(own)
        assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in j_flat.items()}
        assert "cocoop.meta_net.linear1.kernel" in flat and "cocoop.ctx" in flat
        assert flat["cocoop.meta_net.linear1.kernel"].shape == (32, 2)  # embed_dim // 16
        for k, v in flatten_params(jax.tree_util.tree_map(np.asarray, j_pp)).items():
            np.testing.assert_array_equal(flatten_params(pp)[k], v, err_msg=k)
        np.testing.assert_array_equal(consts.eot_idx.numpy(), np.asarray(j_consts.eot_idx))
        np.testing.assert_array_equal(consts.token_suffix.numpy(),
                                      np.asarray(j_consts.token_suffix))
        assert consts.perm is None and j_consts.perm is None


def test_cocoop_condition_matches(sides):
    """The meta-net bias (Linear, ReLU, Linear in fp32) on the shared ctx."""
    from mvlpt_tpu.prompts import cocoop_condition as j_condition

    from mvlpt_torch.prompts import cocoop_condition

    j_model, _, j_pp, _ = sides["cocoop"]["j"]
    model, _, pp, _ = sides["cocoop"]["t"]
    feats = np.random.RandomState(2).randn(BATCH, 32).astype(np.float32)
    want = j_condition(j_pp, j_model.spec, jnp.asarray(feats))
    got = cocoop_condition(pp, model.spec, torch.from_numpy(feats))
    assert got.shape == (BATCH, 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_ctx_init_from_words_matches(sides):
    """COCOOP.CTX_INIT: the context from the init words' token embeddings,
    by the port's own tokenizer."""
    from mvlpt_tpu.prompts import PromptSpec as JSpec, init_prompt_params as jinit

    from mvlpt_torch.prompts import PromptSpec, init_prompt_params

    _, j_backbone, _, _ = sides["cocoop"]["j"]
    _, backbone, _, _ = sides["cocoop"]["t"]
    kw = dict(n_cls=N_CLS, cocoop_n_ctx=3, text_width=64, embed_dim=32)
    want = jinit(jax.random.PRNGKey(0), JSpec(**kw), j_backbone, cocoop_ctx_init="a_photo of")
    got = init_prompt_params(torch.Generator().manual_seed(0), PromptSpec(**kw), "cpu",
                             backbone, cocoop_ctx_init="a_photo of")
    np.testing.assert_array_equal(got["cocoop"]["ctx"].numpy(),
                                  np.asarray(want["cocoop"]["ctx"]))


@pytest.mark.parametrize("auto", [(4, 6), (32, 500), (32, 199), (100, 500), (7, 5000)])
def test_auto_chunk_matches(auto):
    from mvlpt_tpu.models.custom_clip import _auto_chunk as j_auto

    from mvlpt_torch.models.custom_clip import _auto_chunk

    assert _auto_chunk(*auto) == j_auto(*auto)


@pytest.mark.parametrize("chunk", [1, 2, None], ids=["chunk1", "chunk2", "auto"])
@pytest.mark.parametrize("name", list(SPECS))
def test_forward_matches(sides, name, chunk, monkeypatch):
    """Logits at 1e-4, loss at 1e-5 and prompt grads at 1e-4 x max for each
    chunk size (None: _auto_chunk, here the whole batch in one call)."""
    j_model, j_backbone, j_pp, j_consts = sides[name]["j"]
    model, backbone, pp, consts = sides[name]["t"]
    batch = sides["batches"][0]
    j_logits, j_loss, j_grads = _jax_loss_and_grads(
        dataclasses.replace(j_model, cocoop_chunk=chunk), j_backbone, j_pp, j_consts, batch)
    _set_chunk(monkeypatch, chunk)
    logits, loss, grads = _loss_and_grads(model, backbone, pp, consts, batch)
    assert logits.shape == (BATCH, N_CLS)
    np.testing.assert_allclose(logits.numpy(), j_logits, atol=1e-4)
    np.testing.assert_allclose(loss.item(), j_loss, atol=1e-5)
    _close_grads(grads, j_grads)


def test_text_features_raise_and_no_cached_eval(sides):
    """CoCoOp's text features depend on the image: compute_text_features
    raises and make_cached_text_eval gives (None, None) on both sides."""
    from mvlpt_tpu.train.train_step import make_cached_text_eval as j_cached

    from mvlpt_torch.train import make_cached_text_eval

    j_model, j_backbone, j_pp, j_consts = sides["cocoop"]["j"]
    model, backbone, pp, consts = sides["cocoop"]["t"]
    assert j_cached(j_model) == (None, None)
    assert make_cached_text_eval(model) == (None, None)
    with pytest.raises(ValueError, match="image-conditioned"):
        model.compute_text_features(backbone, pp, consts)
    with pytest.raises(ValueError, match="image-conditioned"):
        j_model.compute_text_features(j_backbone, j_pp, j_consts)


@pytest.mark.parametrize("name", list(SPECS))
def test_eval_step_matches(sides, name, monkeypatch):
    """make_eval_step's logits (both towers, no grad), chunk 2, at 1e-4."""
    from mvlpt_tpu.train.train_step import make_eval_step as j_eval

    from mvlpt_torch.train import make_eval_step

    j_model, j_backbone, j_pp, j_consts = sides[name]["j"]
    model, backbone, pp, consts = sides[name]["t"]
    images = sides["batches"][1]["image"]
    want = j_eval(dataclasses.replace(j_model, cocoop_chunk=2))(
        j_backbone, j_pp, j_consts, {"image": jnp.asarray(images)})
    _set_chunk(monkeypatch, 2)
    got = make_eval_step(model)(backbone, pp, consts, {"image": torch.from_numpy(images)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _jax_tx():
    from mvlpt_tpu.config import get_cfg_default
    from mvlpt_tpu.train.optim import build_optimizer

    cfg = get_cfg_default()
    for key, value in OPTIM.items():
        setattr(cfg.OPTIM, key, value)
    return build_optimizer(cfg.OPTIM, steps_per_epoch=2)[0]


@pytest.mark.parametrize("name", list(SPECS))
def test_three_sgd_steps_match(sides, name):
    """Losses at 1e-5 and every prompt leaf after 3 SGD steps at 1e-5
    (two steps an epoch of a cosine table)."""
    from mvlpt_tpu.train.train_step import init_train_state as j_init
    from mvlpt_tpu.train.train_step import make_train_step as j_step

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train import init_train_state, make_train_step
    from mvlpt_torch.utils.tree import tree_leaves

    j_model, j_backbone, j_pp, j_consts = sides[name]["j"]
    model, backbone, pp, consts = sides[name]["t"]
    tx = _jax_tx()
    j_state, step = j_init(j_pp, tx), j_step(j_model, tx, donate=False)
    state, t_step = init_train_state(pp, optim_config(**OPTIM), 2), make_train_step(model)
    j_losses, losses = [], []
    for bt in sides["batches"]:
        j_state, m = step(j_state, j_backbone, j_consts,
                          {k: jnp.asarray(v) for k, v in bt.items()}, jax.random.PRNGKey(0))
        j_losses.append(float(m["loss"]))
        state, m = t_step(state, backbone, consts, _torch(bt))
        losses.append(m["loss"].item())
    np.testing.assert_allclose(losses, j_losses, atol=1e-5)
    for jp, tp in zip(jax.tree_util.tree_leaves(j_state.prompt_params),
                      tree_leaves(state.prompt_params)):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-5)


@pytest.mark.parametrize("pre_embed", [False, True], ids=["per-step-stem", "pre-embed"])
@pytest.mark.parametrize("name", list(SPECS))
def test_window_matches_jax(sides, name, pre_embed):
    """make_train_step_multi at K = 3 against the JAX window: losses and
    accuracies 1e-5, grad norms 1e-4, prompt leaves 1e-5; and against K
    calls of the port's make_train_step, 1e-6. CoCoOp's text tower runs
    every step (its text is not static)."""
    from mvlpt_tpu.train.train_step import init_train_state as j_init
    from mvlpt_tpu.train.train_step import make_train_step_multi as j_multi

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train import init_train_state, make_train_step, make_train_step_multi
    from mvlpt_torch.utils.tree import tree_leaves

    j_model, j_backbone, j_pp, j_consts = sides[name]["j"]
    model, backbone, pp, consts = sides[name]["t"]
    assert not model.spec.text_is_static
    batches = {k: np.stack([b[k] for b in sides["batches"]]) for k in ("image", "label")}
    tx = _jax_tx()
    j_state, j_m = j_multi(j_model, tx, donate=False, pre_embed=pre_embed)(
        j_init(j_pp, tx), j_backbone, j_consts, {k: jnp.asarray(v) for k, v in batches.items()},
        jax.random.PRNGKey(0))

    state = init_train_state(pp, optim_config(**OPTIM), 2)
    step = make_train_step_multi(model, pre_embed=pre_embed)
    state, m = step(state, backbone, consts, _torch(batches))
    assert step.captures == 0 and state.step == K
    for key in ("loss", "acc"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(j_m[key]), atol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(j_m["grad_norm"]), atol=1e-4)
    leaves = tree_leaves(state.prompt_params)
    for jp, tp in zip(jax.tree_util.tree_leaves(j_state.prompt_params), leaves):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-5)

    ref = init_train_state(pp, optim_config(**OPTIM), 2)
    per_step = make_train_step(model)
    losses = []
    for bt in sides["batches"]:
        ref, mm = per_step(ref, backbone, consts, _torch(bt))
        losses.append(mm["loss"].item())
    np.testing.assert_allclose(m["loss"].numpy(), losses, rtol=1e-6, atol=1e-6)
    for a, b in zip(leaves, tree_leaves(ref.prompt_params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)


# Past COCOOP_REMAT_ROWS: 5 x 1700 = 8500 conditioned rows at the
# two-sided CLIP's widths, one image a chunk (_auto_chunk: 5 x 1700 >
# 4096).
REMAT_CLASSES, REMAT_BATCH = 1700, 5


@pytest.fixture(scope="module")
def remat_side(synthetic_vocab):  # noqa: F811
    """The CoCoOp spec on the port's side only, at REMAT_CLASSES classes."""
    return two_sides(REMAT_CLASSES, **SPECS["cocoop"])["t"]


def _counted(monkeypatch):
    """Count the half-block kernels' wrapper calls by name."""
    from mvlpt_torch.ops import block

    calls = dict.fromkeys(("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd"), 0)
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(block, name), **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(block, name, counted)
    return calls


@pytest.mark.parametrize("act_ckpt", [1, 4], ids=["act_ckpt1", "act_ckpt4"])
def test_chunk_remat_past_8192_rows_is_bit_equal(remat_side, act_ckpt, monkeypatch):
    """B x n_cls = 8500 conditioned rows, past COCOOP_REMAT_ROWS = 8192:
    each chunk's tower is checkpointed (the backward runs the text tower's
    forwards a second time), nested under ACT_CKPT > 1 with the per-layer
    remat (a third). Logits, loss and prompt grads equal, bit for bit,
    those of no remat at all (ACT_CKPT 1 and the chunk rule off)."""
    from mvlpt_torch.models import custom_clip

    model, backbone, pp, consts = remat_side
    assert REMAT_BATCH * REMAT_CLASSES > custom_clip.COCOOP_REMAT_ROWS == 8192
    assert custom_clip._auto_chunk(REMAT_BATCH, REMAT_CLASSES) == 1
    rng = np.random.RandomState(8)
    batch = {"image": rng.randn(REMAT_BATCH, 32, 32, 3).astype(np.float32),
             "label": rng.randint(0, REMAT_CLASSES, REMAT_BATCH)}
    runs = {}
    for remat in (True, False):
        with monkeypatch.context() as mp:
            if not remat:
                mp.setattr(custom_clip, "COCOOP_REMAT_ROWS", 1 << 62)
            calls = _counted(mp)
            runs[remat] = _loss_and_grads(_model(model, remat=remat and act_ckpt > 1),
                                          backbone, pp, consts, batch)
        # the text tower: 2 layers a chunk call, REMAT_BATCH calls, each
        # forward once more under each checkpoint; the image tower (no
        # trained parameter, no backward): 2 layers once
        per = 1 + (remat and act_ckpt > 1) + remat
        text, image = 2 * REMAT_BATCH, 2
        assert calls == {"attn_fwd": per * text + image, "mlp_fwd": per * text + image,
                         "attn_bwd": text, "mlp_bwd": text}, (remat, calls)
    (la, lo_a, ga), (lb, lo_b, gb) = runs[True], runs[False]
    assert torch.equal(la, lb) and torch.equal(lo_a, lo_b)
    assert len(ga) == len(gb) == 5  # ctx, meta_net.linear{1,2}
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)


@pytest.mark.parametrize("act_ckpt", [1, 4], ids=["act_ckpt1", "act_ckpt4"])
def test_chunk_remat_grads_match_jax(sides, act_ckpt, monkeypatch):
    """The chunk checkpoint (forced on: every batch past the rule) with
    ACT_CKPT 1 and > 1, against the JAX package's remat model (its chunk
    and per-layer jax.checkpoint): logits 1e-4, loss 1e-5, grads 1e-4."""
    from mvlpt_torch.models import custom_clip

    j_model, j_backbone, j_pp, j_consts = sides["vpt_cocoop"]["j"]
    model, backbone, pp, consts = sides["vpt_cocoop"]["t"]
    batch = sides["batches"][2]
    j_logits, j_loss, j_grads = _jax_loss_and_grads(
        dataclasses.replace(j_model, remat=True, cocoop_chunk=2), j_backbone, j_pp, j_consts,
        batch)
    monkeypatch.setattr(custom_clip, "COCOOP_REMAT_ROWS", 0)
    _set_chunk(monkeypatch, 2)
    logits, loss, grads = _loss_and_grads(_model(model, remat=act_ckpt > 1),
                                          backbone, pp, consts, batch)
    np.testing.assert_allclose(logits.numpy(), j_logits, atol=1e-4)
    np.testing.assert_allclose(loss.item(), j_loss, atol=1e-5)
    _close_grads(grads, j_grads)
