"""Per-layer activation checkpointing (TRAINER.ACT_CKPT > 1:
``MVLPTModel(remat=True)``, ``core.layers.transformer(remat=True)``) on the
CPU in fp32: bit-equal to no remat (logits, loss, prompt grads, and the
prompt params after 3 SGD steps, per step and in a window), each block's
forward run twice and its backward once, and equal to the JAX package's
remat at the slice's tolerances. The tiny UPT config of
tests/test_torch_port_slice.py (deep VPT, so the injection sits between
checkpointed blocks), with k-hot multitask labels and task ranges."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import synthetic_vocab, two_sides  # noqa: F401 (fixture)

N_CLS, BATCH, STEPS = 12, 4, 3


@pytest.fixture(scope="module")
def sides(synthetic_vocab):  # noqa: F811
    out = two_sides(N_CLS)
    rng = np.random.RandomState(11)
    out["batches"] = []
    for _ in range(STEPS):
        label = (rng.rand(BATCH, N_CLS) < 0.2).astype(np.float32)
        label[np.arange(BATCH), rng.randint(0, N_CLS, BATCH)] = 1.0
        out["batches"].append({"image": rng.randn(BATCH, 32, 32, 3).astype(np.float32),
                               "label": label, "task": rng.randint(0, 2, BATCH)})
    return out


def _ranges(torch_side: bool):
    start, end = [0, 5], [5, N_CLS]
    if torch_side:
        from mvlpt_torch.models.custom_clip import TaskClassRanges

        return TaskClassRanges(torch.tensor(start), torch.tensor(end))
    from mvlpt_tpu.models.custom_clip import TaskClassRanges

    return TaskClassRanges(jnp.asarray(start), jnp.asarray(end))


def _with_remat(model, remat: bool, kernels="keep"):
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.ops.attention import select_attn_fn

    return MVLPTModel(model.clip_cfg, model.spec,
                      kernels=model.kernels if kernels == "keep" else select_attn_fn(kernels),
                      compute_dtype=model.compute_dtype, remat=remat)


def _loss_and_grads(model, backbone, pp, consts, batch):
    from mvlpt_torch.train import soft_cross_entropy
    from mvlpt_torch.utils.tree import tree_leaves, tree_map

    params = tree_map(lambda t: t.clone().requires_grad_(True), pp)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(backbone, params, consts, b["image"], tasks=b["task"],
                   task_ranges=_ranges(True))
    loss = soft_cross_entropy(logits, b["label"])
    return logits.detach(), loss.detach(), torch.autograd.grad(loss, tree_leaves(params))


@pytest.mark.parametrize("kernels", ["keep", "off"], ids=["block", "plain"])
def test_remat_is_bit_equal_to_no_remat(sides, kernels):
    model, backbone, pp, consts = sides["t"]
    batch = sides["batches"][0]
    plain = _loss_and_grads(_with_remat(model, False, kernels), backbone, pp, consts, batch)
    remat = _loss_and_grads(_with_remat(model, True, kernels), backbone, pp, consts, batch)
    assert torch.equal(plain[0], remat[0]) and torch.equal(plain[1], remat[1])
    assert len(plain[2]) == len(remat[2])
    for a, b in zip(plain[2], remat[2]):
        assert torch.equal(a, b)


def _sgd_run(model, pp, backbone, consts, batches, window: bool):
    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train import init_train_state, make_train_step, make_train_step_multi
    from mvlpt_torch.utils.tree import tree_leaves

    state = init_train_state(pp, optim_config(LR=0.05, LR_SCHEDULER="cosine", MAX_EPOCH=4), 1)
    if window:
        step = make_train_step_multi(model, _ranges(True))
        stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}
        state, m = step(state, backbone, consts, stacked)
        losses = m["loss"].tolist()
    else:
        step = make_train_step(model, _ranges(True))
        losses = []
        for b in batches:
            state, m = step(state, backbone, consts, {k: torch.from_numpy(v)
                                                      for k, v in b.items()})
            losses.append(m["loss"].item())
    return losses, [t.detach().clone() for t in tree_leaves(state.prompt_params)]


@pytest.mark.parametrize("window", [False, True], ids=["per-step", "window"])
def test_three_sgd_steps_bit_equal_to_no_remat(sides, window):
    model, backbone, pp, consts = sides["t"]
    runs = [_sgd_run(_with_remat(model, r), pp, backbone, consts, sides["batches"], window)
            for r in (False, True)]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_remat_runs_each_forward_twice(sides, monkeypatch):
    """Under remat the backward runs every block's two forwards again (the
    injection outside them) and each backward once: per layer of both
    towers, attn_fwd and mlp_fwd twice, attn_bwd and mlp_bwd once. Without
    remat, once each."""
    from mvlpt_torch.ops import block

    model, backbone, pp, consts = sides["t"]
    n_layers = 2 * 2  # two layers a tower, two towers
    for remat, per in ((False, 1), (True, 2)):
        calls = dict.fromkeys(("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd"), 0)
        with monkeypatch.context() as mp:
            for name in calls:
                def counted(*a, _name=name, _fn=getattr(block, name), **k):
                    calls[_name] += 1
                    return _fn(*a, **k)
                mp.setattr(block, name, counted)
            _loss_and_grads(_with_remat(model, remat), backbone, pp, consts,
                            sides["batches"][0])
        assert calls == {"attn_fwd": per * n_layers, "mlp_fwd": per * n_layers,
                         "attn_bwd": n_layers, "mlp_bwd": n_layers}, (remat, calls)


def test_remat_matches_jax_remat(sides):
    """Three SGD steps of the port's remat against the JAX package's
    (``jax.checkpoint`` a layer), k-hot labels and task ranges."""
    from mvlpt_tpu.config import get_cfg_default
    from mvlpt_tpu.train.optim import build_optimizer as j_build
    from mvlpt_tpu.train.train_step import init_train_state as j_init, make_train_step as j_step

    j_model, j_backbone, j_pp, j_consts = sides["j"]
    model, backbone, pp, consts = sides["t"]
    j_model = dataclasses.replace(j_model, remat=True)
    cfg = get_cfg_default()
    cfg.merge_from_list(["OPTIM.LR", "0.05", "OPTIM.LR_SCHEDULER", "cosine",
                         "OPTIM.MAX_EPOCH", "4"])
    tx, _ = j_build(cfg.OPTIM, steps_per_epoch=1)
    j_state = j_init(j_pp, tx)
    step = j_step(j_model, tx, _ranges(False), donate=False)
    j_losses = []
    for bt in sides["batches"]:
        j_state, m = step(j_state, j_backbone, j_consts,
                          {k: jnp.asarray(v) for k, v in bt.items()}, jax.random.PRNGKey(0))
        j_losses.append(float(m["loss"]))

    losses, leaves = _sgd_run(_with_remat(model, True), pp, backbone, consts, sides["batches"],
                              window=False)
    np.testing.assert_allclose(losses, j_losses, atol=1e-5)
    for jp, tp in zip(jax.tree_util.tree_leaves(j_state.prompt_params), leaves):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


def test_remat_leaves_inference_alone(sides, monkeypatch):
    """Without autograd (eval, cached text) remat checkpoints nothing: each
    block's forward runs once and the logits are the same."""
    from mvlpt_torch.ops import block

    model, backbone, pp, consts = sides["t"]
    images = torch.from_numpy(sides["batches"][0]["image"])
    calls = []
    attn_fwd = block.attn_fwd
    monkeypatch.setattr(block, "attn_fwd", lambda *a, **k: calls.append(1) or attn_fwd(*a, **k))
    with torch.no_grad():
        outs = [_with_remat(model, r)(backbone, pp, consts, images) for r in (False, True)]
    assert torch.equal(outs[0], outs[1])
    assert len(calls) == 2 * 4  # two runs, four layers in all
