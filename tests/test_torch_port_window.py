"""The windowed multi-step train step (``make_train_step_multi``) and its
device-side SGD against the JAX package, fp32 on the CPU.

The same numpy windows go through ``mvlpt_tpu.train.train_step.
make_train_step_multi`` (its fused-block kernels in interpret mode) and
through the port's, whose steps run eagerly on the CPU with the kernels'
plain twins. Two SGD steps an epoch with a cosine table, so the lr changes
inside a window of three.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_port_util import synthetic_vocab, two_sides  # noqa: F401 (fixture)

N_CLS, BATCH, K, SPE = 6, 4, 3, 2
OPTIM = dict(LR=0.05, LR_SCHEDULER="cosine", MAX_EPOCH=4)
NORM = ((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711))
# Two tasks over the six classes.
RANGES = (np.array([0, 3]), np.array([3, 6]))


@pytest.fixture(scope="module")
def upt(synthetic_vocab):  # noqa: F811
    return two_sides(N_CLS)


@pytest.fixture(scope="module")
def vpt(synthetic_vocab):  # noqa: F811
    """Pure VPT (no CoOp context, no coupler): the text tower is static."""
    return two_sides(N_CLS, coop_n_ctx=0, project_method="identity")


def _jax_optim():
    from mvlpt_tpu.config import get_cfg_default
    from mvlpt_tpu.train.optim import build_optimizer

    cfg = get_cfg_default()
    for key, value in OPTIM.items():
        setattr(cfg.OPTIM, key, value)
    return build_optimizer(cfg.OPTIM, steps_per_epoch=SPE)[0]


def _window(seed, uint8=False, tasks=False, k=K):
    rng = np.random.RandomState(seed)
    shape = (k, BATCH, 32, 32, 3)
    image = (rng.randint(0, 256, shape).astype(np.uint8) if uint8
             else rng.randn(*shape).astype(np.float32))
    out = {"image": image, "label": rng.randint(0, N_CLS, (k, BATCH))}
    if tasks:
        out["task"] = rng.randint(0, 2, (k, BATCH))
    return out


def _torch(batches):
    return {k: torch.from_numpy(v) for k, v in batches.items()}


def _port_window(sides, batches, **kw):
    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train import init_train_state, make_train_step_multi

    model, backbone, pp, consts = sides["t"]
    state = init_train_state(pp, optim_config(**OPTIM), SPE)
    step = make_train_step_multi(model, **kw)
    state, metrics = step(state, backbone, consts, _torch(batches))
    assert step.captures == 0 and step.replays == 0  # the CPU runs the steps eagerly
    return state, metrics


def _per_step(sides, batches, **kw):
    """K calls of the port's make_train_step."""
    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train import init_train_state, make_train_step

    model, backbone, pp, consts = sides["t"]
    state = init_train_state(pp, optim_config(**OPTIM), SPE)
    step = make_train_step(model, **kw)
    losses = []
    for i in range(batches["image"].shape[0]):
        state, m = step(state, backbone, consts, {k: torch.from_numpy(v[i])
                                                  for k, v in batches.items()})
        losses.append(m["loss"].item())
    return state, losses


@pytest.mark.parametrize("pre_embed", [False, True], ids=["per-step-stem", "pre-embed"])
@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8-normalize"])
@pytest.mark.parametrize("spec", ["upt", "vpt"])
def test_window_matches_jax(request, spec, pre_embed, uint8):
    """The stacked loss, accuracy and grad norm, and every prompt leaf after
    a window of K = 3, against the JAX window; the uint8 windows carry
    tasks, so the per-task logit mask runs too. Under pure VPT both
    windows compute the text features once and run forward_with_text."""
    from mvlpt_tpu.models.custom_clip import TaskClassRanges as JRanges
    from mvlpt_tpu.train.train_step import init_train_state as j_init
    from mvlpt_tpu.train.train_step import make_train_step_multi as j_multi

    from mvlpt_torch.models import TaskClassRanges
    from mvlpt_torch.utils.tree import tree_leaves

    sides = request.getfixturevalue(spec)
    j_model, j_backbone, j_pp, j_consts = sides["j"]
    assert j_model.spec.text_is_static is (spec == "vpt")
    batches = _window(3, uint8=uint8, tasks=uint8)
    norm = NORM if uint8 else None
    ranges = RANGES if uint8 else None
    tx = _jax_optim()
    j_step = j_multi(j_model, tx, task_ranges=ranges and JRanges(*map(jnp.asarray, ranges)),
                     donate=False, pre_embed=pre_embed, normalize=norm)
    j_state, j_m = j_step(j_init(j_pp, tx), j_backbone, j_consts,
                          {k: jnp.asarray(v) for k, v in batches.items()}, jax.random.PRNGKey(0))

    state, m = _port_window(
        sides, batches, pre_embed=pre_embed, normalize=norm,
        task_ranges=ranges and TaskClassRanges(*map(torch.from_numpy, ranges)))
    assert state.step == K
    for name in ("loss", "acc"):
        assert m[name].shape == (K,)
        np.testing.assert_allclose(m[name].numpy(), np.asarray(j_m[name]), atol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(j_m["grad_norm"]), atol=1e-4)
    j_leaves = jax.tree_util.tree_leaves(j_state.prompt_params)
    leaves = tree_leaves(state.prompt_params)
    assert len(j_leaves) == len(leaves)
    for jp, tp in zip(j_leaves, leaves):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-5)


def test_window_equals_per_step_calls_on_the_slice_spec(synthetic_vocab):  # noqa: F811
    """tests/test_torch_port_slice.py's spec (20 classes, class-packed text):
    one window of K = 3 against K calls of make_train_step."""
    from mvlpt_torch.utils.tree import tree_leaves

    sides = two_sides(20)
    batches = _window(4)
    batches["label"] = np.random.RandomState(5).randint(0, 20, (K, BATCH))
    state, m = _port_window(sides, batches)
    ref, losses = _per_step(sides, batches)
    np.testing.assert_allclose(m["loss"].numpy(), losses, rtol=1e-6, atol=1e-6)
    for a, b in zip(tree_leaves(state.prompt_params), tree_leaves(ref.prompt_params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)


@pytest.mark.parametrize("pre_embed", [False, True], ids=["per-step-stem", "pre-embed"])
def test_pure_vpt_window_runs_the_text_tower_once(vpt, pre_embed):
    """Pure VPT: text_is_static on both sides, the text tower once a window,
    and the prompts after K steps those of K make_train_step calls."""
    from mvlpt_torch.utils.tree import tree_leaves

    model, _, _, _ = vpt["t"]
    assert model.spec.text_is_static and vpt["j"][0].spec.text_is_static
    calls = []
    text = model.encode_text_prompts
    model.encode_text_prompts = lambda *a, **kw: calls.append(1) or text(*a, **kw)
    try:
        batches = _window(6, uint8=True)
        state, m = _port_window(vpt, batches, pre_embed=pre_embed, normalize=NORM)
        assert len(calls) == 1
        ref, losses = _per_step(vpt, batches, normalize=NORM)
        assert len(calls) == 1 + K
    finally:
        del model.encode_text_prompts
    np.testing.assert_allclose(m["loss"].numpy(), losses, rtol=1e-6, atol=1e-6)
    for a, b in zip(tree_leaves(state.prompt_params), tree_leaves(ref.prompt_params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)


@pytest.mark.parametrize("kw, static", [
    (dict(coop_n_ctx=4), False),
    (dict(vpt_n_ctx=4), True),
    (dict(coop_n_ctx=4, vpt_n_ctx=4), False),
    (dict(coop_n_ctx=4, vpt_n_ctx=4, project_method="identity"), False),
    (dict(vpt_n_ctx=4, cocoop_n_ctx=4), False),
])
def test_text_is_static_matches_jax(kw, static):
    from mvlpt_tpu.prompts import PromptSpec as JSpec
    from mvlpt_torch.prompts import PromptSpec

    assert PromptSpec(n_cls=3, **kw).text_is_static is static
    assert JSpec(n_cls=3, **kw).text_is_static is static


def test_task_mask_logits_unchanged(upt):
    """The task ranges are moved to the device once, by the step builders;
    the masked logits are the JAX package's."""
    from mvlpt_tpu.models.custom_clip import TaskClassRanges as JRanges
    from mvlpt_torch.models import TaskClassRanges
    from mvlpt_torch.models.custom_clip import _apply_task_mask

    j_model, j_backbone, j_pp, j_consts = upt["j"]
    model, backbone, pp, consts = upt["t"]
    batches = _window(7, tasks=True, k=1)
    images, tasks = batches["image"][0], batches["task"][0]
    ranges = TaskClassRanges(*map(torch.from_numpy, RANGES))
    assert ranges.to("cpu").start.dtype == ranges.start.dtype
    want = j_model(j_backbone, j_pp, j_consts, jnp.asarray(images), tasks=jnp.asarray(tasks),
                   task_ranges=JRanges(*map(jnp.asarray, RANGES)))
    with torch.no_grad():
        plain = model(backbone, pp, consts, torch.from_numpy(images))
        got = model(backbone, pp, consts, torch.from_numpy(images),
                    tasks=torch.from_numpy(tasks), task_ranges=ranges)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(got, _apply_task_mask(plain, torch.from_numpy(tasks), ranges))


def test_window_under_a_mesh_raises(upt):
    from mvlpt_torch.train import make_train_step_multi

    with pytest.raises(NotImplementedError, match="mesh"):
        make_train_step_multi(upt["t"][0], mesh=object())


SGD_OPTS = [
    dict(MOMENTUM=0.9, WEIGHT_DECAY=5e-4),
    dict(MOMENTUM=0.9, WEIGHT_DECAY=5e-4, SGD_DAMPNING=0.3),
    dict(MOMENTUM=0.8, WEIGHT_DECAY=1e-3, SGD_NESTEROV=True),
    dict(MOMENTUM=0.0, WEIGHT_DECAY=0.0),
]


@pytest.mark.parametrize("opt", SGD_OPTS, ids=["momentum", "dampening", "nesterov", "plain"])
def test_device_sgd_matches_torch_sgd_and_optax(opt):
    """Seven updates at two steps an epoch (the lr changes at each epoch
    boundary), against torch.optim.SGD with the lr set per step and
    against the JAX package's optax chain, every step within 1e-6."""
    from mvlpt_tpu.config import get_cfg_default
    from mvlpt_tpu.train.optim import build_optimizer as j_optimizer

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train.optim import build_device_sgd, build_lr_schedule, device_sgd_update_

    ocfg = optim_config(LR=0.01, LR_SCHEDULER="cosine", MAX_EPOCH=5, **opt)
    cfg = get_cfg_default()
    for key, value in ocfg.items():
        setattr(cfg.OPTIM, key, value)
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(7)]

    tx, _ = j_optimizer(cfg.OPTIM, steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(jp)
    ref = [torch.from_numpy(params[k].copy()).requires_grad_(True) for k in ("a", "b")]
    sgd = torch.optim.SGD(ref, lr=ocfg.LR, momentum=ocfg.MOMENTUM, dampening=ocfg.SGD_DAMPNING,
                          weight_decay=ocfg.WEIGHT_DECAY, nesterov=ocfg.SGD_NESTEROV)
    schedule = build_lr_schedule(ocfg, steps_per_epoch=2)
    dev = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt_dev = build_device_sgd(dev, ocfg, steps_per_epoch=2)
    for i, g in enumerate(grads):
        updates, j_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, j_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(ref, ("a", "b")):
            p.grad = torch.from_numpy(g[k])
        for group in sgd.param_groups:
            group["lr"] = schedule(i)
        sgd.step()
        device_sgd_update_(dev, [torch.from_numpy(g[k]) for k in ("a", "b")], opt_dev)
        for p, r, k in zip(dev, ref, ("a", "b")):
            np.testing.assert_allclose(p.numpy(), r.detach().numpy(), atol=1e-6, err_msg=k)
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), atol=1e-6, err_msg=k)
    assert int(opt_dev.count) == len(grads)


def test_device_sgd_refuses_what_sgd_refuses():
    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train.optim import build_device_sgd

    with pytest.raises(NotImplementedError):
        build_device_sgd([torch.zeros(1)], optim_config(NAME="adam"), 1)
    with pytest.raises(ValueError):
        build_device_sgd([torch.zeros(1)], optim_config(SGD_DAMPNING=0.1, SGD_NESTEROV=True), 1)


@pytest.mark.parametrize("kw", [
    dict(),
    # The port's synthetic-vocab text shape: s = 18 tokens, G = 7 classes a row.
    dict(text_tokens_per_cls=18, text_pack_classes=7),
    dict(batch=8, n_cls=10, image_tokens=581, vision_width=1024, vision_layers=24,
         text_width=768, patch_tokens=576, patch_dim=588),
], ids=["flagship", "port-text-shape", "vitl336"])
def test_step_flops_match_jax(kw):
    from mvlpt_tpu.utils import flops as jflops
    from mvlpt_torch.utils import flops

    assert flops.flagship_step_flops(**kw) == jflops.flagship_step_flops(**kw)
    assert flops.transformer_matmul_flops(126, 512, 12, attn_token_blocks=[126] * 15) == \
        jflops.transformer_matmul_flops(126, 512, 12, attn_token_blocks=[126] * 15)


@pytest.mark.parametrize("kw", [dict(), dict(batch=32, n_cls=10)], ids=["eval-100", "eval-32"])
def test_eval_flops_match_jax(kw):
    from mvlpt_tpu.utils import flops as jflops
    from mvlpt_torch.utils import flops

    assert flops.eval_step_flops(**kw) == jflops.eval_step_flops(**kw)
    assert flops.transformer_matmul_flops(201, 768, 12, bwd=False) == \
        jflops.transformer_matmul_flops(201, 768, 12, bwd=False)
