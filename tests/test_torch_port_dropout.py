"""VPT dropout (``core.layers.dropout``, ``prompts.vpt_prepare``) against
the JAX package, fp32 on the CPU.

The port draws its masks from a counter (``layers.keep_mask``: a hash of
the step's key, the stream and the element index), where the JAX package
draws ``jax.random.bernoulli`` under threefry keys; the bits differ by
design. The parity tests carry the JAX masks into the port through the
one hook on the mask draw (``layers.keep_mask``), so both sides drop the
same elements: ``vpt_prepare`` 1e-6, one train step's logits 1e-4, loss
1e-5 and grads 1e-4 x max|grad|. The port's own draws: one mask a step
shared across the batch, the kept share, the eager window bit-equal to
one step a call with dropout live, and new masks on every step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import synthetic_vocab, two_sides  # noqa: F401 (fixture)

RATE = 0.25
N_CLS = 5


@pytest.fixture(scope="module")
def sides(synthetic_vocab):  # noqa: F811
    return two_sides(N_CLS, vpt_dropout=RATE)


def _jax_masks(sides, rng) -> dict:
    """The JAX package's two draws (vpt_prepare's k1 and k2) by stream, at
    the shapes of the coupled shallow and deep rows."""
    from mvlpt_tpu.prompts.assembly import upt_couple

    j_model, _, j_pp, _ = sides["j"]
    _, sh, dp = upt_couple(j_pp, j_model.spec)
    k1, k2 = jax.random.split(rng)
    keep = 1.0 - RATE
    return {0: np.asarray(jax.random.bernoulli(k1, keep, sh.shape)),
            1: np.asarray(jax.random.bernoulli(k2, keep, dp.shape))}


def _carry(monkeypatch, masks: dict, calls: list | None = None):
    """Make the port's mask draw return ``masks[stream]``."""
    from mvlpt_torch.core import layers

    def keep_mask(key, stream, shape, keep):
        assert keep == 1.0 - RATE and tuple(masks[stream].shape) == tuple(shape)
        if calls is not None:
            calls.append(stream)
        return torch.tensor(masks[stream])

    monkeypatch.setattr(layers, "keep_mask", keep_mask)


def test_vpt_prepare_matches_jax_with_carried_masks(sides, monkeypatch):
    from mvlpt_tpu.prompts.assembly import upt_couple as j_couple, vpt_prepare as j_prepare

    from mvlpt_torch.prompts import upt_couple, vpt_prepare

    j_model, _, j_pp, _ = sides["j"]
    model, _, pp, _ = sides["t"]
    rng = jax.random.PRNGKey(3)
    masks = _jax_masks(sides, rng)
    calls: list = []
    _carry(monkeypatch, masks, calls)
    _, j_sh, j_dp = j_couple(j_pp, j_model.spec)
    want = j_prepare(j_pp, j_model.spec, j_sh, j_dp, rng)
    _, sh, dp = upt_couple(pp, model.spec)
    got = vpt_prepare(pp, model.spec, sh, dp, torch.zeros((), dtype=torch.int64))
    assert calls == [0, 1]  # separate draws for the shallow and the deep rows
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-6, rtol=0)
    # some elements dropped, the rest scaled by 1 / (1 - rate)
    assert 0 < (got[1] == 0).sum() < got[1].numel()
    # eval (no key) drops nothing
    plain = vpt_prepare(pp, model.spec, sh, dp, None)
    kept = torch.from_numpy(masks[1])
    np.testing.assert_allclose(got[1][kept].detach().numpy(),
                               (plain[1][kept] / (1 - RATE)).detach().numpy(), rtol=1e-6)


def test_train_step_matches_jax_with_carried_masks(sides, monkeypatch):
    """Logits 1e-4, loss 1e-5, grads 1e-4 x max|grad| of one step with the
    same masks on both sides."""
    from mvlpt_tpu.train.train_step import soft_cross_entropy as j_ce

    from mvlpt_torch.train import soft_cross_entropy
    from mvlpt_torch.utils.tree import tree_leaves

    j_model, j_backbone, j_pp, j_consts = sides["j"]
    model, backbone, pp, consts = sides["t"]
    rng_np = np.random.RandomState(0)
    images = rng_np.randn(3, 32, 32, 3).astype(np.float32)
    labels = rng_np.randint(0, N_CLS, 3)
    rng = jax.random.PRNGKey(11)
    _carry(monkeypatch, _jax_masks(sides, rng))

    def j_loss(p):
        logits = j_model(j_backbone, p, j_consts, jnp.asarray(images), rng=rng)
        return j_ce(logits, jnp.asarray(labels)), logits

    (j_l, j_logits), j_g = jax.value_and_grad(j_loss, has_aux=True)(j_pp)
    leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(pp)]
    from mvlpt_torch.checkpoint import unflatten_params
    from mvlpt_torch.utils.tree import tree_keys

    params = unflatten_params(dict(zip(tree_keys(pp), leaves)))
    logits = model(backbone, params, consts, torch.from_numpy(images),
                   rng=torch.zeros((), dtype=torch.int64))
    loss = soft_cross_entropy(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(j_l), atol=1e-5)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(j_g)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-4 * max(np.abs(jg).max(), 1e-12))
    # the dropout is live: without it the logits move
    plain = model(backbone, pp, consts, torch.from_numpy(images))
    assert not torch.allclose(plain, logits.detach(), atol=1e-4)


def test_one_mask_a_step_shared_across_the_batch(sides):
    """Identical images give identical features under dropout: one mask a
    step, drawn before the broadcast (the JAX package's choice)."""
    from mvlpt_torch.core.layers import dropout_key
    from mvlpt_torch.prompts import upt_couple

    model, backbone, pp, _ = sides["t"]
    image = torch.from_numpy(np.random.RandomState(1).randn(1, 32, 32, 3).astype(np.float32))
    key = dropout_key(torch.tensor(7), torch.tensor(2))
    _, sh, dp = upt_couple(pp, model.spec)
    with torch.no_grad():
        feats = model.encode_image(backbone, pp, image.expand(4, -1, -1, -1), sh, dp, rng=key)
        plain = model.encode_image(backbone, pp, image, sh, dp)
    assert all(torch.equal(feats[0], f) for f in feats[1:])
    assert not torch.allclose(feats[0], plain[0])


@pytest.mark.parametrize("keep", [0.9, 0.75, 0.5])
def test_kept_share(keep):
    """The kept share of 200,000 draws within 5 sigma of ``keep``, for two
    keys and two streams; ``dropout`` scales what it keeps by 1 / keep."""
    from mvlpt_torch.core.layers import dropout, dropout_key, keep_mask

    n = 200_000
    sigma = (keep * (1 - keep) / n) ** 0.5
    for count in (0, 1):
        for stream in (0, 1):
            mask = keep_mask(dropout_key(torch.tensor(131), torch.tensor(count)), stream, (n,),
                             keep)
            assert abs(mask.float().mean().item() - keep) < 5 * sigma, (count, stream)
    x = torch.rand(1000) + 1.0
    y = dropout(x, 1 - keep, dropout_key(torch.tensor(0), torch.tensor(0)))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / keep)
    assert torch.equal(dropout(x, 0.0, torch.tensor(0)), x)
    assert torch.equal(dropout(x, 0.3, None), x)


def test_masks_change_from_step_to_step():
    """The mask is a function of (seed, count, stream, element): the same
    arguments draw the same mask, a new count, seed or stream a new one."""
    from mvlpt_torch.core.layers import dropout_key, keep_mask

    def mask(seed, count, stream=0):
        return keep_mask(dropout_key(torch.tensor(seed), torch.tensor(count)), stream, (4, 768),
                         0.9)

    assert torch.equal(mask(131, 5), mask(131, 5))
    for other in (mask(131, 6), mask(132, 5), mask(131, 5, 1)):
        assert not torch.equal(mask(131, 5), other)


def _window_batches(k=3):
    rng = np.random.RandomState(4)
    return {"image": torch.from_numpy(rng.randn(k, 4, 32, 32, 3).astype(np.float32)),
            "label": torch.from_numpy(rng.randint(0, N_CLS, (k, 4)))}


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_eager_window_equals_per_step_calls_with_dropout(sides, monkeypatch, name):
    """A window of K = 3 and three make_train_step calls from the same state
    and seed: losses, accuracies, grad norms and prompt leaves bit-equal;
    each step drew new masks (recorded from the real draw)."""
    from mvlpt_torch.config import optim_config
    from mvlpt_torch.core import layers
    from mvlpt_torch.train import init_train_state, make_train_step, make_train_step_multi
    from mvlpt_torch.utils.tree import tree_leaves

    model, backbone, pp, consts = sides["t"]
    ocfg = optim_config(NAME=name, LR=0.05, MAX_EPOCH=4)
    batches = _window_batches()
    drawn: list = []
    real = layers.keep_mask
    monkeypatch.setattr(layers, "keep_mask",
                        lambda *a: drawn.append(real(*a)) or drawn[-1])
    window_state = init_train_state(pp, ocfg, 2)
    window_state.seed.fill_(131)
    _, m = make_train_step_multi(model)(window_state, backbone, consts, batches)
    window_masks, drawn[:] = list(drawn), []
    step_state, step = init_train_state(pp, ocfg, 2), make_train_step(model)
    step_state.seed.fill_(131)
    metrics = [step(step_state, backbone, consts, {k: v[i] for k, v in batches.items()})[1]
               for i in range(3)]
    for key in m:
        assert torch.equal(m[key], torch.stack([x[key] for x in metrics])), key
    for a, b in zip(tree_leaves(window_state.prompt_params), tree_leaves(step_state.prompt_params)):
        assert torch.equal(a, b)
    assert len(window_masks) == len(drawn) == 6  # two streams a step
    for a, b in zip(window_masks, drawn):
        assert torch.equal(a, b)
    shallow = window_masks[::2]
    assert not torch.equal(shallow[0], shallow[1]) and not torch.equal(shallow[1], shallow[2])
    # and a second seed trains differently
    other = init_train_state(pp, ocfg, 2)
    other.seed.fill_(132)
    _, m2 = make_train_step_multi(model)(other, backbone, consts, batches)
    assert not torch.equal(m["loss"], m2["loss"])


def test_no_dropout_draws_nothing(synthetic_vocab, monkeypatch):  # noqa: F811
    """Rate 0 (the default) never reaches the mask draw."""
    from mvlpt_torch.config import optim_config
    from mvlpt_torch.core import layers
    from mvlpt_torch.train import init_train_state, make_train_step

    model, backbone, pp, consts = two_sides(N_CLS)["t"]
    monkeypatch.setattr(layers, "keep_mask", lambda *a: pytest.fail("drew a mask"))
    state = init_train_state(pp, optim_config(), 1)
    batch = {k: v[0] for k, v in _window_batches(1).items()}
    make_train_step(model)(state, backbone, consts, batch)
