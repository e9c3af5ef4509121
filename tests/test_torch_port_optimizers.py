"""The port's device Adam, AdamW and RMSprop (``train.optim.device_update_``)
against the JAX package's optax chains (``mvlpt_tpu.train.optim.
build_optimizer``), FinetuneCLIP's STAGED_LR groups against
``build_finetune_optimizer``, each optimizer in the K = 3 window against
K per-step calls, and their state across a resume from a JAX-written and
a port-written checkpoint. fp32 on the CPU; 1e-6 a parameter."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvlpt_tpu.config import get_cfg_default
from mvlpt_tpu.train.optim import build_optimizer as j_optimizer

from mvlpt_torch.config import optim_config
from mvlpt_torch.train.optim import build_device_optimizer, device_update_
from tests.test_torch_port_trainer import (  # noqa: F401 (fixtures)
    _argv, _run, env, init_dir, synthetic_vocab, world)
from tests.torch_port_util import two_sides

# Five updates at two a epoch with a linear warmup epoch: the lr moves at
# each epoch boundary.
SCHED = dict(LR=0.01, LR_SCHEDULER="cosine", MAX_EPOCH=4, WARMUP_EPOCH=1,
             WARMUP_TYPE="linear", WARMUP_MIN_LR=1e-3)
SPE, UPDATES = 2, 5
OPTIMIZERS = [
    dict(NAME="adam"), dict(NAME="adam", WEIGHT_DECAY=0.05),
    dict(NAME="adamw"), dict(NAME="adamw", WEIGHT_DECAY=0.05, ADAM_BETA1=0.8, ADAM_BETA2=0.99),
    dict(NAME="rmsprop"), dict(NAME="rmsprop", WEIGHT_DECAY=0.05, RMSPROP_ALPHA=0.9),
]
IDS = ["adam", "adam-wd", "adamw", "adamw-wd-betas", "rmsprop", "rmsprop-wd-alpha"]
KEYS = ("a", "b")


def _configs(**kw):
    """(the JAX OPTIM node, the port's) with the same values."""
    ocfg = optim_config(**{**SCHED, "WEIGHT_DECAY": 0.0, **kw})
    cfg = get_cfg_default()
    for key, value in ocfg.items():
        setattr(cfg.OPTIM, key, value)
    return cfg.OPTIM, ocfg


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(UPDATES)]
    return params, grads


def _optax_run(tx, params, grads, state=None):
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp) if state is None else state
    out = []
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        out.append({k: np.asarray(v) for k, v in jp.items()})
    return out, state


@pytest.mark.parametrize("kw", OPTIMIZERS, ids=IDS)
def test_update_matches_optax_chain(kw):
    """Each of the five updates, across the warmup and two epoch
    boundaries: 1e-6."""
    jcfg, ocfg = _configs(**kw)
    params, grads = _problem()
    want, _ = _optax_run(j_optimizer(jcfg, steps_per_epoch=SPE)[0], params, grads)
    tp = [torch.from_numpy(params[k].copy()) for k in KEYS]
    opt = build_device_optimizer(tp, ocfg, SPE)
    for i, g in enumerate(grads):
        device_update_(tp, [torch.from_numpy(g[k]) for k in KEYS], opt)
        for p, k in zip(tp, KEYS):
            np.testing.assert_allclose(p.numpy(), want[i][k], atol=1e-6, rtol=0,
                                       err_msg=f"update {i}: {k}")
    assert int(opt.count) == UPDATES


@pytest.mark.parametrize("staged", [False, True], ids=["one-lr", "staged-lr"])
@pytest.mark.parametrize("name", ["sgd", "adamw", "rmsprop"])
def test_staged_lr_matches_finetune_optimizer(name, staged):
    """FinetuneCLIP's groups: "head" at LR, the rest at LR * BASE_LR_MULT
    (each group's own lr table, the warmup's lrs unscaled, as the JAX
    package's trunk config has them), against optax.multi_transform."""
    from mvlpt_tpu.train.finetune import build_finetune_optimizer as j_build

    from mvlpt_torch.train.finetune import build_finetune_optimizer
    from mvlpt_torch.utils.tree import tree_keys, tree_leaves

    jcfg, ocfg = _configs(NAME=name, WEIGHT_DECAY=0.01, STAGED_LR=staged, BASE_LR_MULT=0.1,
                          MOMENTUM=0.9)
    rng = np.random.RandomState(1)
    params = {"head": {"kernel": rng.randn(6, 3).astype(np.float32),
                       "bias": rng.randn(3).astype(np.float32)},
              "visual": {"w": rng.randn(4, 6).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(lambda v: rng.randn(*v.shape).astype(np.float32), params)
             for _ in range(UPDATES)]
    tx, j_schedule = j_build(jcfg, SPE)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = tx.init(jp)

    state, schedule = build_finetune_optimizer(
        jax.tree_util.tree_map(torch.from_numpy, params), ocfg, SPE)
    assert [schedule(i) for i in range(8)] == [float(j_schedule(i)) for i in range(8)]
    leaves, keys = tree_leaves(state.prompt_params), tree_keys(state.prompt_params)
    assert state.opt.group == tuple((0 if k.startswith("head.") or not staged else 1)
                                    for k in keys)
    for i, g in enumerate(grads):
        updates, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), j_state, jp)
        jp = optax.apply_updates(jp, updates)
        device_update_(leaves, [torch.from_numpy(v) for v in jax.tree_util.tree_leaves(g)],
                       state.opt)
        for leaf, ref in zip(leaves, jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(ref), atol=1e-6,
                                       rtol=0, err_msg=f"update {i}")


@pytest.fixture(scope="module")
def upt(synthetic_vocab):  # noqa: F811
    return two_sides(6)


@pytest.mark.parametrize("kw", OPTIMIZERS[::2], ids=IDS[::2])
def test_window_equals_per_step_calls(upt, kw):
    """A window of K = 3 (two steps an epoch, so the lr moves inside it)
    against three calls of make_train_step from the same state: losses and
    prompt leaves 1e-6, the optimizer slots too."""
    from mvlpt_torch.train import init_train_state, make_train_step, make_train_step_multi
    from mvlpt_torch.utils.tree import tree_leaves

    model, backbone, pp, consts = upt["t"]
    _, ocfg = _configs(**kw)
    rng = np.random.RandomState(7)
    batches = {"image": torch.from_numpy(rng.randn(3, 4, 32, 32, 3).astype(np.float32)),
               "label": torch.from_numpy(rng.randint(0, 6, (3, 4)))}
    window_state = init_train_state(pp, ocfg, SPE)
    _, m = make_train_step_multi(model)(window_state, backbone, consts, batches)
    step_state, step = init_train_state(pp, ocfg, SPE), make_train_step(model)
    losses = [step(step_state, backbone, consts, {k: v[i] for k, v in batches.items()})[1]
              ["loss"].item() for i in range(3)]
    np.testing.assert_allclose(m["loss"].numpy(), losses, rtol=1e-6, atol=1e-6)
    for a, b in zip(tree_leaves(window_state.prompt_params),
                    tree_leaves(step_state.prompt_params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)
    for a, b in zip(window_state.opt.tensors(), step_state.opt.tensors()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def _optax_state_of(tx, params, slots: dict, step: int, name: str):
    """An optax state of ``tx`` over ``params`` holding the port's slots
    and the update count ``step``."""
    from mvlpt_tpu.train.trainer import _fast_forward_schedule

    state = _fast_forward_schedule(tx.init(params), step)
    tree = lambda flat: jax.tree_util.tree_map(  # noqa: E731
        jnp.asarray, _unflatten(flat))
    if name == "rmsprop":
        return (state[0]._replace(nu=tree(slots["nu"])),) + tuple(state[1:])
    return (state[0]._replace(mu=tree(slots["mu"]), nu=tree(slots["nu"])),) + tuple(state[1:])


def _unflatten(flat: dict) -> dict:
    from mvlpt_torch.checkpoint import unflatten_params

    return jax.tree_util.tree_map(np.asarray, unflatten_params(dict(flat)))


@pytest.mark.parametrize("name", ["adamw", "rmsprop"])
def test_resume_takes_the_optimizer_state(env, init_dir, tmp_path, monkeypatch, name):
    """A one-epoch run of each package with an epoch checkpoint; a port
    trainer resumes from each: it takes the run's step and its Adam mu and
    nu (or RMSprop's nu), from optax's ScaleByAdamState (ScaleByRmsState)
    in the JAX payload and from the port's own slots; its next update from
    the same gradients equals optax's from that state (1e-6). An SGD
    checkpoint resumes an Adam run with fresh state and the JAX package's
    note."""
    from mvlpt_tpu.checkpoint import prompt_io as j_io
    from mvlpt_tpu.config import get_cfg_default as j_defaults
    from mvlpt_tpu.train.optim import build_optimizer

    from mvlpt_torch.train.optim import SLOTS
    from mvlpt_torch.train.trainer import _payload_key
    from mvlpt_torch.utils.tree import tree_keys, tree_leaves

    opts = ("OPTIM.NAME", name, "OPTIM.MAX_EPOCH", "1", "TRAIN.CHECKPOINT_FREQ", "1",
            "TEST.NO_TEST", "True", "TEST.FINAL_MODEL", "last_step")
    argv = ["--model-dir", init_dir, "--shots", "4"]
    for package in ("jax", "port"):
        _run(package, _argv(env, tmp_path / package, *argv, opts=opts), monkeypatch)
    trainer, _ = _run("port", _argv(env, tmp_path / "resumer", "--no-train", *argv, opts=opts),
                      monkeypatch)
    kind = trainer.state.opt.kind
    keys = tree_keys(trainer.state.prompt_params)
    jcfg = j_defaults()
    for key, value in trainer.cfg.OPTIM.items():
        setattr(jcfg.OPTIM, key, value)
    tx = build_optimizer(jcfg.OPTIM, trainer.steps_per_epoch)[0]
    grads = [np.random.RandomState(3).randn(*t.shape).astype(np.float32)
             for t in tree_leaves(trainer.state.prompt_params)]
    for package in ("jax", "port"):
        payload = j_io.load_prompt_checkpoint(j_io.checkpoint_path(str(tmp_path / package), 1))
        trainer.resume_from_checkpoint(str(tmp_path / package))
        assert trainer.state.step == payload["step"] == trainer.steps_per_epoch
        if package == "jax":
            inner = payload["opt_state"][0]
            want = {slot: {k: np.asarray(v) for k, v in
                           _flat_tree(getattr(inner, slot)).items()} for slot in SLOTS[kind]}
        else:
            want = {slot: payload[_payload_key(kind, slot)] for slot in SLOTS[kind]}
        for slot in SLOTS[kind]:
            for k, t in zip(keys, trainer.state.opt.slots[slot]):
                np.testing.assert_array_equal(t.numpy(), want[slot][k], err_msg=f"{slot} {k}")
        params = {k: t.detach().numpy().copy() for k, t in
                  zip(keys, tree_leaves(trainer.state.prompt_params))}
        jp = jax.tree_util.tree_map(jnp.asarray, _unflatten(params))
        j_state = _optax_state_of(tx, jp, want, payload["step"], name)
        updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, _unflatten(
            dict(zip(keys, grads)))), j_state, jp)
        ref = _flat_tree(optax.apply_updates(jp, updates))
        leaves = tree_leaves(trainer.state.prompt_params)
        device_update_(leaves, [torch.from_numpy(g) for g in grads], trainer.state.opt)
        for k, t in zip(keys, leaves):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(ref[k]), atol=1e-6,
                                       rtol=0, err_msg=f"{package}: {k}")

    # another optimizer's state: fresh slots, the JAX package's note
    sgd_dir = tmp_path / "sgd"
    _run("port", _argv(env, sgd_dir, *argv, opts=opts[2:]), monkeypatch)
    import io
    import sys

    saved, sys.stdout = sys.stdout, io.StringIO()
    try:
        trainer.resume_from_checkpoint(str(sgd_dir))
        printed = sys.stdout.getvalue()
    finally:
        sys.stdout = saved
    assert "optimizer state in checkpoint incompatible" in printed
    assert all(not t.any() for slot in SLOTS[kind] for t in trainer.state.opt.slots[slot])


def _flat_tree(tree) -> dict:
    from mvlpt_torch.checkpoint import flatten_params

    return flatten_params(jax.tree_util.tree_map(np.asarray, tree))
