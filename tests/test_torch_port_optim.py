"""The port's LR table and SGD (``device_sgd_update_``) against
mvlpt_tpu/train/optim.py (optax) on fixed gradient sequences."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvlpt_tpu.config import get_cfg_default
from mvlpt_tpu.train.optim import build_lr_schedule as j_schedule
from mvlpt_tpu.train.optim import build_optimizer as j_optimizer

from mvlpt_torch.config import optim_config
from mvlpt_torch.train.optim import build_device_sgd, build_lr_schedule, device_sgd_update_

SCHEDULES = [
    dict(LR_SCHEDULER="cosine", MAX_EPOCH=6),
    dict(LR_SCHEDULER="cosine", MAX_EPOCH=6, WARMUP_EPOCH=2, WARMUP_TYPE="linear"),
    dict(LR_SCHEDULER="cosine", MAX_EPOCH=6, WARMUP_EPOCH=2, WARMUP_TYPE="constant",
         WARMUP_RECOUNT=False),
    dict(LR_SCHEDULER="single_step", MAX_EPOCH=6, STEPSIZE=(2,), GAMMA=0.5),
    dict(LR_SCHEDULER="single_step", MAX_EPOCH=6),
    dict(LR_SCHEDULER="multi_step", MAX_EPOCH=6, STEPSIZE=(1, 4), GAMMA=0.3),
    dict(LR_SCHEDULER="constant", MAX_EPOCH=3),
]


def _configs(**kw):
    ocfg = optim_config(LR=0.01, **kw)
    cfg = get_cfg_default()
    for key, value in ocfg.items():
        setattr(cfg.OPTIM, key, value)
    return cfg.OPTIM, ocfg


def test_defaults_match_jax_config():
    from mvlpt_torch.config import get_cfg_default as t_defaults

    jcfg = get_cfg_default().OPTIM
    assert dict(optim_config()) == dict(jcfg) == dict(t_defaults().OPTIM)


@pytest.mark.parametrize("kw", SCHEDULES)
def test_lr_table_matches(kw):
    jcfg, ocfg = _configs(**kw)
    jf, tf = j_schedule(jcfg, steps_per_epoch=3), build_lr_schedule(ocfg, steps_per_epoch=3)
    for step in range(3 * (ocfg.MAX_EPOCH + 3)):
        assert tf(step) == float(jf(step)), step


@pytest.mark.parametrize("opt", [
    dict(MOMENTUM=0.9, WEIGHT_DECAY=5e-4),
    dict(MOMENTUM=0.9, WEIGHT_DECAY=5e-4, SGD_DAMPNING=0.3),
    dict(MOMENTUM=0.8, WEIGHT_DECAY=1e-3, SGD_NESTEROV=True),
    dict(MOMENTUM=0.0, WEIGHT_DECAY=0.0),
])
def test_sgd_matches_optax_chain(opt):
    jcfg, ocfg = _configs(LR_SCHEDULER="cosine", MAX_EPOCH=5, **opt)
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(7)]

    tx, _ = j_optimizer(jcfg, steps_per_epoch=2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt_t = build_device_sgd(tp, ocfg, steps_per_epoch=2)
    for g in grads:
        device_sgd_update_(tp, [torch.from_numpy(g[k]) for k in ("a", "b")], opt_t)
    for p, k in zip(tp, ("a", "b")):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), atol=1e-6)


def test_unsupported_optimizers_raise():
    with pytest.raises(NotImplementedError):
        build_device_sgd([torch.zeros(1)], optim_config(NAME="adam"), 1)
    with pytest.raises(ValueError):
        build_device_sgd([torch.zeros(1)], optim_config(SGD_DAMPNING=0.1, SGD_NESTEROV=True), 1)
