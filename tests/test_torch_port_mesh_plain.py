"""'off' under a mesh with a model axis, against the JAX package, fp32 on
the CPU ('on' is tests/test_torch_port_mesh_on.py, on this file's set-up).

The port runs the plain layers ('off', and for 'on' the standalone
attention, its plain twin here) on each model rank's Megatron shard
(``core.layers.sharded_residual_block``: ``parallel.copy_to_model`` on
entry, ``parallel.reduce_from_model`` on the row-parallel partials), on
spawned gloo ranks of (1, 2) and (2, 2) meshes (tests/
torch_port_mesh_child.py, which never imports JAX). The JAX side runs the
same selection on a mesh of the same shape over the virtual CPU devices,
its backbone placed by ``backbone_partition_specs`` and its batch over
"data", which GSPMD partitions. Tolerances are tests/test_torch_port_tp.py's:
block forward 5e-6 abs / 1e-5 rel, dx 5e-6 / 1e-4, one SGD step's loss
1e-5 rel and prompt params 2e-4 rel / 1e-6 abs, eval logits 1e-4.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_port_mesh_child as child
from tests import torch_port_tp_child as tp
from tests.test_torch_port_slice import BATCH, N_CLS, sides  # noqa: F401 (fixture)
from tests.test_torch_port_tp import _block_inputs
from tests.torch_port_util import collect_ranks, run_rank, spawn_ranks
from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)

MESHES = [(1, 2), (2, 2)]
SPAWN_TIMEOUT_S = 240


def _j_select(sel):
    from mvlpt_tpu.ops import select_attn_fn

    return select_attn_fn(sel)


def _jax_block(p, x, gy, mask, sel):
    """The JAX plain residual block under ``sel``: (y, dx)."""
    from mvlpt_tpu.core import layers as jlayers

    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jm = None if mask is None else jnp.asarray(mask)
    attn_fn = _j_select(sel)

    def f(xx):
        return jlayers.residual_block(xx, jp, tp.BLOCK_HEADS, jm, attn_fn=attn_fn)

    y, vjp = jax.vjp(f, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(gy))
    return np.asarray(y), np.asarray(dx)


def spawn_and_reference(sel, sides, vocab, tmp_path_factory):
    """Both meshes' ranks under ``sel``, run at once, with the JAX
    references computed meanwhile in this process: the block, the SGD step
    and the cached-text eval on a JAX mesh of the same shape."""
    from mvlpt_tpu.config import get_cfg_default
    from mvlpt_tpu.parallel import backbone_partition_specs, batch_specs, shard_tree
    from mvlpt_tpu.parallel.mesh import create_mesh
    from mvlpt_tpu.train.optim import build_optimizer as j_build
    from mvlpt_tpu.train.train_step import init_train_state as j_init
    from mvlpt_tpu.train.train_step import make_cached_text_eval as j_cached
    from mvlpt_tpu.train.train_step import make_train_step as j_step

    from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD

    j_model, j_backbone, j_pp, j_consts = sides["j"]
    p, x, gy, mask = _block_inputs()
    rng = np.random.RandomState(9)
    batch = {"image": rng.randn(BATCH, 32, 32, 3).astype(np.float32),
             "label": rng.randint(0, N_CLS, BATCH)}
    eval_image = rng.randint(0, 256, (BATCH, 32, 32, 3)).astype(np.uint8)
    inputs = {**tp.flatten(p, "blk"),
              **tp.flatten(jax.tree_util.tree_map(np.asarray, j_backbone), "bb"),
              **tp.flatten(jax.tree_util.tree_map(np.asarray, j_pp), "pp"),
              "x": x, "gy": gy, "mask": mask, **batch, "eval_image": eval_image,
              "context_length": np.asarray(sides["s"])}
    runs, deadline = {}, time.monotonic() + SPAWN_TIMEOUT_S
    for n_data, n_model in MESHES:
        work = tmp_path_factory.mktemp(f"{sel}{n_data}x{n_model}")
        np.savez(work / "inputs.npz", **inputs)
        world = n_data * n_model
        runs[(n_data, n_model)] = (spawn_ranks(run_rank, world, world, str(work), child.plain,
                                               n_data, n_model, str(work), vocab, sel), work)
    try:
        ref = {name: _jax_block(p, x, gy, m, sel) for name, m in (("none", None),
                                                                  ("causal", mask))}
        cfg = get_cfg_default()
        for key, value in tp.OPTIM.items():
            setattr(cfg.OPTIM, key, value)
        tx, _ = j_build(cfg.OPTIM, steps_per_epoch=1)
        j_sel = dataclasses.replace(j_model, attn_fn=_j_select(sel))
        for n_data, n_model in MESHES:
            jmesh = create_mesh(n_data, n_model, jax.devices()[:n_data * n_model])
            with jmesh:
                jb = shard_tree(j_backbone, backbone_partition_specs(j_backbone), jmesh)
                jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
                jbatch = shard_tree(jbatch, batch_specs(jbatch), jmesh)
                j_state, j_metrics = j_step(j_sel, tx, donate=False)(
                    j_init(j_pp, tx), jb, j_consts, jbatch, jax.random.PRNGKey(0))
                text_fn, eval_fn = j_cached(j_sel, normalize=(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD))
                jimg = {"image": jnp.asarray(eval_image)}
                jimg = shard_tree(jimg, batch_specs(jimg), jmesh)
                logits = np.asarray(eval_fn(jb, j_pp, text_fn(jb, j_pp, j_consts), jimg))
            ref[(n_data, n_model)] = dict(
                loss=float(j_metrics["loss"]), eval_logits=logits,
                params=[np.asarray(a) for a in jax.tree_util.tree_leaves(j_state.prompt_params)])
    finally:
        out = {}
        for mesh, (procs, work) in runs.items():
            collect_ranks(procs, work, deadline)
            out[mesh] = [dict(np.load(work / f"rank{r}.npz")) for r in range(len(procs))]
    return out, ref


@pytest.fixture(scope="module")
def spawned(sides, synthetic_vocab, tmp_path_factory):  # noqa: F811
    return spawn_and_reference("off", sides, synthetic_vocab, tmp_path_factory)


def check_block(spawned, mesh):
    """One block on each rank's rows and shard, through the model
    group's all-reduces, against the JAX block on the full weights."""
    out, ref = spawned
    n_data, n_model = mesh
    per = BATCH // n_data
    for r, got in enumerate(out[mesh]):
        rows = slice((r // n_model) * per, (r // n_model + 1) * per)
        for name in ("none", "causal"):
            want_y, want_dx = ref[name]
            np.testing.assert_allclose(got[f"y_{name}"], want_y[rows], atol=5e-6, rtol=1e-5)
            np.testing.assert_allclose(got[f"dx_{name}"], want_dx[rows], atol=5e-6, rtol=1e-4)


def check_sgd_step(spawned, mesh):
    """One SGD step of the tiny UPT step: the loss and the prompt params
    against the JAX step on its mesh of the same shape, and bit-equal on
    every rank."""
    out, ref = spawned
    want = ref[mesh]
    for got in out[mesh]:
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
        for i, leaf in enumerate(want["params"]):
            np.testing.assert_allclose(got[f"param{i}"], leaf, rtol=2e-4, atol=1e-6)
            np.testing.assert_array_equal(got[f"param{i}"], out[mesh][0][f"param{i}"])


def check_cached_text_eval(spawned, mesh):
    """The cached-text eval of the whole batch on every rank (each data
    rank's rows, gathered over the data group) against the JAX eval on
    its mesh."""
    out, ref = spawned
    for got in out[mesh]:
        np.testing.assert_allclose(got["eval_logits"], ref[mesh]["eval_logits"], atol=1e-4)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_block_forward_and_dx_match_jax(spawned, mesh):
    check_block(spawned, mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_sgd_step_matches_jax(spawned, mesh):
    check_sgd_step(spawned, mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_cached_text_eval_matches_jax(spawned, mesh):
    check_cached_text_eval(spawned, mesh)
