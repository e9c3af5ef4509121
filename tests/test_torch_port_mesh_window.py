"""The windowed train step and the eval step under a mesh, fp32 on the CPU.

``make_train_step_multi(..., mesh=mesh, capture=False)`` runs a window of
K = 3 steps (two steps an epoch of a cosine table, so the lr changes
inside it) on spawned gloo ranks of (2, 1) and (1, 2) meshes
(tests/torch_port_mesh_child.py, no JAX), each rank holding its data
rank's rows of every batch on the window's axis 1, under 'block' (the
fused half-blocks' twins, their tensor-parallel parts on the model axis).
It is held against:

  * the JAX windowed step under a mesh of the same shape, its window
    sharded (None, "data") and its backbone by ``backbone_partition_specs``
    ('off', which GSPMD partitions): losses 1e-5 rel, grad norms 1e-4, the
    prompt params 2e-4 rel / 1e-6 abs;
  * the port's K single-rank ``make_train_step`` calls on the global
    batches: 1e-6 (tests/test_torch_port_window.py's bound).

The eval step under the data axis gathers the whole batch's logits on
every rank, those of one rank within 1e-5.
"""

import dataclasses
import json
import time

import jax
import numpy as np
import pytest
import torch

from tests import torch_port_mesh_child as child
from tests import torch_port_tp_child as tp
from tests.test_torch_port_slice import BATCH, sides  # noqa: F401 (fixture)
from tests.torch_port_util import collect_ranks, run_rank, spawn_ranks
from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)

MESHES = [(2, 1), (1, 2)]
K, SPE = 3, 2
OPTIM = dict(LR=0.05, LR_SCHEDULER="cosine", MAX_EPOCH=4)
NORM = ((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711))
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def spawned(sides, synthetic_vocab, tmp_path_factory):  # noqa: F811
    """Both meshes' ranks at once; meanwhile the JAX windows on meshes of
    the same shapes, the port's single-rank steps and its single-rank eval."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mvlpt_tpu.config import get_cfg_default
    from mvlpt_tpu.ops import select_attn_fn as j_select
    from mvlpt_tpu.parallel import backbone_partition_specs, shard_tree
    from mvlpt_tpu.parallel.mesh import create_mesh
    from mvlpt_tpu.train.optim import build_optimizer as j_build
    from mvlpt_tpu.train.train_step import init_train_state as j_init
    from mvlpt_tpu.train.train_step import make_train_step_multi as j_multi

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train import init_train_state, make_eval_step, make_train_step
    from mvlpt_torch.utils.tree import tree_leaves

    j_model, j_backbone, j_pp, j_consts = sides["j"]
    model, backbone, pp, consts = sides["t"]
    rng = np.random.RandomState(5)
    window = {"image": rng.randn(K, BATCH, 32, 32, 3).astype(np.float32),
              "label": rng.randint(0, tp.N_CLS, (K, BATCH))}
    eval_image = rng.randint(0, 256, (BATCH + 1, 32, 32, 3)).astype(np.uint8)
    inputs = {**tp.flatten(jax.tree_util.tree_map(np.asarray, j_backbone), "bb"),
              **tp.flatten(jax.tree_util.tree_map(np.asarray, j_pp), "pp"),
              **window, "eval_image": eval_image, "context_length": np.asarray(sides["s"])}
    meta = {"kernels": "block", "optim": OPTIM, "spe": SPE, "norm": NORM}
    runs, deadline = {}, time.monotonic() + SPAWN_TIMEOUT_S
    for n_data, n_model in MESHES:
        work = tmp_path_factory.mktemp(f"window{n_data}x{n_model}")
        np.savez(work / "inputs.npz", **inputs)
        (work / "meta.json").write_text(json.dumps(meta))
        world = n_data * n_model
        runs[(n_data, n_model)] = (spawn_ranks(run_rank, world, world, str(work), child.window,
                                               n_data, n_model, str(work), synthetic_vocab),
                                   work)
    try:
        ref = {}
        cfg = get_cfg_default()
        for key, value in OPTIM.items():
            setattr(cfg.OPTIM, key, value)
        tx, _ = j_build(cfg.OPTIM, steps_per_epoch=SPE)
        j_off = dataclasses.replace(j_model, attn_fn=j_select("off"))
        for n_data, n_model in MESHES:
            jmesh = create_mesh(n_data, n_model, jax.devices()[:n_data * n_model])
            with jmesh:
                jb = shard_tree(j_backbone, backbone_partition_specs(j_backbone), jmesh)
                jw = {k: jax.device_put(v, NamedSharding(jmesh, P(None, "data")))
                      for k, v in window.items()}
                j_state, j_m = j_multi(j_off, tx, donate=False)(
                    j_init(j_pp, tx), jb, j_consts, jw, jax.random.PRNGKey(0))
            ref[(n_data, n_model)] = dict(
                metrics={k: np.asarray(v) for k, v in j_m.items()},
                params=[np.asarray(a) for a in jax.tree_util.tree_leaves(j_state.prompt_params)])
        state = init_train_state(pp, optim_config(**OPTIM), SPE)
        step = make_train_step(model)
        losses = []
        for i in range(K):
            state, m = step(state, backbone, consts,
                            {k: torch.from_numpy(v[i]) for k, v in window.items()})
            losses.append(m["loss"].item())
        ref["single"] = dict(losses=losses, params=[t.detach().numpy().copy() for t in
                                                    tree_leaves(state.prompt_params)])
        ref["eval_logits"] = make_eval_step(model, normalize=NORM)(
            backbone, pp, consts, {"image": torch.from_numpy(eval_image)}).numpy()
    finally:
        out = {}
        for mesh, (procs, work) in runs.items():
            collect_ranks(procs, work, deadline)
            out[mesh] = [dict(np.load(work / f"rank{r}.npz")) for r in range(len(procs))]
    return out, ref


@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "1x2"])
def test_window_matches_jax_window_on_the_mesh(spawned, mesh):
    out, ref = spawned
    want = ref[mesh]
    for got in out[mesh]:
        np.testing.assert_allclose(got["metric/loss"], want["metrics"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metric/acc"], want["metrics"]["acc"], atol=1e-6)
        np.testing.assert_allclose(got["metric/grad_norm"], want["metrics"]["grad_norm"],
                                   rtol=1e-4)
        for i, leaf in enumerate(want["params"]):
            np.testing.assert_allclose(got[f"param{i}"], leaf, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "1x2"])
def test_window_matches_single_rank_steps(spawned, mesh):
    """The mesh window against K make_train_step calls on one rank, and
    bit-equal across the ranks."""
    out, ref = spawned
    for got in out[mesh]:
        np.testing.assert_allclose(got["metric/loss"], ref["single"]["losses"], rtol=1e-6,
                                   atol=1e-6)
        for i, leaf in enumerate(ref["single"]["params"]):
            np.testing.assert_allclose(got[f"param{i}"], leaf, atol=1e-6)
            np.testing.assert_array_equal(got[f"param{i}"], out[mesh][0][f"param{i}"])


@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "1x2"])
def test_eval_step_gathers_the_whole_batch(spawned, mesh):
    """An eval batch of 5 rows (padded to divide over the data ranks, cut
    back): every rank holds all 5 rows' logits, those of one rank."""
    out, ref = spawned
    for got in out[mesh]:
        assert got["eval_logits"].shape == ref["eval_logits"].shape
        np.testing.assert_allclose(got["eval_logits"], ref["eval_logits"], atol=1e-5, rtol=1e-5)
