"""The port's tensor-parallel slice against the JAX package, fp32 on the CPU.

The JAX side runs its Megatron-sharded kernels (attn_block_tp /
mlp_block_tp, part=True Pallas bodies in interpret mode) on a 2x2 mesh of
the 8 virtual CPU devices of tests/conftest.py. The port runs its part
twins: summed over the shards in this process, and on gloo meshes of
spawned ranks (tests/torch_port_tp_child.py, which never imports JAX)
whose inputs the parent writes as .npz. Tolerances are those of
tests/test_tp_kernels.py: forward 5e-6 abs / 1e-5 rel, dx 5e-6 / 1e-4,
one SGD step's loss 1e-5 rel and prompt params 2e-4 rel / 1e-6 abs.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlpt_tpu.ops import block as jblock
from tests import torch_port_tp_child as child
from tests.test_torch_port_slice import BATCH, N_CLS, sides  # noqa: F401 (fixture)
from tests.torch_port_util import block_params_np, collect_ranks, spawn_ranks
from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)

from mvlpt_torch.ops import block
from mvlpt_torch.parallel import Mesh, shard_backbone, shard_blocks

S, W, H = 9, 32, child.BLOCK_HEADS
SPAWN_TIMEOUT_S = 240


def _fake_mesh(n_model, model_rank=0):
    """A mesh for code that runs no collective: no process groups."""
    return Mesh(1, n_model, 0, model_rank, None, None)


def _block_inputs():
    rng = np.random.RandomState(11)
    p = block_params_np(rng, W)
    x = rng.randn(BATCH, S, W).astype(np.float32)
    gy = rng.randn(BATCH, S, W).astype(np.float32)
    mask = np.triu(np.full((S, S), -1e9, np.float32), 1)
    return p, x, gy, mask


def _jax_block(p, x, gy, mask, mesh, n_heads=H):
    """JAX fused_residual_block_sharded on ``mesh``: (y, dx)."""
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jm = None if mask is None else jnp.asarray(mask)

    def f(xx):
        with mesh:
            return jblock.fused_residual_block_sharded(xx, jp, n_heads, jm, mesh)

    y, vjp = jax.vjp(f, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(gy))
    return np.asarray(y), np.asarray(dx)


@pytest.fixture(scope="module")
def jmesh():
    from mvlpt_tpu.parallel.mesh import create_mesh

    return create_mesh(2, 2, jax.devices()[:4])


@pytest.fixture(scope="module")
def jax_block_ref(jmesh):
    """{"none" | "causal": (y, dx)} of the JAX sharded block on the 2x2 mesh."""
    p, x, gy, mask = _block_inputs()
    return {name: _jax_block(p, x, gy, m, jmesh) for name, m in (("none", None),
                                                                 ("causal", mask))}


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_backbone_matches_qkv_tp_layout(tp):
    """Each rank's qkv columns are its rows of the JAX _qkv_tp_layout, bit
    for bit, in every layer; out/fc/proj are its Megatron slices; a tower
    whose heads do not divide (text, 2 heads, at tp=4) stays whole."""
    from mvlpt_torch.core.clip import CLIPConfig, init_clip_params

    cfg = CLIPConfig(embed_dim=16, image_resolution=16, vision_layers=2, vision_width=32,
                     vision_patch_size=8, transformer_width=32, transformer_heads=2,
                     transformer_layers=2, vocab_size=64, vision_heads_override=4)
    backbone = init_clip_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    for tower, heads in (("visual", 4), ("text", 2)):
        full = backbone[tower]["blocks"]
        for r in range(tp):
            got = shard_backbone(backbone, cfg, _fake_mesh(tp, r))[tower]["blocks"]
            if heads % tp:
                assert got is full
                continue
            wl, w4l = W // tp, 4 * W // tp
            for layer in range(2):
                at = {k: jnp.asarray(v[layer].numpy()) for k, v in full["attn"].items()}
                w3tp, b3tp = jblock._qkv_tp_layout(at, heads, tp)
                rows = slice(r * 3 * wl, (r + 1) * 3 * wl)
                np.testing.assert_array_equal(got["attn"]["qkv_w"][layer].numpy(),
                                              np.asarray(w3tp)[rows].T)
                np.testing.assert_array_equal(got["attn"]["qkv_b"][layer].numpy(),
                                              np.asarray(b3tp)[rows, 0])
            sl, sl4 = slice(r * wl, (r + 1) * wl), slice(r * w4l, (r + 1) * w4l)
            assert torch.equal(got["attn"]["out_w"], full["attn"]["out_w"][:, sl])
            assert torch.equal(got["mlp"]["fc_w"], full["mlp"]["fc_w"][..., sl4])
            assert torch.equal(got["mlp"]["fc_b"], full["mlp"]["fc_b"][:, sl4])
            assert torch.equal(got["mlp"]["proj_w"], full["mlp"]["proj_w"][:, sl4])
            for key in ("ln_1", "ln_2"):
                assert got[key] is full[key]
            assert got["attn"]["out_b"] is full["attn"]["out_b"]
            assert got["mlp"]["proj_b"] is full["mlp"]["proj_b"]


def _summed_parts(x, p, mask, gy, tp):
    """The port's fused block at tp shards in one process: each half's
    part twins summed over the shards and finished as the all-reduce
    would leave them; dx through _ln_bwd."""
    shards = [shard_blocks(p, H, tp, r) for r in range(tp)]
    hl = H // tp
    ln1, ln2, at, ml = p["ln_1"], p["ln_2"], p["attn"], p["mlp"]
    fa = [block.attn_fwd_part_plain(x, ln1["scale"], ln1["bias"], sh["attn"]["qkv_w"],
                                    sh["attn"]["qkv_b"], sh["attn"]["out_w"], mask, hl)
          for sh in shards]
    x1 = x + (sum(y for y, _ in fa) + at["out_b"].float()).to(x.dtype)
    fm = [block.mlp_fwd_part_plain(x1, ln2["scale"], ln2["bias"], sh["mlp"]["fc_w"],
                                   sh["mlp"]["fc_b"], sh["mlp"]["proj_w"]) for sh in shards]
    y = x1 + (sum(y for y, _ in fm) + ml["proj_b"].float()).to(x.dtype)
    dxh = sum(block.mlp_bwd_part_plain(res[0], sh["mlp"]["fc_w"], sh["mlp"]["proj_w"], gy)
              for (_, res), sh in zip(fm, shards))
    g1 = block._ln_bwd(x1, fm[0][1][1], fm[0][1][2], ln2["scale"], dxh, gy)
    dxh = sum(block.attn_bwd_part_plain(res[0], res[1], sh["attn"]["qkv_w"],
                                        sh["attn"]["out_w"], g1, hl)
              for (_, res), sh in zip(fa, shards))
    dx = block._ln_bwd(x, fa[0][1][2], fa[0][1][3], ln1["scale"], dxh, g1)
    return y, dx


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_summed_part_twins_match_jax_sharded_block(masked, jax_block_ref):
    p, x, gy, mask = _block_inputs()
    mask = mask if masked else None
    want_y, want_dx = jax_block_ref["causal" if masked else "none"]
    tp_p = jax.tree_util.tree_map(torch.from_numpy, p)
    y, dx = _summed_parts(torch.from_numpy(x), tp_p, None if mask is None else
                          torch.from_numpy(mask), torch.from_numpy(gy), 2)
    np.testing.assert_allclose(y.numpy(), want_y, atol=5e-6, rtol=1e-5)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=5e-6, rtol=1e-4)


def test_indivisible_heads_fall_back_to_the_plain_block():
    """2 heads at tp=4 cannot be cut: the tower keeps its full weights and
    every model rank runs the whole fused block on them, with no
    collective: the same y and dx as the fused block, and those of the
    JAX wrapper, which falls back to its XLA block there."""
    from mvlpt_tpu.parallel.mesh import create_mesh

    p, x, gy, mask = _block_inputs()
    tp_p = jax.tree_util.tree_map(torch.from_numpy, p)
    mt, gyt = torch.from_numpy(mask), torch.from_numpy(gy)
    assert shard_blocks(tp_p, 2, 4, 1) is tp_p

    def y_dx(fn):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = fn(xt)
        (dx,) = torch.autograd.grad(y, xt, gyt)
        return y.detach().numpy(), dx.numpy()

    y, dx = y_dx(lambda xt: block.fused_residual_block_sharded(xt, tp_p, 2, mt, _fake_mesh(4)))
    want_y, want_dx = y_dx(lambda xt: block.fused_residual_block(xt, tp_p, 2, mt))
    np.testing.assert_array_equal(y, want_y)
    np.testing.assert_array_equal(dx, want_dx)
    j_y, j_dx = _jax_block(p, x, gy, mask, create_mesh(1, 4, jax.devices()[:4]), n_heads=2)
    np.testing.assert_allclose(y, j_y, atol=5e-6, rtol=1e-5)
    np.testing.assert_allclose(dx, j_dx, atol=5e-6, rtol=1e-4)


def test_select_attn_fn_on_a_mesh():
    """'block'/'auto' carry the mesh into the fused kernels; on a mesh with
    a model axis 'on' and 'off' run the plain layers on the rank's shard
    (ShardedAttention, with the standalone attention or the plain core);
    without one they are what they are on one device."""
    from mvlpt_torch.ops.attention import ShardedAttention, fused_attention, select_attn_fn

    tp_mesh, dp_mesh = _fake_mesh(2), _fake_mesh(1)
    for sel in ("block", "auto"):
        assert select_attn_fn(sel, mesh=tp_mesh) == block.BlockKernels(mesh=tp_mesh)
    for sel, attn_fn in (("on", fused_attention), (True, fused_attention), ("off", None),
                         (False, None)):
        got = select_attn_fn(sel, mesh=tp_mesh)
        assert isinstance(got, ShardedAttention)
        assert got.attn_fn is attn_fn and got.mesh is tp_mesh
    assert select_attn_fn("on", mesh=dp_mesh) is fused_attention
    assert select_attn_fn("off", mesh=dp_mesh) is None


# ---------------------------------------------------------- spawned ranks

def _spawn(n_data, n_model, workdir, vocab):
    """Start one gloo rank a process; returns the processes."""
    world = n_data * n_model
    return spawn_ranks(child.run, world, world, n_data, n_model, str(workdir), vocab)


def _collect(procs, workdir, deadline):
    collect_ranks(procs, workdir, deadline)
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(len(procs))]


@pytest.fixture(scope="module")
def spawned(sides, jmesh, jax_block_ref, synthetic_vocab, tmp_path_factory):  # noqa: F811
    """Both meshes' ranks, run at once, with the JAX references of the
    block, of one SGD step and of the cached-text eval computed meanwhile
    in this process, and the single-process port eval."""
    from mvlpt_tpu.config import get_cfg_default
    from mvlpt_tpu.ops import select_attn_fn as j_select
    from mvlpt_tpu.parallel import backbone_partition_specs, batch_specs, shard_tree
    from mvlpt_tpu.train.optim import build_optimizer as j_build
    from mvlpt_tpu.train.train_step import init_train_state as j_init
    from mvlpt_tpu.train.train_step import make_cached_text_eval as j_cached
    from mvlpt_tpu.train.train_step import make_train_step as j_step

    from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.ops.attention import select_attn_fn
    from mvlpt_torch.train import make_cached_text_eval

    j_model, j_backbone, j_pp, j_consts = sides["j"]
    model, backbone, pp, consts = sides["t"]
    p, x, gy, mask = _block_inputs()
    rng = np.random.RandomState(9)
    batch = {"image": rng.randn(BATCH, 32, 32, 3).astype(np.float32),
             "label": rng.randint(0, N_CLS, BATCH)}
    eval_image = rng.randint(0, 256, (BATCH, 32, 32, 3)).astype(np.uint8)
    inputs = {**child.flatten(p, "blk"),
              **child.flatten(jax.tree_util.tree_map(np.asarray, j_backbone), "bb"),
              **child.flatten(jax.tree_util.tree_map(np.asarray, j_pp), "pp"),
              "x": x, "gy": gy, "mask": mask, **batch, "eval_image": eval_image,
              "context_length": np.asarray(sides["s"])}
    runs, deadline = {}, time.monotonic() + SPAWN_TIMEOUT_S
    for n_data, n_model in ((1, 2), (2, 2)):
        work = tmp_path_factory.mktemp(f"tp{n_data}x{n_model}")
        np.savez(work / "inputs.npz", **inputs)
        runs[(n_data, n_model)] = (_spawn(n_data, n_model, work, synthetic_vocab), work)
    try:
        ref = dict(jax_block_ref)
        cfg = get_cfg_default()
        for key, value in child.OPTIM.items():
            setattr(cfg.OPTIM, key, value)
        tx, _ = j_build(cfg.OPTIM, steps_per_epoch=1)
        j_tp = dataclasses.replace(j_model, attn_fn=j_select("block", mesh=jmesh))
        with jmesh:
            jb = shard_tree(j_backbone, backbone_partition_specs(j_backbone), jmesh)
            jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
            jbatch = shard_tree(jbatch, batch_specs(jbatch), jmesh)
            j_state, j_metrics = j_step(j_tp, tx, donate=False)(
                j_init(j_pp, tx), jb, j_consts, jbatch, jax.random.PRNGKey(0))
        ref["loss"] = float(j_metrics["loss"])
        ref["params"] = [np.asarray(a) for a in jax.tree_util.tree_leaves(j_state.prompt_params)]
        norm = (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
        j_text_fn, j_eval_fn = j_cached(j_tp, normalize=norm)
        with jmesh:
            jimg = {"image": jnp.asarray(eval_image)}
            jimg = shard_tree(jimg, batch_specs(jimg), jmesh)
            ref["eval_logits_jax"] = np.asarray(
                j_eval_fn(jb, j_pp, j_text_fn(jb, j_pp, j_consts), jimg))

        single = MVLPTModel(model.clip_cfg, model.spec, kernels=select_attn_fn("block"),
                            compute_dtype=model.compute_dtype)
        text_fn, eval_fn = make_cached_text_eval(single, normalize=norm)
        ref["eval_logits"] = eval_fn(backbone, pp, text_fn(backbone, pp, consts),
                                     {"image": torch.from_numpy(eval_image)}).numpy()
    finally:
        out = {mesh: _collect(procs, work, deadline)
               for mesh, (procs, work) in runs.items()}
    return out, ref


def test_child_config_is_the_slice_config(sides):  # noqa: F811
    from mvlpt_torch.core.clip import CLIPConfig
    from mvlpt_torch.prompts import PromptSpec

    model = sides["t"][0]
    assert model.clip_cfg == CLIPConfig(**child.DIMS)
    assert model.spec == PromptSpec(**child.spec_kw(sides["s"]))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_spawned_block_forward_and_dx_match_jax(spawned, mesh):
    out, ref = spawned
    n_data, n_model = mesh
    per = BATCH // n_data
    for r, got in enumerate(out[mesh]):
        rows = slice((r // n_model) * per, (r // n_model + 1) * per)
        for name in ("none", "causal"):
            want_y, want_dx = ref[name]
            np.testing.assert_allclose(got[f"y_{name}"], want_y[rows], atol=5e-6, rtol=1e-5)
            np.testing.assert_allclose(got[f"dx_{name}"], want_dx[rows], atol=5e-6, rtol=1e-4)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_spawned_sgd_step_matches_jax_tp_step(spawned, mesh):
    """One SGD step of the tiny UPT step: the loss and the prompt params
    against the JAX step on its 2x2 mesh, and bit-equal on every rank."""
    out, ref = spawned
    n_params = len(ref["params"])
    for got in out[mesh]:
        np.testing.assert_allclose(float(got["loss"]), ref["loss"], rtol=1e-5)
        params = [got[f"param{i}"] for i in range(n_params)]
        for a, b in zip(params, ref["params"]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)
        for i in range(n_params):
            np.testing.assert_array_equal(got[f"param{i}"], out[mesh][0][f"param{i}"])


def test_spawned_cached_text_eval_matches_single_process(spawned):
    """Cached-text eval on a (1, 2) mesh carries the mesh into its no-grad
    model and gives the single-process logits."""
    out, ref = spawned
    for got in out[(1, 2)]:
        np.testing.assert_allclose(got["eval_logits"], ref["eval_logits"], atol=1e-4)


def test_spawned_cached_text_eval_matches_jax_tp_eval(spawned):
    """Cached-text eval on a (1, 2) mesh against the JAX cached-text eval
    under 'block' on its 2x2 mesh (the tensor-parallel kernels)."""
    out, ref = spawned
    for got in out[(1, 2)]:
        np.testing.assert_allclose(got["eval_logits"], ref["eval_logits_jax"], atol=1e-4)
