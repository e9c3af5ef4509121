"""The port's accuracy contract against the JAX package's, on the CPU.

scripts/torch_port_bf16_drift_train.py against scripts/bf16_drift_train.py
(loaded by path, as tests/test_bf16_drift.py loads it): the data streams
bit for bit; legs A and C (fp32, plain, one step a call) from the JAX
tiny flagship's weights, carried across by ``checkpoint.from_jax``, at
1e-5 on the losses and 1e-4 x max on the final prompts; leg D (bf16,
plain, windows of 4) within half the seed spread of the JAX leg D (the
XLA path on both sides, no interpret kernels); and the port's own
``measure`` on the tiny towers held to the JAX test's three assertions.
The zero-shot drift at tests/test_bf16_drift.py's size: bf16 against
fp32 at 0.12 of the logits' std, the half-block kernels' twins against
the plain path in bf16 at 0.14, each with the top-1 rule, and the port's
fp32 logits within 1e-4 x max|logit| of the JAX package's.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parent.parent
STEPS, WINDOW, BATCH, N_CLS = 12, 4, 8, 8


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {"j": _load("bf16_drift_train"), "t": _load("torch_port_bf16_drift_train")}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carried(j_bb, j_pp) -> tuple:
    from mvlpt_torch.checkpoint import backbone_from_jax, prompt_params_from_jax

    return backbone_from_jax(_np_tree(j_bb), "cpu"), prompt_params_from_jax(_np_tree(j_pp), "cpu")


@pytest.fixture(scope="module")
def tiny(scripts, synthetic_vocab):  # noqa: F811
    """Both sides' tiny flagship, fp32 and bf16, from the JAX weights."""
    j, t = scripts["j"], scripts["t"]
    j32 = j._build("tiny", jnp.float32, kernels=False, n_cls=N_CLS, batch=BATCH)
    jP = j._build("tiny", jnp.bfloat16, kernels=True, n_cls=N_CLS, batch=BATCH)
    weights = _carried(j32[1], j32[2])
    t32 = t._build("tiny", torch.float32, False, N_CLS, BATCH, torch.device("cpu"), weights)
    tP = t._build("tiny", torch.bfloat16, True, N_CLS, BATCH, torch.device("cpu"), weights)
    assert j32[4] == t32[4] == 32
    return dict(j32=j32, jP=jP, t32=t32, tP=tP)


def _stream(scripts, seed):
    return scripts["j"]._stream(seed, STEPS, BATCH, 32, N_CLS)


@pytest.mark.parametrize("unique", [None, 3], ids=["fresh", "unique3"])
@pytest.mark.parametrize("seed", [0, 1000])
def test_stream_bit_equal_to_jax(scripts, seed, unique):
    args = (seed, 24, BATCH, 32, N_CLS)
    want = scripts["j"]._stream(*args, unique=unique)
    got = scripts["t"]._stream(*args, unique=unique)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    assert got["image"].shape[0] == (unique or 24)


def _close_prompts(got, want, rel=1e-4):
    from mvlpt_torch.utils.tree import tree_leaves

    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


@pytest.mark.parametrize("leg, seed", [("A", 0), ("C", 1000)])
def test_single_legs_match_jax(scripts, tiny, leg, seed):
    """Legs A (stream s0) and C (stream s1): fp32, plain, one step a call."""
    j_model, j_bb, j_pp, j_consts, _ = tiny["j32"]
    model, bb, pp, consts, _ = tiny["t32"]
    stream = _stream(scripts, seed)
    j_losses, j_params = scripts["j"]._run_single(j_model, j_bb, j_pp, j_consts, stream, STEPS)
    losses, params, _ = scripts["t"]._run_single(model, bb, pp, consts, stream, STEPS,
                                                  torch.device("cpu"))
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=1e-5)
    _close_prompts(params, j_params)


def test_windowed_bf16_plain_leg_matches_jax(scripts, tiny):
    """Leg D (bf16, the plain path, windows of WINDOW) within half the
    seed spread (the port's |A - C|) of the JAX leg D."""
    t = scripts["t"]
    cpu = torch.device("cpu")
    j_model, j_bb, j_pp, j_consts, _ = tiny["jP"]
    model, bb, pp, consts, _ = tiny["tP"]
    s0 = _stream(scripts, 0)
    j_losses, j_params = scripts["j"]._run_windowed(
        dataclasses.replace(j_model, attn_fn=None), j_bb, j_pp, j_consts, s0, STEPS, WINDOW)
    losses, params, info = t._run_windowed(t._plain(model), bb, pp, consts, s0, STEPS,
                                           WINDOW, cpu)
    assert info == {"captures": 0, "replays": 0}  # the CPU runs the windows eagerly
    m32, bb32, pp32, c32, _ = tiny["t32"]
    seed_spread = t._dist(t._run_single(m32, bb32, pp32, c32, s0, STEPS, cpu)[1],
                          t._run_single(m32, bb32, pp32, c32, _stream(scripts, 1000), STEPS,
                                        cpu)[1])
    assert losses.shape == (STEPS,) and np.isfinite(losses).all()
    assert t._dist(params, j_params) < 0.5 * seed_spread


def test_measure_tiny_meets_the_jax_contract(scripts, synthetic_vocab):  # noqa: F811
    """tests/test_bf16_drift.py's three assertions on the port's own tiny
    flagship (its seeded init), bf16 with the kernels' twins."""
    out = scripts["t"].measure("tiny", steps=STEPS, window=WINDOW, batch=BATCH, n_cls=N_CLS,
                               device="cpu")
    assert out["param_ratio"] < 0.5, out
    assert out["loss_ratio"] < 0.5, out
    assert out["param_dist_kernels_only"] < 0.5 * out["param_dist_seed"], out
    assert out["device"] == "cpu" and out["card"] == "cpu"
    assert set(out["legs"]) == {"A fp32-plain-single s0", "B prod-windowed s0",
                                "C fp32-plain-single s1", "D bf16-plain-window s0"}


# ------------------------------------------------------------ zero-shot


@pytest.fixture(scope="module")
def mid(scripts):
    """tests/test_bf16_drift.py's fixture: the JAX package's mid-size
    CLIP at seed 7, carried across, and its inputs."""
    from mvlpt_tpu.core.clip import init_clip_params

    from tests.test_bf16_drift import _mid_clip as j_mid_clip

    from mvlpt_torch.checkpoint import backbone_from_jax

    t = scripts["t"]
    j_cfg, cfg = j_mid_clip(), t._mid_clip()
    assert dataclasses.asdict(j_cfg) == dataclasses.asdict(cfg)
    j_bb = init_clip_params(jax.random.PRNGKey(7), j_cfg)
    images, ids = t._mid_clip_inputs()
    return dict(j=(j_cfg, j_bb), t=(cfg, backbone_from_jax(_np_tree(j_bb), "cpu")),
                images=images, ids=ids)


def _port_logits(t, mid, dtype, kernels=None):
    from mvlpt_torch.core.clip import cast_backbone

    cfg, bb = mid["t"]
    return t._zeroshot_logits(cast_backbone(bb, dtype), cfg,
                              torch.from_numpy(mid["images"]).to(dtype),
                              torch.from_numpy(mid["ids"]), kernels=kernels)


def test_mid_inputs_are_the_jax_tests(scripts, mid):
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(mid["images"], rng.randn(48, 64, 64, 3).astype(np.float32))
    ids = rng.randint(1, 1000, (16, 13)).astype(np.int32)
    ids[:, 0], ids[:, -1] = 40000, 49407
    np.testing.assert_array_equal(mid["ids"], ids)


def test_fp32_zeroshot_logits_match_jax(scripts, mid):
    from tests.test_bf16_drift import _zeroshot_logits as j_logits

    j_cfg, j_bb = mid["j"]
    want = j_logits(j_bb, j_cfg, jnp.asarray(mid["images"]), jnp.asarray(mid["ids"]))
    got = _port_logits(scripts["t"], mid, torch.float32)
    assert got.shape == want.shape == (48, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_bf16_vs_fp32_zeroshot(scripts, mid):
    t = scripts["t"]
    ref = _port_logits(t, mid, torch.float32)
    rel = t._check_drift(ref, _port_logits(t, mid, torch.bfloat16), t.BF16_REL_TOL)["drift"]
    assert 0 < rel <= t.BF16_REL_TOL


@pytest.mark.parametrize("inference", [False, True], ids=["train-forwards", "no-grad-forwards"])
def test_twins_vs_plain_bf16(scripts, mid, inference):
    """The half-block kernels ('block'; on the CPU their plain twins)
    against the plain path, both bf16, at 0.14 with the top-1 rule."""
    from mvlpt_torch.ops.attention import select_attn_fn

    t = scripts["t"]
    ref = _port_logits(t, mid, torch.bfloat16)
    got = _port_logits(t, mid, torch.bfloat16, select_attn_fn("block", inference=inference))
    rel = t._check_drift(ref, got, t.FUSED_REL_TOL)["drift"]
    assert 0 < rel <= t.FUSED_REL_TOL


def test_check_drift_fails_loudly(scripts):
    """A drift past the bound, and a fixture whose every margin is inside
    twice the drift, each raise; equal logits pass with no drift."""
    t = scripts["t"]
    ref = np.array([[3.0, 0.0, -3.0], [0.0, 2.0, -2.0]])
    with pytest.raises(AssertionError, match="exceeds"):
        t._check_drift(ref, ref + 1.0, 0.12)
    close = np.array([[1.0, 0.9, 0.0], [0.0, 1.0, 0.95]])
    with pytest.raises(AssertionError, match="no confident"):
        t._check_drift(close, close + np.array([[0.0, 0.06, 0.0], [0.0, 0.0, 0.0]]), 10.0)
    same = t._check_drift(ref, ref, 0.12)
    assert same["drift"] == 0.0 and same["confident"] == 2
