"""Prompt checkpoints and the OpenAI CLIP converter: the port's
``mvlpt_torch.checkpoint`` against the JAX package's, both ways, fp32 on
the CPU.

A file either package writes loads in the other to the same flat state
dict and the same logits; the reference trainer's torch archives (built
here from random tensors under its learner's key names) load the same in
both; and an OpenAI-layout state_dict of random tensors converts to the
same config, leaves and logits.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import synthetic_vocab, two_sides  # noqa: F401 (fixture)

N_CLS, BATCH = 6, 4
# Logits of the same prompt across the two packages: their fp32 sums run
# in another order, which moves logits of size up to exp(logit_scale) =
# 1 / 0.07 by up to 4e-6 here. Within the port the same prompt gives the
# same logits within 1e-6.
XLOGITS = 1e-5


@pytest.fixture(scope="module")
def upt(synthetic_vocab):  # noqa: F811
    return two_sides(N_CLS)


def _images(seed=0):
    return np.random.RandomState(seed).randn(BATCH, 32, 32, 3).astype(np.float32)


def _random_like(tree, seed):
    """The prompt tree's shapes filled with seeded numpy values."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.randn(*np.shape(a)) * 0.1).astype(np.float32), tree)


def _logits(sides, j_params, t_params, images):
    j_model, j_backbone, _, j_consts = sides["j"]
    model, backbone, _, consts = sides["t"]
    want = j_model(j_backbone, j_params, j_consts, jnp.asarray(images))
    with torch.no_grad():
        got = model(backbone, t_params, consts, torch.from_numpy(images))
    return np.asarray(want), got.numpy()


def _same_flat(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_jax_saved_prompt_loads_in_the_port(upt, tmp_path):
    from mvlpt_tpu.checkpoint import prompt_io as jio
    from mvlpt_torch.checkpoint import prompt_io as tio
    from mvlpt_torch.checkpoint import prompt_params_from_jax

    _, _, j_pp, _ = upt["j"]
    _, _, pp, _ = upt["t"]
    trained = jax.tree_util.tree_map(jnp.asarray, _random_like(j_pp, 1))
    path = jio.checkpoint_path(str(tmp_path), epoch=3)
    jio.save_prompt_checkpoint(path, trained, epoch=3, val_result=0.5)
    payload = tio.load_prompt_checkpoint(path)
    _same_flat(payload["state_dict"], jio.load_prompt_checkpoint(path)["state_dict"])
    assert (payload["epoch"], payload["val_result"]) == (3, 0.5)
    restored, loaded, skipped = tio.apply_state_dict(pp, payload["state_dict"])
    assert loaded == len(payload["state_dict"]) and not skipped
    _same_flat(tio.flatten_params(restored), jio.flatten_params(trained))
    want = prompt_params_from_jax(jax.tree_util.tree_map(np.asarray, trained), "cpu")
    j_logits, got = _logits(upt, trained, restored, _images())
    with torch.no_grad():
        model, backbone, _, consts = upt["t"]
        same = model(backbone, want, consts, torch.from_numpy(_images())).numpy()
    np.testing.assert_allclose(got, same, atol=1e-6)
    np.testing.assert_allclose(got, j_logits, atol=XLOGITS)


def test_port_saved_prompt_loads_in_jax(upt, tmp_path):
    from mvlpt_tpu.checkpoint import prompt_io as jio
    from mvlpt_torch.checkpoint import prompt_io as tio
    from mvlpt_torch.checkpoint import prompt_params_from_jax

    _, _, j_pp, _ = upt["j"]
    trained = prompt_params_from_jax(_random_like(j_pp, 2), "cpu")
    path = tio.checkpoint_path(str(tmp_path))
    tio.save_prompt_checkpoint(path, trained, epoch=7, val_result=None)
    payload = jio.load_prompt_checkpoint(path)
    assert (payload["epoch"], payload["val_result"]) == (7, None)
    _same_flat(payload["state_dict"], tio.flatten_params(trained))
    restored, loaded, skipped = jio.apply_state_dict(j_pp, payload["state_dict"])
    assert loaded == len(payload["state_dict"]) and not skipped
    j_logits, got = _logits(upt, restored, trained, _images(1))
    np.testing.assert_allclose(got, j_logits, atol=XLOGITS)


def _reference_archive(path, seed, legacy=False, upt_names=False):
    """The reference trainer's payload for the UPT spec of ``two_sides``,
    random tensors under its learner's key names (torch Linear weights
    (out, in), the coupler as CLIP resblocks), its frozen buffers too."""
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.1).astype(np.float32))

    d, w = 16, 64  # coupler dim, text and vision width
    sd = {"ctx": t(2, w), "vpt_embeddings": t(1, 2, w), "vpt_embeddings_deep": t(1, 2, w),
          "token_prefix": t(N_CLS, 1, w), "token_suffix": t(N_CLS, 5, w)}
    for name, (n_in, n_out) in (("coop_pre", (w, d)), ("coop_post", (d, w)),
                                ("vpt_pre", (w, d)), ("vpt_post", (d, w))):
        sd[f"mvlpt_proj_ctx_{name}.weight"] = t(n_out, n_in)
        sd[f"mvlpt_proj_ctx_{name}.bias"] = t(n_out)
    block = {"ln_1.weight": (d,), "ln_1.bias": (d,), "attn.in_proj_weight": (3 * d, d),
             "attn.in_proj_bias": (3 * d,), "attn.out_proj.weight": (d, d),
             "attn.out_proj.bias": (d,), "ln_2.weight": (d,), "ln_2.bias": (d,),
             "mlp.c_fc.weight": (4 * d, d), "mlp.c_fc.bias": (4 * d,),
             "mlp.c_proj.weight": (d, 4 * d), "mlp.c_proj.bias": (d,)}
    for leaf, shape in block.items():
        sd[f"mvlpt_proj.resblocks.0.{leaf}"] = t(*shape)
    if upt_names:
        sd = {k.replace("mvlpt_proj", "upt_proj"): v for k, v in sd.items()}
    torch.save({"state_dict": sd, "epoch": 4, "val_result": 61.25}, str(path),
               _use_new_zipfile_serialization=not legacy)
    return sd


@pytest.mark.parametrize("legacy, upt_names", [(False, False), (True, False), (False, True)],
                         ids=["zip", "legacy-pickle", "upt-names"])
def test_reference_archive_loads_the_same_in_both(upt, tmp_path, legacy, upt_names):
    from mvlpt_tpu.checkpoint import prompt_io as jio
    from mvlpt_torch.checkpoint import prompt_io as tio

    _, _, j_pp, _ = upt["j"]
    _, _, pp, _ = upt["t"]
    path = tmp_path / "model-best.pth.tar"
    _reference_archive(path, 3, legacy=legacy, upt_names=upt_names)
    got, want = tio.load_prompt_checkpoint(str(path)), jio.load_prompt_checkpoint(str(path))
    _same_flat(got["state_dict"], want["state_dict"])
    assert (got["epoch"], got["val_result"]) == (want["epoch"], want["val_result"]) == (4, 61.25)
    assert not any("token_" in k for k in got["state_dict"])
    t_tree, t_loaded, t_skipped = tio.apply_state_dict(pp, got["state_dict"])
    j_tree, j_loaded, j_skipped = jio.apply_state_dict(j_pp, want["state_dict"])
    assert (t_loaded, t_skipped) == (j_loaded, j_skipped) and t_loaded == len(got["state_dict"])
    j_logits, logits = _logits(upt, j_tree, t_tree, _images(2))
    np.testing.assert_allclose(logits, j_logits, atol=XLOGITS)


def test_export_average_find_and_list_agree(upt, tmp_path):
    """One run directory written by both packages: each exports the same
    prompt as a reference archive and saves a seed; find_checkpoint,
    list_epoch_checkpoints, the exports and the average agree."""
    from mvlpt_tpu.checkpoint import prompt_io as jio
    from mvlpt_torch.checkpoint import prompt_io as tio
    from mvlpt_torch.checkpoint import prompt_params_from_jax

    _, _, j_pp, _ = upt["j"]
    trained_np = _random_like(j_pp, 4)
    j_trained = jax.tree_util.tree_map(jnp.asarray, trained_np)
    t_trained = prompt_params_from_jax(trained_np, "cpu")

    j_ref, t_ref = tmp_path / "j" / "ref.pth.tar", tmp_path / "t" / "ref.pth.tar"
    jio.export_reference_checkpoint(str(j_ref), j_trained, epoch=9, val_result=55.5)
    tio.export_reference_checkpoint(str(t_ref), t_trained, epoch=9, val_result=55.5)
    j_sd = torch.load(str(j_ref), weights_only=False)
    t_sd = torch.load(str(t_ref), weights_only=False)
    assert {k: v for k, v in j_sd.items() if k != "state_dict"} == \
        {k: v for k, v in t_sd.items() if k != "state_dict"}
    _same_flat({k: v.numpy() for k, v in t_sd["state_dict"].items()},
               {k: v.numpy() for k, v in j_sd["state_dict"].items()})
    assert tio.is_reference_state_dict(t_sd["state_dict"])
    for mod in (jio, tio):
        for path in (j_ref, t_ref):
            _same_flat(mod.load_prompt_checkpoint(str(path))["state_dict"],
                       tio.flatten_params(t_trained))

    run = str(tmp_path / "run")
    for ep, mod in ((3, jio), (20, tio), (5, jio)):
        mod.save_prompt_checkpoint(mod.checkpoint_path(run, ep), j_trained if mod is jio
                                   else t_trained, epoch=ep, val_result=float(ep))
    (tmp_path / "run" / "prompt_learner" / "model.pth.tar-30.bak").write_bytes(b"")
    for mod in (jio, tio):
        assert mod.list_epoch_checkpoints(run) == [3, 5, 20]
        assert mod.find_checkpoint(run) == jio.checkpoint_path(run, 20)
        assert mod.find_checkpoint(run, 3) == jio.checkpoint_path(run, 3)
        assert mod.find_checkpoint(str(tmp_path / "nope")).endswith("model-best.pth.tar")
    seeds = []
    for seed, mod, tree in ((1, jio, j_trained),
                            (2, tio, prompt_params_from_jax(_random_like(j_pp, 5), "cpu"))):
        seeds.append(mod.checkpoint_path(str(tmp_path / f"seed{seed}")))
        mod.save_prompt_checkpoint(seeds[-1], tree, epoch=5, val_result=float(seed))
    seeds.append(str(t_ref))
    got, want = tio.average_checkpoints(seeds), jio.average_checkpoints(seeds)
    _same_flat(got["state_dict"], want["state_dict"])
    assert (got["epoch"], got["val_result"]) == (want["epoch"], want["val_result"])
    best = tio.checkpoint_path(run)
    tio.save_prompt_checkpoint(best, t_trained, epoch=20, val_result=1.0)
    for mod in (jio, tio):
        assert mod.find_checkpoint(run) == best


def test_apply_state_dict_is_non_strict_as_in_jax(upt):
    from mvlpt_tpu.checkpoint import prompt_io as jio
    from mvlpt_torch.checkpoint import prompt_io as tio

    _, _, j_pp, _ = upt["j"]
    _, _, pp, _ = upt["t"]
    sd = tio.flatten_params(_random_like(j_pp, 6))
    sd["coop.ctx"] = np.zeros((9, 9), np.float32)  # wrong shape
    sd["unknown.key"] = np.zeros(3, np.float32)
    t_tree, t_n, t_skip = tio.apply_state_dict(pp, sd)
    j_tree, j_n, j_skip = jio.apply_state_dict(j_pp, sd)
    assert (t_n, sorted(t_skip)) == (j_n, sorted(j_skip)) == (len(sd) - 2,
                                                              ["coop.ctx", "unknown.key"])
    _same_flat(tio.flatten_params(t_tree), jio.flatten_params(j_tree))
    assert all(leaf.dtype == torch.float32 for leaf in jax.tree_util.tree_leaves(t_tree))
    with pytest.raises(ValueError, match="shape mismatch"):
        tio.apply_state_dict(pp, sd, strict=True)


def test_corrupt_checkpoint_raises_its_own_error(upt, tmp_path):
    """A truncated checkpoint raises the pickle failure, not a torch-archive
    error; a pickle of something other than a payload raises a ValueError
    that says so (tests/test_checkpoint.py's cases, on the port)."""
    from mvlpt_torch.checkpoint import prompt_io as tio

    _, _, pp, _ = upt["t"]
    full = tio.checkpoint_path(str(tmp_path / "run"), 1)
    tio.save_prompt_checkpoint(full, pp, epoch=1)
    blob = open(full, "rb").read()
    cut = tmp_path / "model.pth.tar-1"
    cut.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(Exception) as ei:
        tio.load_prompt_checkpoint(str(cut))
    assert "pickle" in type(ei.value).__module__ + type(ei.value).__name__ \
        or isinstance(ei.value, EOFError)
    for junk in ([1, 2, 3], np.ones((4, 4))):
        path = tmp_path / "junk.pth.tar"
        with open(path, "wb") as f:
            pickle.dump(junk, f)
        with pytest.raises(ValueError, match="not a prompt checkpoint"):
            tio.load_prompt_checkpoint(str(path))


# An OpenAI-layout ViT CLIP of two layers a tower at width 64 (one head of
# 64 a tower, as CLIP's width // 64 rule gives), 32 px images in 8 px
# patches, the full vocabulary and context.
_OPENAI = dict(width=64, layers=2, patch=8, grid=4, embed=32, vocab=49408, context=77)


def _openai_state_dict(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    w, p, e, n = _OPENAI["width"], _OPENAI["patch"], _OPENAI["embed"], _OPENAI["layers"]

    def t(*shape, scale=0.05):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    def ln(prefix):
        return {f"{prefix}.weight": 1 + t(w, scale=0.1), f"{prefix}.bias": t(w)}

    def blocks(prefix):
        out = {}
        for i in range(n):
            b = f"{prefix}.resblocks.{i}"
            out.update(ln(f"{b}.ln_1"))
            out.update(ln(f"{b}.ln_2"))
            out.update({f"{b}.attn.in_proj_weight": t(3 * w, w), f"{b}.attn.in_proj_bias": t(3 * w),
                        f"{b}.attn.out_proj.weight": t(w, w), f"{b}.attn.out_proj.bias": t(w),
                        f"{b}.mlp.c_fc.weight": t(4 * w, w), f"{b}.mlp.c_fc.bias": t(4 * w),
                        f"{b}.mlp.c_proj.weight": t(w, 4 * w), f"{b}.mlp.c_proj.bias": t(w)})
        return out

    sd = {"visual.conv1.weight": t(w, 3, p, p), "visual.class_embedding": t(w),
          "visual.positional_embedding": t(_OPENAI["grid"] ** 2 + 1, w),
          "visual.proj": t(w, e), "token_embedding.weight": t(_OPENAI["vocab"], w, scale=0.02),
          "positional_embedding": t(_OPENAI["context"], w, scale=0.01),
          "text_projection": t(w, e), "logit_scale": torch.tensor(np.log(1 / 0.07),
                                                                  dtype=torch.float32)}
    sd.update(ln("visual.ln_pre"))
    sd.update(ln("visual.ln_post"))
    sd.update(ln("ln_final"))
    sd.update(blocks("visual.transformer"))
    sd.update(blocks("transformer"))
    return sd


def test_openai_converter_matches_jax(synthetic_vocab, tmp_path):  # noqa: F811
    """config_from_state_dict gives the same fields, convert_openai_state_dict
    the same leaves, and the two models the same logits; load_clip reads
    the state_dict from a local file and fetches nothing."""
    from mvlpt_tpu.checkpoint import convert as jconv
    from mvlpt_tpu.models.custom_clip import MVLPTModel as JModel
    from mvlpt_tpu.ops import block as jblock
    from mvlpt_tpu.prompts import PromptSpec as JSpec, build_prompt_consts as jconsts
    from mvlpt_tpu.prompts import init_prompt_params as jinit

    from mvlpt_torch.checkpoint import convert as tconv
    from mvlpt_torch.checkpoint import flatten_params, prompt_params_from_jax
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.ops.attention import select_attn_fn
    from mvlpt_torch.prompts import PromptSpec, build_prompt_consts, compute_cut_context_length

    sd = _openai_state_dict(0)
    t_cfg = tconv.config_from_state_dict(sd)
    j_cfg = jconv.config_from_state_dict(sd)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert (t_cfg.vision_width, t_cfg.vision_layers, t_cfg.image_resolution,
            t_cfg.transformer_heads) == (64, 2, 32, 1)

    backbone, cfg = tconv.convert_openai_state_dict(sd, device="cpu")
    j_backbone, _ = jconv.convert_openai_state_dict(sd)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in jax.tree_util.tree_leaves(backbone))
    _same_flat(flatten_params(backbone), flatten_params(j_backbone))

    path = tmp_path / "ViT-tiny.pt"
    torch.save(sd, str(path))
    loaded, loaded_cfg = tconv.load_clip(str(path), device="cpu")
    assert loaded_cfg == cfg
    _same_flat(flatten_params(loaded), flatten_params(backbone))
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        tconv.load_clip("ViT-B/16", device="cpu")

    classnames = [f"c{i}" for i in range(N_CLS)]
    spec_kw = dict(n_cls=N_CLS, coop_n_ctx=2, vpt_n_ctx=2, vpt_deep=True,
                   class_token_position="middle", project_dim=16,
                   context_length=compute_cut_context_length(classnames, 2),
                   vision_layers=2, vision_width=64, text_width=64, embed_dim=32,
                   vision_patch_size=8)
    j_pp = jinit(jax.random.PRNGKey(1), JSpec(**spec_kw))
    j_model = JModel(clip_cfg=j_cfg, spec=JSpec(**spec_kw), attn_fn=jblock.FUSED,
                     compute_dtype=jnp.float32)
    model = MVLPTModel(cfg, PromptSpec(**spec_kw), kernels=select_attn_fn("block"),
                       compute_dtype=torch.float32)
    images = _images(3)
    want = j_model(j_backbone, j_pp, jconsts(classnames, JSpec(**spec_kw), j_backbone,
                                              jnp.float32), jnp.asarray(images))
    with torch.no_grad():
        got = model(backbone, prompt_params_from_jax(jax.tree_util.tree_map(np.asarray, j_pp),
                                                     "cpu"),
                    build_prompt_consts(classnames, PromptSpec(**spec_kw), backbone,
                                        torch.float32), torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_converter_refuses_a_resnet_checkpoint():
    from mvlpt_torch.checkpoint.convert import config_from_state_dict

    with pytest.raises(ValueError, match="ViT"):
        config_from_state_dict({"visual.conv1.weight": torch.zeros(64, 3, 7, 7)})


def test_converter_runs_on_the_card_unless_asked(monkeypatch):
    """The converter's entry points take the card by default and refuse a
    host without one unless the caller asks for the CPU."""
    from mvlpt_torch.checkpoint.convert import convert_openai_state_dict

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_openai_state_dict({})
