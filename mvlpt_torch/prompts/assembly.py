"""Prompt-assembly functions: UPT coupling, VPT preparation, CoOp prompt
construction, CoCoOp conditioning. The counterpart of
``mvlpt_tpu/prompts/assembly.py``."""

from __future__ import annotations

import torch

from mvlpt_torch.core import layers
from mvlpt_torch.prompts.learner import PromptConsts, PromptSpec


def _linear(x, p):
    return layers._matmul(x, p["kernel"], p["bias"])


def _coupler_transformer_tokenwise(x: torch.Tensor, blocks: dict) -> torch.Tensor:
    """The UPT coupler transformer with the reference's semantics: its
    seq-major attention sees the (1, L, D) prompt sequence as L batches
    of one token, so each token attends only to itself; the softmax over
    one logit is 1 and attention reduces to out_proj(v_proj(ln_1(x))),
    tokenwise."""
    for i in range(blocks["ln_1"]["scale"].shape[0]):
        p = layers.layer_params(blocks, i)
        y = layers.layer_norm(x, p["ln_1"])
        d = x.shape[-1]
        v = layers._matmul(y, p["attn"]["qkv_w"][:, 2 * d:], p["attn"]["qkv_b"][2 * d:])
        x = x + layers._matmul(v, p["attn"]["out_w"], p["attn"]["out_b"])
        x = x + layers.mlp(layers.layer_norm(x, p["ln_2"]), p["mlp"])
    return x


def upt_couple(prompt_params: dict, spec: PromptSpec):
    """UPT coupler: flatten the CoOp ctx and every VPT layer into one
    sequence, pre-project to PROJECT_DIM, run the shared 1-layer
    transformer in fp32, split and post-project back.

    Returns (coop_ctx, vpt_shallow, vpt_deep) in fp32."""
    coop_ctx = prompt_params.get("coop", {}).get("ctx")
    vpt = prompt_params.get("vpt", {})
    vpt_emb = vpt.get("embeddings")
    vpt_deep = vpt.get("embeddings_deep")

    if not spec.has_coupler:
        return coop_ctx, vpt_emb, vpt_deep

    proj = prompt_params["mvlpt_proj"]
    v = vpt_emb  # (1, n_vpt, vpt_dim)
    if spec.vpt_deep and vpt_deep is not None:
        v = torch.cat([v, vpt_deep], dim=0)  # (L, n_vpt, vpt_dim)
    n_vpt_rows = v.shape[0]
    v = v.reshape(1, -1, v.shape[-1]).float()

    c = coop_ctx if coop_ctx.dim() == 3 else coop_ctx[None]
    c = c.reshape(1, -1, c.shape[-1]).float()
    coop_len = c.shape[1]

    if "coop_pre" in proj:
        c = _linear(c, proj["coop_pre"])
    if "vpt_pre" in proj:
        v = _linear(v, proj["vpt_pre"])

    seq = torch.cat([c, v], dim=1)  # (1, coop_len + L*n_vpt, d)
    if spec.project_method == "transformer":
        seq = _coupler_transformer_tokenwise(seq, proj["transformer"])
    elif spec.project_method == "transformer_seq":
        seq = layers.transformer(seq, proj["transformer"], n_heads=1)
    elif spec.project_method == "mlp":
        seq = torch.nn.functional.gelu(seq, approximate="tanh")  # jax.nn.gelu's default
    seq = seq.float()

    c, v = seq[:, :coop_len], seq[:, coop_len:]
    if "coop_post" in proj:
        c = _linear(c, proj["coop_post"])
    if "vpt_post" in proj:
        v = _linear(v, proj["vpt_post"])

    c = c.reshape(-1, spec.coop_n_ctx, spec.text_width)
    c = c[0] if c.shape[0] == 1 else c
    v = v.reshape(n_vpt_rows, spec.vpt_n_ctx, spec.vpt_dim)
    v_deep = None if n_vpt_rows == 1 else v[1:]
    return c, v[:1], v_deep


def vpt_prepare(prompt_params: dict, spec: PromptSpec, vpt_shallow, vpt_deep, rng=None):
    """Apply the optional VPT projection and dropout to the shallow and
    deep prompts (the reference's mvlpt.py:424, 77-79), as the JAX package
    does. ``rng`` is the train step's () int64 key (``layers.dropout_key``),
    None at eval: the shallow and deep rows take separate draws (streams 0
    and 1, the JAX package's k1 and k2). As there, one mask a step is
    shared across the batch (dropout before the broadcast), where the
    reference draws one per image."""
    if not spec.has_vpt:
        return None, None
    vpt = prompt_params["vpt"]
    if vpt_shallow is None:
        vpt_shallow = vpt["embeddings"]
    if vpt_deep is None and spec.vpt_deep:
        vpt_deep = vpt.get("embeddings_deep")
    proj = vpt.get("proj")
    if proj is not None:
        vpt_shallow = _linear(vpt_shallow.float(), proj)
        if vpt_deep is not None:
            vpt_deep = _linear(vpt_deep.float(), proj)
    if rng is not None and spec.vpt_dropout > 0:
        vpt_shallow = layers.dropout(vpt_shallow, spec.vpt_dropout, rng, stream=0)
        if vpt_deep is not None:
            vpt_deep = layers.dropout(vpt_deep, spec.vpt_dropout, rng, stream=1)
    return vpt_shallow, vpt_deep


def coop_assemble(ctx: torch.Tensor | None, consts: PromptConsts,
                  spec: PromptSpec) -> torch.Tensor:
    """Assemble (n_cls, S, Wt) prompt embeddings: 'end' is a concat;
    'middle'/'front' apply the precomputed per-class gather."""
    prefix, suffix = consts.token_prefix, consts.token_suffix
    if ctx is None:
        return torch.cat([prefix, suffix], dim=1)
    if ctx.dim() == 2:
        ctx = ctx[None].expand(spec.n_cls, ctx.shape[0], ctx.shape[1])
    ctx = ctx.to(prefix.dtype)
    prompts = torch.cat([prefix, ctx, suffix], dim=1)
    if consts.perm is not None:
        idx = consts.perm[:, :, None].expand(-1, -1, prompts.shape[-1])
        prompts = torch.gather(prompts, 1, idx)
    return prompts


def cocoop_assemble(ctx: torch.Tensor, consts: PromptConsts) -> torch.Tensor:
    """(c * n_cls, S, Wt) prompt embeddings of ``c`` instances' contexts
    ``ctx`` (c, n_ctx, Wt): each instance's (n_cls, S, Wt) grid as
    :func:`coop_assemble` builds it from a shared context, instance-major
    (the JAX package's vmap of coop_assemble, then a reshape)."""
    prefix, suffix = consts.token_prefix, consts.token_suffix
    c, n_cls = ctx.shape[0], prefix.shape[0]
    ctx = ctx[:, None].expand(c, n_cls, *ctx.shape[1:]).to(prefix.dtype)
    prompts = torch.cat([prefix.expand(c, *prefix.shape), ctx,
                         suffix.expand(c, *suffix.shape)], dim=2)
    if consts.perm is not None:
        idx = consts.perm[None, :, :, None].expand(c, -1, -1, prompts.shape[-1])
        prompts = torch.gather(prompts, 2, idx)
    return prompts.reshape(c * n_cls, *prompts.shape[2:])


def cocoop_condition(prompt_params: dict, spec: PromptSpec,
                     image_features: torch.Tensor) -> torch.Tensor:
    """CoCoOp's instance-conditioned contexts: the shared ctx shifted by a
    meta-net bias per image (Linear, ReLU, Linear in fp32). Returns
    (B, n_ctx, Wt)."""
    cc = prompt_params["cocoop"]
    mn = cc["meta_net"]
    h = torch.relu(_linear(image_features.float(), mn["linear1"]))
    bias = _linear(h, mn["linear2"])  # (B, Wt)
    return cc["ctx"][None] + bias[:, None, :]
