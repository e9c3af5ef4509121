"""Prompt learner: trainable prompt params + static assembly metadata.

The counterpart of ``mvlpt_tpu/prompts/learner.py``:

  * ``PromptSpec``   - static hyperparameters (shapes, modes);
  * prompt params    - one nested dict of fp32 leaf tensors holding the
                       CoOp context, VPT shallow/deep embeddings and the
                       UPT coupler; the only tensors that take gradients;
  * ``PromptConsts`` - frozen task buffers: the embedded prompt prefix
                       and suffix, EOT indices, and the gather that puts
                       the class token in the 'middle' or at the 'front'.

CoCoOp's meta-net is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mvlpt_torch.core.clip import init_block_stack
from mvlpt_torch.tokenizer import get_tokenizer, tokenize
from mvlpt_torch.utils.device import resolve_device
from mvlpt_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class PromptSpec:
    n_cls: int
    coop_n_ctx: int = 0
    vpt_n_ctx: int = 0
    cocoop_n_ctx: int = 0
    coop_csc: bool = False
    vpt_deep: bool = True
    vpt_proj_dim: int = -1          # VPT.PROJECT: -1 = identity
    vpt_dropout: float = 0.0
    class_token_position: str = "end"
    project_method: str = "transformer"  # identity / mlp / transformer
    project_dim: int = 128
    context_length: int = 77        # realized max length (CUT_CONTEXTLEN)
    vision_layers: int = 12
    vision_width: int = 768
    text_width: int = 512
    embed_dim: int = 512
    vision_patch_size: int = 16

    @property
    def has_coop(self) -> bool:
        return self.coop_n_ctx > 0

    @property
    def has_vpt(self) -> bool:
        return self.vpt_n_ctx > 0

    @property
    def has_cocoop(self) -> bool:
        return self.cocoop_n_ctx > 0

    @property
    def has_coupler(self) -> bool:
        return self.has_coop and self.has_vpt and self.project_method != "identity"

    @property
    def text_is_static(self) -> bool:
        """True when the text tower's output depends on no trained
        parameter (pure VPT: no CoOp context, no CoCoOp, no coupler), so
        a caller may compute the text features once for many steps."""
        return not (self.has_coop or self.has_cocoop or self.has_coupler)

    @property
    def vpt_dim(self) -> int:
        return self.vpt_proj_dim if self.vpt_proj_dim > -1 else self.vision_width


@dataclasses.dataclass
class PromptConsts:
    """Frozen task-dependent buffers."""

    token_prefix: torch.Tensor      # (n_cls, 1, Wt) SOT embedding
    token_suffix: torch.Tensor      # (n_cls, S-1-n_ctx, Wt) name+EOT+pad embedding
    eot_idx: torch.Tensor           # (n_cls,) argmax of token ids
    perm: torch.Tensor | None       # (n_cls, S) gather for middle/front, None=end
    tokenized: np.ndarray | None = dataclasses.field(default=None, repr=False)


def _prompt_prefix(spec: PromptSpec, ctx_init: str = "") -> str:
    n_ctx = spec.cocoop_n_ctx if spec.has_cocoop else spec.coop_n_ctx
    if ctx_init:
        return ctx_init.replace("_", " ")
    if n_ctx > 0:
        return " ".join(["X"] * n_ctx)
    return "a photo of a"  # pure-VPT prompts keep a hand template


def format_prompts(classnames, spec: PromptSpec, ctx_init: str = "") -> list[str]:
    prefix = _prompt_prefix(spec, ctx_init)
    return [f"{prefix} {name.replace('_', ' ')}." for name in classnames]


def compute_cut_context_length(classnames, n_ctx: int, max_cap: int = 77,
                               ctx_init: str = "") -> int:
    """CUT_CONTEXTLEN: the longest prompt's token count (+SOT +EOT),
    capped at the model context length."""
    tok = get_tokenizer()
    spec_tmp = PromptSpec(n_cls=len(classnames), coop_n_ctx=n_ctx)
    prompts = format_prompts(classnames, spec_tmp, ctx_init)
    longest = max(len(tok.encode(p)) + 2 for p in prompts)
    return min(max_cap, longest)


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (hi - lo) + lo


def _torch_linear_init(gen, in_dim, out_dim):
    """nn.Linear's default: U(-1/sqrt(in), 1/sqrt(in)) for W and b; W is (in, out)."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"kernel": _uniform(gen, (in_dim, out_dim), -bound, bound),
            "bias": _uniform(gen, (out_dim,), -bound, bound)}


def init_prompt_params(gen: torch.Generator, spec: PromptSpec, device="cuda",
                       clip_params: dict | None = None, coop_ctx_init: str = "") -> dict:
    """Initialize the trainable prompt tree (fp32 masters) with the JAX
    package's distributions: VPT xavier-uniform with fan 3*patch^2 +
    vpt_dim; CoOp N(0, 0.02) or the embeddings of the init words; the UPT
    coupler a CLIP-style 1-layer transformer plus nn.Linear-default
    pre/post projections. Drawn on the host from ``gen``."""
    device = resolve_device(device)
    if spec.has_cocoop:
        raise NotImplementedError("CoCoOp prompts are not ported yet (ROADMAP.md Queue 1)")
    params: dict = {}
    if spec.has_vpt:
        val = math.sqrt(6.0 / (3 * spec.vision_patch_size ** 2 + spec.vpt_dim))
        vpt = {"embeddings": _uniform(gen, (1, spec.vpt_n_ctx, spec.vpt_dim), -val, val)}
        if spec.vpt_deep:
            vpt["embeddings_deep"] = _uniform(
                gen, (spec.vision_layers - 1, spec.vpt_n_ctx, spec.vpt_dim), -val, val)
        if spec.vpt_proj_dim > -1:
            std = math.sqrt(2.0 / spec.vision_width)  # kaiming_normal, fan_out
            vpt["proj"] = {
                "kernel": torch.randn((spec.vpt_dim, spec.vision_width), generator=gen) * std,
                "bias": torch.zeros(spec.vision_width),
            }
        params["vpt"] = vpt

    if spec.has_coop:
        if coop_ctx_init:
            ids = tokenize(coop_ctx_init.replace("_", " "))
            emb = clip_params["text"]["token_embedding"].float().cpu()
            ctx = emb[torch.from_numpy(ids[0, 1:1 + spec.coop_n_ctx]).long()]
        elif spec.coop_csc:
            ctx = torch.randn((spec.n_cls, spec.coop_n_ctx, spec.text_width),
                              generator=gen) * 0.02
        else:
            ctx = torch.randn((spec.coop_n_ctx, spec.text_width), generator=gen) * 0.02
        params["coop"] = {"ctx": ctx}

    if spec.has_coupler:
        d = spec.project_dim
        proj = {}
        if spec.text_width != d:
            proj["coop_pre"] = _torch_linear_init(gen, spec.text_width, d)
            proj["coop_post"] = _torch_linear_init(gen, d, spec.text_width)
        if spec.vpt_dim != d:
            proj["vpt_pre"] = _torch_linear_init(gen, spec.vpt_dim, d)
            proj["vpt_post"] = _torch_linear_init(gen, d, spec.vpt_dim)
        if spec.project_method in ("transformer", "transformer_seq"):
            proj["transformer"] = init_block_stack(gen, 1, d)
        params["mvlpt_proj"] = proj

    return tree_map(lambda t: t.to(device=device, dtype=torch.float32), params)


def _position_permutation(spec: PromptSpec, name_lens: np.ndarray) -> np.ndarray | None:
    """Permutation over the 'end'-layout sequence [SOT, ctx, suffix] that
    puts the class name in the middle of the context or at its front.
    The EOT position is unchanged, so the id-argmax gather stays valid."""
    pos = spec.class_token_position
    if pos == "end" or not spec.has_coop:
        return None
    n_cls, s, n_ctx = spec.n_cls, spec.context_length, spec.coop_n_ctx
    half = n_ctx // 2
    perm = np.zeros((n_cls, s), dtype=np.int32)
    for i, nl in enumerate(name_lens):
        nl = int(nl)
        name = list(range(1 + n_ctx, 1 + n_ctx + nl))
        rest = list(range(1 + n_ctx + nl, s))
        if pos == "middle":
            order = [0] + list(range(1, 1 + half)) + name + list(range(1 + half, 1 + n_ctx)) + rest
        elif pos == "front":
            order = [0] + name + list(range(1, 1 + n_ctx)) + rest
        else:
            raise ValueError(f"bad class_token_position {pos!r}")
        perm[i] = order
    return perm


def build_prompt_consts(classnames, spec: PromptSpec, clip_params: dict,
                        compute_dtype=torch.bfloat16, ctx_init: str = "") -> PromptConsts:
    """Tokenize and embed all class prompts with the frozen token
    embedding, and precompute the EOT indices and position gathers. The
    tensors live on the token embedding's device."""
    tok = get_tokenizer()
    classnames = [c.replace("_", " ") for c in classnames]
    name_lens = np.array([len(tok.encode(c)) for c in classnames], np.int32)
    prompts = format_prompts(classnames, spec, ctx_init)
    tokenized = tokenize(prompts, context_length=spec.context_length)

    emb_table = clip_params["text"]["token_embedding"]
    device = emb_table.device
    embedded = emb_table.to(compute_dtype)[torch.from_numpy(tokenized).long().to(device)]

    n_ctx = spec.cocoop_n_ctx if spec.has_cocoop else spec.coop_n_ctx
    perm = _position_permutation(spec, name_lens)
    return PromptConsts(
        token_prefix=embedded[:, :1],
        token_suffix=embedded[:, 1 + n_ctx:],
        eot_idx=torch.from_numpy(tokenized.argmax(axis=-1)).long().to(device),
        perm=None if perm is None else torch.from_numpy(perm).long().to(device),
        tokenized=tokenized,
    )
