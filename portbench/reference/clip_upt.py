"""The plain reference of MVLPT UPT on a frozen CLIP: float32 PyTorch,
no kernels, no packing, no cache, no graph.

It follows the published description and the reference repository's
semantics:

* CLIP's image tower (Radford et al. 2021): CLIP's pixel normalisation,
  16 x 16 patches flattened in (row, column, channel) order, a class
  token, positions, ln_pre, pre-LN residual blocks (QuickGELU MLP),
  ln_post on the class token, the projection. Deep VPT (Jia et al.
  2022): the shallow prompts sit after the class token, and before every
  block past the first the prompt rows are replaced by that layer's.
* CLIP's text tower run per class over that class's own tokens, under a
  causal mask: CoOp's prompt ``X ... X <name>.`` tokenized whole, the
  learned context in place of the X's, the class name moved into the
  middle of the context (CoOp's 'middle'), the feature at the EOT token.
* The UPT coupler (MVLPT): the CoOp context and every VPT row projected
  to the coupler width, one CLIP-style block in which each token attends
  to itself alone (the reference feeds a batch-major tensor to a
  sequence-major attention), projected back.
* Cosine logits scaled by exp(logit_scale); in multitask training each
  row's logits outside its task's class range are multiplied by 0; the
  cross-entropy's mean over the batch; SGD with momentum, weight decay
  and the per-epoch learning rate of a constant warm-up and a cosine.

``mm`` is the product of every matrix product inside the two towers:
``matmul32`` for the reference, ``matmul_fp8`` for the control, which
rounds both operands to float8 e4m3 with a per-tensor scale. The
coupler and the logits stay float32 in both.

The weights come in the port's parameter schema (every linear kernel
(in, out), blocks stacked on a leading layer axis), which the benchmark
fills from the seed; they are read, upcast to float32, and never
changed.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # the largest float8 e4m3fn value


def matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest value; the gradient passes
    straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def matmul_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_fp8(a), _fp8(b))


def layer_norm(x, p, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _layer(blocks: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i].float() for k, v in blocks.items()}


def block(x, p, n_heads, mask, mm):
    """One pre-LN residual block over (N, S, W)."""
    n, s, w = x.shape
    d = w // n_heads
    h = layer_norm(x, p["ln_1"])
    qkv = mm(h, p["attn"]["qkv_w"]) + p["attn"]["qkv_b"]
    q, k, v = qkv.reshape(n, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    if mask is not None:
        scores = scores + mask
    o = mm(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(n, s, w)
    x = x + mm(o, p["attn"]["out_w"]) + p["attn"]["out_b"]
    h = layer_norm(x, p["ln_2"])
    a = quick_gelu(mm(h, p["mlp"]["fc_w"]) + p["mlp"]["fc_b"])
    return x + mm(a, p["mlp"]["proj_w"]) + p["mlp"]["proj_b"]


def _run_block(x, blocks, i, n_heads, mask, mm):
    # Each block is checkpointed while autograd records, so that the
    # reference holds one block's activations at a time (the text tower
    # of a thousand classes).
    if torch.is_grad_enabled():
        return checkpoint(lambda t: block(t, _layer(blocks, i), n_heads, mask, mm), x,
                          use_reentrant=False)
    return block(x, _layer(blocks, i), n_heads, mask, mm)


def image_features(vis: dict, images: torch.Tensor, shallow, deep, cfg: dict, normalize: dict,
                   mm=matmul32) -> torch.Tensor:
    """(B, H, W, 3) uint8 images -> (B, embed) features."""
    p = cfg["vision_patch_size"]
    mean = torch.tensor(normalize["mean"], device=images.device)
    std = torch.tensor(normalize["std"], device=images.device)
    x = (images.float() / 255.0 - mean) / std
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    x = mm(x.reshape(b, (h // p) * (w // p), p * p * c), vis["patch_embed"]["kernel"].float())
    cls = vis["class_embedding"].float().expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + vis["pos_embedding"].float()
    x = layer_norm(x, vis["ln_pre"])
    n = shallow.shape[-2]
    x = torch.cat([x[:, :1], shallow.expand(b, n, x.shape[-1]), x[:, 1:]], dim=1)
    for i in range(cfg["vision_layers"]):
        if i >= 1:
            x = torch.cat([x[:, :1], deep[i - 1].expand(b, n, x.shape[-1]), x[:, 1 + n:]], dim=1)
        x = _run_block(x, vis["blocks"], i, cfg["vision_heads"], None, mm)
    return mm(layer_norm(x[:, 0], vis["ln_post"]), vis["proj"].float())


class ClassPrompts:
    """Each class's CoOp prompt, tokenized whole (``X ... X <name>.``),
    laid out as the text tower reads it: position j of class i holds the
    token ``token[i, j]``, or context row ``ctx_row[i, j]`` where that is
    not -1; ``eot[i]`` is the EOT's position. The class name's tokens
    move into the middle of the context (CoOp's 'middle')."""

    def __init__(self, tokenizer, classnames, n_ctx: int, device):
        half = n_ctx // 2
        layouts = []
        for name in classnames:
            name = name.replace("_", " ")
            ids = ([tokenizer.sot_token] + tokenizer.encode(" ".join(["X"] * n_ctx) + f" {name}.")
                   + [tokenizer.eot_token])
            name_len = len(tokenizer.encode(name))
            ctx = [(-1, j) for j in range(n_ctx)]
            name_ids = [(t, -1) for t in ids[1 + n_ctx:1 + n_ctx + name_len]]
            rest = [(t, -1) for t in ids[1 + n_ctx + name_len:]]
            layouts.append([(ids[0], -1)] + ctx[:half] + name_ids + ctx[half:] + rest)
        longest = max(len(lay) for lay in layouts)
        pad = [(0, -1)]
        cells = [lay + pad * (longest - len(lay)) for lay in layouts]
        self.token = torch.tensor([[max(t, 0) for t, _ in row] for row in cells], device=device)
        self.ctx_row = torch.tensor([[c for _, c in row] for row in cells], device=device)
        self.eot = torch.tensor([len(lay) - 1 for lay in layouts], device=device)


def text_features(txt: dict, ctx: torch.Tensor, prompts: ClassPrompts, cfg: dict,
                  mm=matmul32) -> torch.Tensor:
    """(n_cls, embed) features, each class run over its own tokens with
    the context ``ctx`` (n_ctx, width) in its place."""
    n, longest = prompts.token.shape
    x = txt["token_embedding"][prompts.token].float()
    x = torch.where((prompts.ctx_row >= 0)[..., None], ctx[prompts.ctx_row.clamp_min(0)], x)
    # Positions past a class's EOT change no feature that is read: the
    # mask is causal.
    x = x + txt["pos_embedding"][:longest].float()
    mask = torch.full((longest, longest), float("-inf"), device=x.device).triu(1)
    for i in range(cfg["transformer_layers"]):
        x = _run_block(x, txt["blocks"], i, cfg["transformer_heads"], mask, mm)
    x = layer_norm(x[torch.arange(n, device=x.device), prompts.eot], txt["ln_final"])
    return mm(x, txt["text_projection"].float())


def _linear(x, p):
    return x @ p["kernel"] + p["bias"]


def couple(pp: dict, prompt_cfg: dict, vision_layers: int):
    """The UPT coupler -> (CoOp context (n_ctx, Wt), shallow VPT (1, n, Wv),
    deep VPT (L - 1, n, Wv))."""
    proj = pp["mvlpt_proj"]
    ctx = pp["coop"]["ctx"]
    vpt = torch.cat([pp["vpt"]["embeddings"], pp["vpt"]["embeddings_deep"]])  # (L, n, Wv)
    n_ctx, n_vpt, wv = ctx.shape[0], vpt.shape[1], vpt.shape[2]
    x = torch.cat([_linear(ctx, proj["coop_pre"]),
                   _linear(vpt.reshape(-1, wv), proj["vpt_pre"])])
    p = _layer(proj["transformer"], 0)
    d = x.shape[-1]
    v = layer_norm(x, p["ln_1"]) @ p["attn"]["qkv_w"][:, 2 * d:] + p["attn"]["qkv_b"][2 * d:]
    x = x + v @ p["attn"]["out_w"] + p["attn"]["out_b"]
    h = quick_gelu(layer_norm(x, p["ln_2"]) @ p["mlp"]["fc_w"] + p["mlp"]["fc_b"])
    x = x + h @ p["mlp"]["proj_w"] + p["mlp"]["proj_b"]
    ctx = _linear(x[:n_ctx], proj["coop_post"])
    vpt = _linear(x[n_ctx:], proj["vpt_post"]).reshape(vision_layers, n_vpt, wv)
    return ctx, vpt[:1], vpt[1:]


def logits(backbone, pp, images, prompts, cfg, normalize, tasks=None, ranges=None,
           mm=matmul32) -> torch.Tensor:
    """(B, n_cls) float32 logits of the UPT model."""
    ctx, shallow, deep = couple(pp, cfg["prompt"], cfg["clip"]["vision_layers"])
    img = image_features(backbone["visual"], images, shallow, deep, cfg["clip"], normalize, mm)
    txt = text_features(backbone["text"], ctx, prompts, cfg["clip"], mm)
    return scaled_cosines(backbone, img, txt, tasks, ranges)


def scaled_cosines(backbone, img, txt, tasks=None, ranges=None) -> torch.Tensor:
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    out = backbone["logit_scale"].float().exp() * img @ txt.t()
    if tasks is not None:
        cls = torch.arange(out.shape[-1], device=out.device)[None]
        lo, hi = ranges[0][tasks][:, None], ranges[1][tasks][:, None]
        out = out * ((cls >= lo) & (cls < hi)).float()
    return out


def cross_entropy(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(out, dim=-1).gather(1, labels[:, None]).mean()


def learning_rate(optim: dict, count: int, steps_per_epoch: int) -> float:
    """The lr of update ``count`` (0-based): a constant warm-up for
    WARMUP_EPOCH epochs, then a cosine over MAX_EPOCH whose epoch count
    restarts after the warm-up."""
    epoch = min(count // steps_per_epoch, optim["MAX_EPOCH"])
    warm = optim["WARMUP_EPOCH"]
    if epoch < warm:
        return optim["WARMUP_CONS_LR"]
    return optim["LR"] * 0.5 * (1.0 + math.cos(math.pi * (epoch - warm) / optim["MAX_EPOCH"]))


class SGD:
    """SGD with momentum and weight decay added to the gradient, from
    update ``count`` (0-based) on with the momentum ``buffers`` that the
    updates before it left (none before the first: its buffer is the
    gradient itself)."""

    def __init__(self, optim: dict, steps_per_epoch: int, count: int = 0, buffers=None):
        if optim["NAME"] != "sgd" or optim["SGD_NESTEROV"] or optim["SGD_DAMPNING"]:
            raise ValueError("the reference runs plain SGD with momentum only")
        self.optim, self.steps_per_epoch = optim, steps_per_epoch
        self.count, self.buffers = count, buffers

    @torch.no_grad()
    def step(self, params: list, grads: list) -> None:
        wd, mom = self.optim["WEIGHT_DECAY"], self.optim["MOMENTUM"]
        decayed = [g + wd * p for p, g in zip(params, grads)]
        if self.buffers is None:
            self.buffers = [d.clone() for d in decayed]
        else:
            for buf, d in zip(self.buffers, decayed):
                buf.mul_(mom).add_(d)
        lr = learning_rate(self.optim, self.count, self.steps_per_epoch)
        for p, buf in zip(params, self.buffers):
            p.sub_(lr * buf)
        self.count += 1
