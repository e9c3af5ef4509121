"""The comparison that decides ``correct``: what the timed path produced
against the plain float32 reference (``portbench/reference``), each
number against its cell's limit (``portbench/limits/<cell>.json``).

Training cells (``loops/train_window.py``): the last measured window,
which the reference follows from the state the program held before it,
and the set-up window's first steps, which it follows from the seed's
leaves. Per step, the loss and the gradient's norm, each as a gap
relative to the reference's, worst step (``loss_gap``,
``grad_norm_gap``). Per leaf, after the last window: the momentum
buffer, the gradient as the optimizer holds it, and the leaf's change
over the window, each as the gap between the program's norm and the
reference's (``momentum_gap``, ``change_gap``) and as the norm of their
difference (``momentum_dir_gap``, ``change_dir_gap``), over the
reference's norm of that leaf or of the median leaf, whichever is
larger, worst leaf; and the median leaf's gap of change norms
(``change_median_gap``), which a learning rate off by a share reads as
that share, and which swings less from seed to seed than the worst
leaf's over a window of steps at the cosine's rate. Leaves whose gradient in the reference (its RMS over
the window) is under a thousandth of the median leaf's move by round-off
alone, and leaves the reference moves by under ROUNDING float32 spacings
of their values are moved by the parameters' rounding: both are left out
of the change, by these rules on the reference, never by name. Each cell
compares the numbers its limits file names; the rest are printed.

The cached-text eval: the text features computed at set-up (per class,
the distance over the reference's norm, worst class) and every answer
that reached the host in the window (each logit's distance from the
reference's, worst one, over the logit scale: a distance of cosines).
"""

from __future__ import annotations

import statistics

import torch

from portbench.program import classnames, task_bounds
from portbench.reference import clip_upt
from portbench.reference.tokenizer import ClipBpeTokenizer

NEGLIGIBLE_GRAD = 1e-3   # of the median leaf's gradient norm
ROUNDING = 10            # float32 spacings of a leaf's values (RMS), for its change


def unflatten(pairs) -> dict:
    out: dict = {}
    for path, value in pairs:
        node = out
        *head, last = path.split(".")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = value
    return out


class Reference:
    """The reference's view of one cell: its own class prompts from its
    own tokenizer and the merges file, the task ranges from the
    configuration, and the frozen weights the benchmark made."""

    def __init__(self, cfg: dict, backbone: dict, vocab_path: str, device, mm=clip_upt.matmul32):
        self.cfg, self.backbone, self.mm = cfg, backbone, mm
        self.device = torch.device(device)
        tok = ClipBpeTokenizer(vocab_path)
        self.prompts = clip_upt.ClassPrompts(tok, classnames(cfg), cfg["prompt"]["coop_n_ctx"],
                                             self.device)
        self.logit_scale = backbone["logit_scale"].float().exp().item()
        bounds = task_bounds(cfg)
        self.ranges = None if bounds is None else (
            torch.tensor([b[0] for b in bounds], device=self.device),
            torch.tensor([b[1] for b in bounds], device=self.device))

    def logits(self, params: dict, images, tasks=None):
        return clip_upt.logits(self.backbone, params, images.to(self.device), self.prompts,
                               self.cfg, self.cfg["normalize"],
                               None if tasks is None else tasks.to(self.device), self.ranges,
                               self.mm)

    def train(self, start: list, momentum: list | None, count: int, batches: dict,
              steps_per_epoch: int, half_batch: bool = False) -> dict:
        """Steps from leaves ``start`` [(path, tensor)], momentum buffers
        ``momentum`` (None before the first update) and update ``count``
        over ``batches`` (K, B, ...): per-step losses and gradient norms,
        the momentum and the leaves after the last step, and each leaf's
        gradient RMS over the steps. ``half_batch``: each loss over the
        first half of the batch only (a fault, for its reading)."""
        leaves = [t.detach().to(self.device, torch.float32).clone().requires_grad_(True)
                  for _, t in start]
        params = unflatten(zip([p for p, _ in start], leaves))
        bufs = None if momentum is None else [
            b.detach().to(self.device, torch.float32).clone() for b in momentum]
        sgd = clip_upt.SGD(self.cfg["optim"], steps_per_epoch, count, bufs)
        losses, norms = [], []
        sq = [torch.zeros((), dtype=torch.float64, device=self.device) for _ in leaves]
        tasks = batches.get("task")
        n = batches["image"].shape[0]
        rows = slice(0, batches["image"].shape[1] // 2 if half_batch else None)
        for k in range(n):
            out = self.logits(params, batches["image"][k][rows],
                              None if tasks is None else tasks[k][rows])
            loss = clip_upt.cross_entropy(out, batches["label"][k][rows].to(self.device))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            leaf_sq = [g.double().square().sum() for g in grads]
            norms.append(torch.stack(leaf_sq).sum().sqrt())
            sq = [a + b for a, b in zip(sq, leaf_sq)]
            losses.append(loss.detach())
            sgd.step(leaves, grads)
        return {"losses": torch.stack(losses).double().cpu(),
                "grad_norms": torch.stack(norms).cpu(),
                "grad_rms": [(v / n).sqrt().item() for v in sq],
                "momentum": [b.detach().cpu() for b in sgd.buffers],
                "params": [p.detach().cpu() for p in leaves]}

    @torch.no_grad()
    def eval(self, params: dict, pool: dict, indices) -> tuple:
        """(text features, {pool index: logits}) of the cached-text eval
        over ``pool`` (images (n, B, ...), optionally their tasks)."""
        ctx, shallow, deep = clip_upt.couple(params, self.cfg["prompt"],
                                             self.cfg["clip"]["vision_layers"])
        txt = clip_upt.text_features(self.backbone["text"], ctx, self.prompts, self.cfg["clip"],
                                     self.mm)
        tasks = pool.get("task")
        out = {}
        for j in indices:
            img = clip_upt.image_features(self.backbone["visual"], pool["image"][j].to(self.device),
                                          shallow, deep, self.cfg["clip"],
                                          self.cfg["normalize"], self.mm)
            out[j] = clip_upt.scaled_cosines(
                self.backbone, img, txt, None if tasks is None else tasks[j].to(self.device),
                self.ranges).cpu()
        return txt.cpu(), out


def _leaf_gaps(got: list, want: list, keep=None, apart: bool = False) -> list[tuple[float, int]]:
    """(|‖got‖ - ‖want‖|, or with ``apart`` ‖got - want‖, over
    max(‖want‖, the median leaf's ‖want‖), leaf) of every leaf kept, the
    worst first."""
    got = [g.detach().double().cpu() for g in got]
    want = [w.detach().double().cpu() for w in want]
    want_norms = [w.norm().item() for w in want]
    if apart:
        num = [(g - w).norm().item() for g, w in zip(got, want)]
    else:
        num = [abs(g.norm().item() - n) for g, n in zip(got, want_norms)]
    median = statistics.median(want_norms)
    idx = range(len(want)) if keep is None else keep
    return sorted(((num[i] / max(want_norms[i], median), i) for i in idx), reverse=True)


def _beyond_rounding(start: torch.Tensor, end: torch.Tensor) -> bool:
    """Whether the reference moved a leaf by ROUNDING float32 spacings of
    its values or more (RMS over the leaf). A leaf of values near 1 (a
    LayerNorm scale) moves by about one spacing a step at the warm-up's lr
    of 1e-5, so its change is the parameters' own rounding."""
    s = start.detach().float().cpu()
    spacing = (torch.nextafter(s, torch.full_like(s, float("inf"))) - s).double()
    delta = end.double() - s.double()
    return delta.square().mean().sqrt().item() >= ROUNDING * spacing.square().mean().sqrt().item()


def _step_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst step's |got - want| over |want|."""
    return ((got.double() - want.double()).abs() / want.double().abs()).max().item()


def train_readings(got: dict, ref: dict, start: list, names: list) -> dict:
    """The numbers of a training cell: ``got`` the program's (or a
    stand-in's) output, ``ref`` the reference's, ``start`` the leaves
    both began the last window from, ``names`` the leaves' paths."""
    start = [t.double().cpu() for t in start]
    median = statistics.median(ref["grad_rms"])
    moved = [i for i, g in enumerate(ref["grad_rms"])
             if g >= NEGLIGIBLE_GRAD * median and _beyond_rounding(start[i], ref["params"][i])]
    moment = _leaf_gaps(got["momentum"], ref["momentum"])
    moment_dir = _leaf_gaps(got["momentum"], ref["momentum"], apart=True)
    d_got = [p.double() - s for p, s in zip(got["params"], start)]
    d_ref = [p.double() - s for p, s in zip(ref["params"], start)]
    change = _leaf_gaps(d_got, d_ref, moved)
    change_dir = _leaf_gaps(d_got, d_ref, moved, apart=True)
    return {
        "loss_gap": _step_gap(got["losses"], ref["losses"]),
        "grad_norm_gap": _step_gap(got["grad_norms"], ref["grad_norms"]),
        "momentum_gap": moment[0][0],
        "momentum_dir_gap": moment_dir[0][0],
        "change_gap": change[0][0],
        "change_dir_gap": change_dir[0][0],
        "change_median_gap": statistics.median(g for g, _ in change),
        # Which leaves read worst, and the leaves left out of the change.
        "worst": {"momentum_gap": [[names[i], g] for g, i in moment[:3]],
                  "momentum_dir_gap": [[names[i], g] for g, i in moment_dir[:3]],
                  "change_gap": [[names[i], g] for g, i in change[:3]],
                  "change_dir_gap": [[names[i], g] for g, i in change_dir[:3]],
                  "left_out": [names[i] for i in range(len(names)) if i not in moved]},
    }


def eval_readings(text: torch.Tensor, low: dict, high: dict, ref_text, ref_logits: dict,
                  logit_scale: float) -> dict:
    """The two numbers of the cached-text eval: every answer in ``low``
    and ``high`` (the least and greatest logits a pool batch got), its
    worst logit's distance from the reference's in units of the logit
    scale exp(logit_scale), that is, as a distance of cosines."""
    t, r = text.double(), ref_text.double()
    text_gap = ((t - r).norm(dim=-1) / r.norm(dim=-1)).max().item()
    worst = max(max((high[j].double() - v.double()).abs().max().item(),
                    (low[j].double() - v.double()).abs().max().item())
                for j, v in ref_logits.items())
    return {"text_gap": text_gap, "logit_gap": worst / logit_scale}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    or under its limit, and every limit read."""
    checks = {name: {"value": readings.get(name), "limit": lim["limit"]}
              for name, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
