"""The train step (forward both towers, soft-label cross-entropy,
backward into the prompt params only, the device optimizer's update)
and the eval steps.

The counterpart of ``make_train_step``, ``make_eval_step`` and
``make_cached_text_eval`` in ``mvlpt_tpu/train/train_step.py``.
Multi-label targets are normalised to distributions; accuracy is taken
against the argmax of the labels. Eval runs under ``torch.no_grad()``
with the fused half-block kernels in their no-grad forwards.

Under a mesh (``parallel.Mesh``) the train step runs this data rank's
rows (the global batch cut by ``parallel.local_batch``, or rows that are
local already), and takes the mean of the prompt gradients, the loss and
the accuracy over the data group, so that every rank makes the
global-batch step. The windowed step does the same each step, its
window's axis 1 holding the rank's rows. The text tower runs whole on
every data rank (the JAX package pads and splits its rows instead; the
values are the same). The eval steps under a data axis run this data
rank's rows of each batch and gather the logits over the data group.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from mvlpt_torch.core.layers import dropout_key
from mvlpt_torch.data.transforms import device_constant
from mvlpt_torch.models.custom_clip import MVLPTModel, TaskClassRanges
from mvlpt_torch.ops.block import BlockKernels
from mvlpt_torch.parallel.mesh import local_batch, over_data_rows
from mvlpt_torch.train.optim import DeviceOptimizer, build_device_optimizer, device_update_
from mvlpt_torch.utils import profiler
from mvlpt_torch.utils.tree import tree_leaves, tree_map


def soft_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE with int labels (B,) or multi-label k-hot / soft labels (B, C)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if labels.dim() == 1:
        nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    else:
        soft = labels.float()
        soft = soft / soft.sum(-1, keepdim=True).clamp_min(1e-8)
        nll = -(soft * logp).sum(-1)
    return nll.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    pred = logits.argmax(-1)
    want = labels if labels.dim() == 1 else labels.argmax(-1)
    return (pred == want).float().mean()


def _prep_images(model, backbone, images, normalize):
    """(images_or_tokens, pre_embedded): uint8 batches go through the
    frozen stem with CLIP normalisation folded into the patch embedding;
    float batches pass through."""
    if normalize is not None and images.dtype == torch.uint8:
        return model.embed_image(backbone, images, normalize=normalize), True
    return images, False


def _ranges_on(task_ranges: TaskClassRanges | None, device) -> TaskClassRanges | None:
    """``task_ranges`` on ``device``: a step builder's first call moves
    them there and keeps them, so no later step copies them."""
    if task_ranges is None or task_ranges.start.device == device:
        return task_ranges
    return task_ranges.to(device)


def _data_mean(tensors, mesh) -> None:
    """In place: the mean of each tensor over the mesh's data group."""
    if mesh is None or mesh.n_data == 1:
        return
    for t in tensors:
        dist.all_reduce(t, group=mesh.data_group)
        t.div_(mesh.n_data)


def step_rng(model, state) -> torch.Tensor | None:
    """The VPT dropout key of the step ``state`` is about to make (a
    function of the epoch's seed and the update count, both on the
    device), or None when the model drops nothing."""
    spec = getattr(model, "spec", None)
    if spec is None or spec.vpt_dropout <= 0:
        return None
    return dropout_key(state.seed, state.opt.count)


def _grads(loss, leaves, step: int | None):
    """d loss / d leaves. Under ``profiler.enable_nan_debugging`` (``step``
    given) a backward that anomaly mode stops at a NaN raises
    FloatingPointError naming the step and the op."""
    if step is None:
        return torch.autograd.grad(loss, leaves)
    try:
        return torch.autograd.grad(loss, leaves)
    except RuntimeError as e:
        if "nan" not in str(e):
            raise
        raise FloatingPointError(f"step {step}: {e}") from e


def apply_gradients(state, loss, logits, labels, mesh=None) -> tuple:
    """The backward of ``loss`` into the state's params and the device
    optimizer's update, in place; returns the 0-dim (loss, acc, grad_norm)
    tensors. Under a mesh the gradients, loss and accuracy are averaged
    over the data group first. Under ``profiler.enable_nan_debugging`` the
    loss, the gradients and the updated params are checked (reading the
    device), and the first non-finite one raises FloatingPointError naming
    the step."""
    leaves = tree_leaves(state.prompt_params)
    step = state.step + 1 if profiler.nan_debugging() else None
    if step is not None:
        profiler.check_finite(step, "loss", [loss])
    with profiler.span("step.bwd"):
        grads = _grads(loss, leaves, step)
    with torch.no_grad(), profiler.span("step.optim"):
        loss, acc = loss.detach(), accuracy(logits, labels)
        _data_mean(grads + (loss, acc), mesh)
        grad_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        if step is not None:
            profiler.check_finite(step, "gradient", grads)
        device_update_(leaves, grads, state.opt)
        if step is not None:
            profiler.check_finite(step, "updated parameter", leaves)
    return loss, acc, grad_norm


def make_train_step(model: MVLPTModel, task_ranges: TaskClassRanges | None = None,
                    normalize: tuple | None = None, mesh=None,
                    pre_embedded: bool = False, local_rows: bool = False) -> Callable:
    """step(state, backbone, consts, batch) -> (state, metrics).

    batch = {"image": (B,H,W,3) float (or uint8 with ``normalize``),
    "label": (B,) int or (B,C), and optionally "task": (B,) int}.
    ``state`` is a ``WindowState`` (``init_train_state``), the same state
    the windowed step takes: its params and its device optimizer are
    updated in place, with the lr read from the per-epoch table by the
    update count on the device, and VPT dropout drawn from the state's
    seed and that count (``step_rng``). Metrics are 0-dim tensors (loss,
    acc, grad_norm); reading them waits for the device. Under ``mesh`` the
    batch is the global one and must divide over the data ranks, or, with
    ``local_rows=True``, this data rank's rows already (the trainer's
    batches, which its loader decodes by rank: ``DataLoader(host_shard=...)``);
    ``backbone`` is this rank's shard (``parallel.shard_backbone``) and the
    model's kernels carry the mesh. ``pre_embedded``: batch["image"] holds the (B, 1+N,
    width) tokens of ``model.embed_image``, as a window's steps read them
    (``make_train_step_multi(..., pre_embed=True)``)."""

    def step_fn(state: WindowState, backbone, consts, batch):
        nonlocal task_ranges
        if mesh is not None and not local_rows:
            batch = local_batch(batch, mesh)
        task_ranges = _ranges_on(task_ranges, batch["image"].device)
        with profiler.span("step"):
            imgs, pre = ((batch["image"], True) if pre_embedded
                         else _prep_images(model, backbone, batch["image"], normalize))
            logits = model(backbone, state.prompt_params, consts, imgs, tasks=batch.get("task"),
                           task_ranges=task_ranges, pre_embedded=pre, rng=step_rng(model, state))
            with profiler.span("step.loss"):
                loss = soft_cross_entropy(logits, batch["label"])
            values = apply_gradients(state, loss, logits, batch["label"], mesh)
        return state, dict(zip(WINDOW_METRICS, values))

    return step_fn


@dataclasses.dataclass
class WindowState:
    """The train state of both train steps (``make_train_step`` and
    ``make_train_step_multi``), all on the device and updated in place:
    the prompt params (fp32 leaves that require grad), the optimizer state
    (``optim.DeviceOptimizer``), and the seed of VPT dropout's draws, a ()
    int64 tensor that the trainer sets each epoch (``step_rng``). Rebind
    none of its tensors: a captured window reads them where they lie."""

    prompt_params: dict
    opt: DeviceOptimizer
    seed: torch.Tensor

    @property
    def step(self) -> int:
        """The updates made so far (reads the device)."""
        return int(self.opt.count)


def init_train_state(prompt_params: dict, ocfg, steps_per_epoch: int,
                     group=None) -> WindowState:
    """Copy ``prompt_params`` into trainable leaves and build the device
    optimizer over them, from the OPTIM config ``ocfg`` (or a list of
    them, one a parameter group, with ``group`` each leaf's index in it;
    ``optim.build_device_optimizer``); the dropout seed starts at 0."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), prompt_params)
    leaves = tree_leaves(params)
    opt = build_device_optimizer(leaves, ocfg, steps_per_epoch, group)
    return WindowState(params, opt, torch.zeros((), dtype=torch.int64, device=leaves[0].device))


WINDOW_METRICS = ("loss", "acc", "grad_norm")


@dataclasses.dataclass
class _Captured:
    """One captured step and the static tensors it reads and writes."""

    graph: object                # torch.cuda.CUDAGraph
    inputs: dict                 # (capacity, ...) staged batch tensors
    text: torch.Tensor | None    # the window's text features (text-static specs)
    index: torch.Tensor          # (1,) int64: the step's slot in the window
    out: dict                    # WINDOW_METRICS -> (capacity,) fp32
    served: tuple                # _served(...) of what it was captured against
    spans: list                  # the step's spans (utils.profiler.capturing), or empty

    def reads(self, state, backbone, consts) -> bool:
        """Whether it reads and writes these objects."""
        now = _served(state, backbone, consts)
        return len(now) == len(self.served) and all(a is b for a, b in zip(now, self.served))

    def serves(self, state, backbone, consts, k: int) -> bool:
        return k <= self.inputs["label"].shape[0] and self.reads(state, backbone, consts)


def _served(state: WindowState, backbone, consts) -> tuple:
    """The objects a captured step reads or writes in place, which a later
    window must pass again for the graph to serve it: the backbone, the
    consts, and every tensor of the state."""
    return (backbone, consts, *tree_leaves(state.prompt_params), *state.opt.tensors(),
            state.seed)


# Why a windowed step captured its graph (``WindowStep.capture_causes``):
# the first window of its batch shape, another state, backbone or consts,
# a window longer than the graph's static tensors, tracing turned on or off.
CAPTURE_CAUSES = ("shape", "state", "window", "tracing")


class WindowStep:
    """The windowed train step that ``make_train_step_multi`` returns;
    ``captures`` (by cause in ``capture_causes``) and ``replays`` say what
    its CUDA graphs did; ``utils.profiler.spans()`` reports them. A
    replay calls no kernel wrapper, so ``ops._build.LAUNCHES`` does not
    count the kernels it launches: a device trace does, and with tracing
    on (``utils.profiler``) the captured step's spans, whose device
    stamps every replay writes again, in the row of its step."""

    def __init__(self, model: MVLPTModel, task_ranges, pre_embed: bool, normalize, capture: bool,
                 mesh=None):
        self.model, self.task_ranges, self.mesh = model, task_ranges, mesh
        self.pre_embed, self.normalize, self.capture = pre_embed, normalize, capture
        self._graphs: dict = {}
        self.capture_causes = collections.Counter()   # steps captured into a graph, by cause
        self.replays = 0             # graph replays, over every window
        profiler.watch(self)

    @property
    def captures(self) -> int:
        """Steps captured into a graph."""
        return sum(self.capture_causes.values())

    def __call__(self, state: WindowState, backbone, consts, batches):
        device = batches["image"].device
        self.task_ranges = _ranges_on(self.task_ranges, device)
        with profiler.span("window.pre_embed"):
            inputs = self._window_inputs(backbone, batches)
        text = None
        if self.model.spec.text_is_static:
            with torch.no_grad(), profiler.span("window.text_static"):
                text = self.model.compute_text_features(backbone, state.prompt_params, consts)
        k = inputs["image"].shape[0]
        if device.type == "cuda" and self.capture and not profiler.nan_debugging():
            out = self._replayed(state, backbone, consts, inputs, text, k)
        else:
            index = torch.zeros(1, dtype=torch.int64, device=device)
            out = {name: torch.zeros(k, dtype=torch.float32, device=device)
                   for name in WINDOW_METRICS}
            for _ in range(k):
                self._step(state, backbone, consts, inputs, text, index, out)
        return state, out

    def _window_inputs(self, backbone, batches) -> dict:
        """The window's batches as its steps read them: the stem run once
        over all K x B images with ``pre_embed`` (the CLIP normalisation
        folded into it for uint8 images with ``normalize``), else uint8
        images with ``normalize`` normalised to the compute dtype."""
        model, imgs = self.model, batches["image"]
        if self.pre_embed:
            norm = self.normalize if imgs.dtype == torch.uint8 else None
            k, b = imgs.shape[:2]
            with torch.no_grad():
                tokens = model.embed_image(backbone, imgs.reshape(k * b, *imgs.shape[2:]),
                                           normalize=norm)
            imgs = tokens.reshape(k, b, *tokens.shape[1:])
        elif self.normalize is not None and imgs.dtype == torch.uint8:
            mean, std = (device_constant(tuple(map(float, v)), imgs.device)
                         for v in self.normalize)
            imgs = ((imgs.float() / 255.0 - mean) / std).to(model.compute_dtype)
        return dict(batches, image=imgs)

    def _step(self, state, backbone, consts, inputs, text, index, out) -> None:
        """Step ``index`` of the window: its batch picked on the device,
        forward (VPT dropout keyed by the state's seed and update count),
        backward into the prompt params, the device optimizer's update, its
        metrics written to slot ``index`` of ``out``, and ``index``
        advanced. It reads nothing back to the host (but under
        ``profiler.enable_nan_debugging``, which runs the window eagerly)."""
        model, params = self.model, state.prompt_params
        with profiler.span("step"):
            batch = {name: t.index_select(0, index)[0] for name, t in inputs.items()}
            rng = step_rng(model, state)
            if text is not None:
                logits = model.forward_with_text(backbone, params, batch["image"], text,
                                                 tasks=batch.get("task"),
                                                 task_ranges=self.task_ranges,
                                                 pre_embedded=self.pre_embed, rng=rng)
            else:
                logits = model(backbone, params, consts, batch["image"], tasks=batch.get("task"),
                               task_ranges=self.task_ranges, pre_embedded=self.pre_embed,
                               rng=rng)
            with profiler.span("step.loss"):
                loss = soft_cross_entropy(logits, batch["label"])
            values = apply_gradients(state, loss, logits, batch["label"], self.mesh)
            with torch.no_grad():
                for name, v in zip(WINDOW_METRICS, values):
                    out[name].index_copy_(0, index, v.reshape(1))
        with torch.no_grad():
            # After the step's span: a captured step's stamps write row ``index``.
            index.add_(1)

    def _replayed(self, state, backbone, consts, inputs, text, k: int) -> dict:
        """The window through its graph. A graph is kept for each batch
        shape, captured in one tracing state (``utils.profiler.tracing``,
        ``kernel_marks`` and ``core_marks``): turning tracing on captures a
        step with its spans, which no window with tracing off replays, and
        the other way round. The new graph replaces that of the other state:
        each holds a step's activations in a pool of its own (about 19 GB
        at ViT-L/14@336px's shapes, batch 32), which four states would not
        fit on an 80 GB card beside each other."""
        key = (tuple((name, tuple(t.shape[1:]), t.dtype) for name, t in sorted(inputs.items())),
               None if text is None else tuple(text.shape),
               (profiler.tracing(), profiler.kernel_marks(), profiler.core_marks()))
        cap = self._graphs.get(key)
        if cap is not None and cap.serves(state, backbone, consts, k):
            # The samples of the graph's last window, read before it replays again.
            profiler.collect()
            with profiler.span("window.stage"):
                for name, t in inputs.items():
                    cap.inputs[name][:k].copy_(t)
                if text is not None:
                    cap.text.copy_(text)
                cap.index.zero_()
            done = 0
        else:
            if cap is not None:
                cause = "window" if cap.reads(state, backbone, consts) else "state"
            else:
                cause = ("tracing" if any(other[:-1] == key[:-1] for other in self._graphs)
                         else "shape")
            self.capture_causes[cause] += 1
            cap = None
            for other in [o for o in self._graphs if o[:-1] == key[:-1]]:
                del self._graphs[other]
            with profiler.span("window.capture"):
                cap = self._graphs[key] = self._capture(state, backbone, consts, inputs, text)
            done = 1
        with profiler.span("window.replay"):
            for _ in range(k - done):
                cap.graph.replay()
            profiler.replayed(cap.spans, range(done, k))
        self.replays += k - done
        return {name: buf[:k].clone() for name, buf in cap.out.items()}

    def _capture(self, state, backbone, consts, inputs, text) -> _Captured:
        """Stage the window in new static tensors, run its first step
        eagerly on a side stream (the warm-up: the kernel libraries load,
        set their shared-memory attributes and encode their tensor maps,
        and cuBLAS makes its workspace), then capture one step. The
        capture runs nothing, so the window's first step is done."""
        device = inputs["image"].device
        static = {name: t.clone() for name, t in inputs.items()}
        static_text = None if text is None else text.clone()
        index = torch.zeros(1, dtype=torch.int64, device=device)
        out = {name: torch.zeros(static["image"].shape[0], dtype=torch.float32, device=device)
               for name in WINDOW_METRICS}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._step(state, backbone, consts, static, static_text, index, out)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with (profiler.capturing(index, static["image"].shape[0]) as spans,
                  torch.cuda.graph(graph)):
                self._step(state, backbone, consts, static, static_text, index, out)
        except RuntimeError as e:
            raise RuntimeError("make_train_step_multi: capturing the train step as a CUDA graph "
                               f"failed ({e}); run it with capture=False to run the window "
                               "eagerly") from e
        return _Captured(graph, static, static_text, index, out,
                         _served(state, backbone, consts), spans)


def make_train_step_multi(model: MVLPTModel, task_ranges: TaskClassRanges | None = None,
                          pre_embed: bool = False, normalize: tuple | None = None,
                          mesh=None, capture: bool = True) -> WindowStep:
    """The windowed train step: step(state, backbone, consts, batches) ->
    (state, metrics), the counterpart of ``make_train_step_multi`` in
    ``mvlpt_tpu/train/train_step.py``. Every array of ``batches`` carries a
    leading window axis K ("image" (K, B, H, W, 3), "label" (K, B) or
    (K, B, C), optionally "task" (K, B)); the metrics ``loss``, ``acc`` and
    ``grad_norm`` come back as (K,) fp32 tensors on the device. ``state``
    is a ``WindowState`` (``init_train_state``), updated in place; its
    optimizer reads the lr from the per-epoch table by its update count on
    the device, so a window may cross an epoch boundary.

    ``pre_embed``: the frozen stem runs once over all K x B images before
    the steps; with uint8 images and ``normalize=(mean, std)`` the CLIP
    normalisation is folded into it. Without ``pre_embed``, uint8 images
    with ``normalize`` are normalised on the device to the compute dtype
    before the steps. When ``model.spec.text_is_static`` (pure VPT) the
    text features are computed once a window and every step runs
    ``forward_with_text``: exact, since the text tower reads no trained
    parameter. The JAX package also hoists its weight preparation out of
    the window (``prepare_backbone``); the port has no such work, since
    ``core.layers.layer_params`` takes each layer's weights as views. VPT
    dropout's key is a function of the state's seed and update count
    (``step_rng``), so a step draws the same mask in a window, in its
    graph's replay and one step a call; the JAX package folds a step
    index into the window's key instead.

    On the card (``capture=True``) the steps run from a CUDA graph of one
    step. The design replays that one graph K times, its batch picked by
    a step index that lives on the device, rather than capturing one
    graph a window length, as ``jax.jit`` compiles one scan a K: one
    capture serves every window length up to the first window's (the
    trainer's tail windows included), costs one step's capture and
    one step's graph memory rather than K's, and the K replays cost the
    host a few microseconds each where the eager step costs it tens of
    milliseconds. The first window of a batch shape (or of another
    state, backbone or consts, or of a longer window) stages its batches
    in the graph's static tensors, runs its first step eagerly on a side
    stream as the warm-up, captures one step and replays it K - 1 times;
    every later window copies its batches into the static tensors and
    replays K times. A capture that fails raises: there is no fallback
    to eager steps on the card. ``capture=False`` runs the window's
    steps eagerly on the card, the same program without the graph.
    On the CPU the steps always run eagerly, and so do they under
    ``utils.profiler.enable_nan_debugging`` (``--debug-nans``), whose
    checks read the device every step, which a graph cannot capture.

    Under a ``mesh`` (``parallel.Mesh``) the window's axis 1 holds this
    data rank's rows of each global batch (the counterpart of the JAX
    package's (None, "data") window sharding), each step takes the mean
    of the gradients, the loss and the accuracy over the data group, and
    the model group reduces inside the blocks. The steps run eagerly:
    ``capture=False`` is required there, and ``capture=True`` raises
    NotImplementedError. One card takes two ranks over gloo only, whose
    all-reduces go through host memory, which a graph cannot capture; a
    captured window under NCCL waits for a machine with two or more cards
    (ROADMAP.md Queue 1, item 8b)."""
    if mesh is not None and capture:
        raise NotImplementedError("make_train_step_multi under a mesh runs eagerly only "
                                  "(capture=False): a captured window under NCCL waits for "
                                  "two or more cards (ROADMAP.md Queue 1, item 8b)")
    return WindowStep(model, task_ranges, pre_embed, normalize, capture, mesh)


def _inference_model(model: MVLPTModel) -> MVLPTModel:
    """A new model whose fused half-block kernels run their no-grad
    forwards (the JAX package's attn_block_infer / mlp_block_infer): the
    same values, no backward residuals written. ``model`` itself is left
    as it is. The standalone attention ('on') and the plain path ('off')
    have no such variant: ``model`` comes back unchanged. The kernels'
    mesh carries over."""
    if not isinstance(model.kernels, BlockKernels) or model.kernels.inference:
        return model
    return MVLPTModel(model.clip_cfg, model.spec,
                      kernels=dataclasses.replace(model.kernels, inference=True),
                      compute_dtype=model.compute_dtype)


def _over_data(eval_fn: Callable, mesh) -> Callable:
    """``eval_fn`` over a mesh's data axis (``parallel.over_data_rows``):
    each data rank runs its rows of the batch, and every rank gets the
    whole batch's logits. Without a data axis, ``eval_fn`` itself."""
    if mesh is None or mesh.n_data == 1:
        return eval_fn

    @torch.no_grad()
    def run(backbone, prompt_params, aux, batch):
        return over_data_rows(lambda rows: eval_fn(backbone, prompt_params, aux, rows), batch,
                              mesh)

    return run


def make_eval_step(model: MVLPTModel, task_ranges: TaskClassRanges | None = None,
                   normalize: tuple | None = None, mesh=None) -> Callable:
    """eval_step(backbone, prompt_params, consts, batch) -> fp32 logits,
    both towers each call, no gradient. Under a ``mesh`` with a data axis
    each data rank runs its rows and every rank gets the whole batch's
    logits (``_over_data``)."""
    model = _inference_model(model)

    @torch.no_grad()
    def eval_fn(backbone, prompt_params, consts, batch):
        nonlocal task_ranges
        task_ranges = _ranges_on(task_ranges, batch["image"].device)
        with profiler.span("eval.batch"):
            imgs, pre = _prep_images(model, backbone, batch["image"], normalize)
            return model(backbone, prompt_params, consts, imgs, tasks=batch.get("task"),
                         task_ranges=task_ranges, pre_embedded=pre)

    return _over_data(eval_fn, mesh)


def make_cached_text_eval(model: MVLPTModel, task_ranges: TaskClassRanges | None = None,
                          normalize: tuple | None = None, mesh=None):
    """(text_fn, eval_fn) for the cached-text eval fast path: the prompts
    are frozen at eval, so ``text_fn(backbone, prompt_params, consts)``
    computes the text features once and ``eval_fn(backbone,
    prompt_params, text_features, batch)`` runs the image tower and the
    logits per batch, with the same values as :func:`make_eval_step`.
    CoCoOp's text features depend on the image: it returns (None, None),
    and callers run :func:`make_eval_step`. Under a ``mesh`` with a data
    axis every data rank computes the text features whole, runs its rows
    of each batch, and gets the whole batch's logits (``_over_data``)."""
    if model.spec.has_cocoop:
        return None, None
    model = _inference_model(model)

    @torch.no_grad()
    def text_fn(backbone, prompt_params, consts):
        return model.compute_text_features(backbone, prompt_params, consts)

    @torch.no_grad()
    def eval_fn(backbone, prompt_params, text_features, batch):
        nonlocal task_ranges
        task_ranges = _ranges_on(task_ranges, batch["image"].device)
        with profiler.span("eval.batch"):
            imgs, pre = _prep_images(model, backbone, batch["image"], normalize)
            return model.forward_with_text(backbone, prompt_params, imgs, text_features,
                                           tasks=batch.get("task"), task_ranges=task_ranges,
                                           pre_embedded=pre)

    return text_fn, _over_data(eval_fn, mesh)
