"""Prompt-only checkpoints: save, find, load, resume and average.

The counterpart of ``mvlpt_tpu/checkpoint/prompt_io.py``, with the same
files, so that either package loads what the other wrote:
  * ``<dir>/prompt_learner/model.pth.tar-<epoch>`` and
    ``model-best.pth.tar``, each a pickle of a dict of numpy arrays (not a
    torch archive) with the keys ``state_dict``, ``epoch`` and
    ``val_result``;
  * on load, legacy ``upt_proj`` keys are renamed to ``mvlpt_proj`` and
    the frozen ``token_prefix``/``token_suffix`` buffers dropped, so the
    class-dependent embeddings are rebuilt for the new task; loading is
    non-strict;
  * checkpoints of several seeds average tensor by tensor.

State dicts are flat {dotted.path: np.ndarray} views of the prompt tree.
``load_prompt_checkpoint`` also reads the reference trainer's own
``torch.save`` archives (zip or legacy pickle), mapping its learner's key
names and torch Linear (out, in) layouts into the prompt tree's;
``export_reference_checkpoint`` writes the inverse.
"""

from __future__ import annotations

import os
import pickle
import re
import zipfile

import numpy as np
import torch

from mvlpt_torch.checkpoint.convert import _np as _tensor_to_np
from mvlpt_torch.checkpoint.convert import _stack_openai_blocks

MODEL_BEST = "model-best.pth.tar"


def _leaves(tree, prefix="") -> dict:
    """A nested dict's leaves as they are, by dotted path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def flatten_params(tree, prefix="") -> dict[str, np.ndarray]:
    """A prompt tree (torch or numpy leaves) -> {dotted.path: np.ndarray}."""
    return {k: _tensor_to_np(v) for k, v in _leaves(tree, prefix).items()}


def unflatten_params(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def checkpoint_path(directory: str, epoch: int | None = None,
                    name: str = "prompt_learner") -> str:
    fname = MODEL_BEST if epoch is None else f"model.pth.tar-{epoch}"
    return os.path.join(directory, name, fname)


def find_checkpoint(directory: str, epoch: int | None = None,
                    name: str = "prompt_learner") -> str:
    """``checkpoint_path``, but with no epoch asked for and no
    model-best.pth.tar (a run that keeps its last step writes none), the
    highest-numbered model.pth.tar-N of the run."""
    path = checkpoint_path(directory, epoch, name)
    if epoch is not None or os.path.exists(path):
        return path
    epochs = list_epoch_checkpoints(directory, name)
    if not epochs:
        return path  # the caller raises FileNotFoundError with this path
    return checkpoint_path(directory, epochs[-1], name)


def list_epoch_checkpoints(directory: str, name: str = "prompt_learner") -> list[int]:
    """Sorted epoch numbers of the model.pth.tar-N files under
    <directory>/<name>/, matched exactly (stray .bak or .tmp copies are
    not epochs)."""
    pdir = os.path.join(directory, name)
    epochs = []
    if os.path.isdir(pdir):
        for f in os.listdir(pdir):
            m = re.fullmatch(r"model\.pth\.tar-(\d+)", f)
            if m:
                epochs.append(int(m.group(1)))
    return sorted(epochs)


def save_prompt_checkpoint(path: str, prompt_params, epoch: int,
                           val_result: float | None = None, extra: dict | None = None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "state_dict": flatten_params(prompt_params),
        "epoch": int(epoch),
        "val_result": None if val_result is None else float(val_result),
    }
    if extra:
        payload.update(extra)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


# --- the reference trainer's torch archives ---------------------------------

# Direct renames: the reference learner's attribute -> the dotted key.
_REF_DIRECT = {
    "ctx": "coop.ctx",
    "vpt_embeddings": "vpt.embeddings",
    "vpt_embeddings_deep": "vpt.embeddings_deep",
    "cocoop_ctx": "cocoop.ctx",
}

# Stacked coupler-transformer leaves -> torch resblock key names; the
# bool marks Linear kernels, which transpose back to torch's (out, in).
# The leaf names are core/clip.py's init_block_stack's.
_REF_RESBLOCK_LEAVES = {
    ("ln_1", "scale"): ("ln_1.weight", False),
    ("ln_1", "bias"): ("ln_1.bias", False),
    ("attn", "qkv_w"): ("attn.in_proj_weight", True),
    ("attn", "qkv_b"): ("attn.in_proj_bias", False),
    ("attn", "out_w"): ("attn.out_proj.weight", True),
    ("attn", "out_b"): ("attn.out_proj.bias", False),
    ("ln_2", "scale"): ("ln_2.weight", False),
    ("ln_2", "bias"): ("ln_2.bias", False),
    ("mlp", "fc_w"): ("mlp.c_fc.weight", True),
    ("mlp", "fc_b"): ("mlp.c_fc.bias", False),
    ("mlp", "proj_w"): ("mlp.c_proj.weight", True),
    ("mlp", "proj_b"): ("mlp.c_proj.bias", False),
}

# torch nn.Linear modules: weight (out, in); the prompt tree's kernel (in, out).
_REF_LINEAR = {
    "vpt_proj": "vpt.proj",
    "mvlpt_proj_ctx_coop_pre": "mvlpt_proj.coop_pre",
    "mvlpt_proj_ctx_coop_post": "mvlpt_proj.coop_post",
    "mvlpt_proj_ctx_vpt_pre": "mvlpt_proj.vpt_pre",
    "mvlpt_proj_ctx_vpt_post": "mvlpt_proj.vpt_post",
    "meta_net.linear1": "cocoop.meta_net.linear1",
    "meta_net.linear2": "cocoop.meta_net.linear2",
}


def is_reference_state_dict(sd: dict) -> bool:
    """True if the flat keys use the reference learner's torch names."""
    for k in sd:
        if k in _REF_DIRECT or k.startswith("mvlpt_proj.resblocks."):
            return True
        if any(k == f"{m}.weight" or k == f"{m}.bias" for m in _REF_LINEAR):
            return True
    return False


def map_reference_state_dict(sd: dict) -> dict[str, np.ndarray]:
    """The reference prompt learner's state_dict -> flat dotted numpy keys:
    Linear kernels transposed, the coupler's resblocks stacked on a
    leading layer axis, ``token_prefix``/``token_suffix`` dropped, and
    unknown keys passed through for ``apply_state_dict`` to skip."""
    sd = {k: _tensor_to_np(v) for k, v in sd.items()}
    out: dict[str, np.ndarray] = {}
    n_blocks = 0
    for k, v in sd.items():
        if "token_prefix" in k or "token_suffix" in k:
            continue
        if k in _REF_DIRECT:
            out[_REF_DIRECT[k]] = v
            continue
        mod, _, leaf = k.rpartition(".")
        if mod in _REF_LINEAR and leaf in ("weight", "bias"):
            if leaf == "weight":
                out[f"{_REF_LINEAR[mod]}.kernel"] = v.T
            else:
                out[f"{_REF_LINEAR[mod]}.bias"] = v
            continue
        if k.startswith("mvlpt_proj.resblocks."):
            n_blocks = max(n_blocks, int(k.split(".")[2]) + 1)
            continue  # stacked below
        out[k] = v
    if n_blocks:
        stacked = _stack_openai_blocks(sd, "mvlpt_proj", n_blocks)
        out.update(flatten_params(stacked, "mvlpt_proj.transformer."))
    return out


def to_reference_state_dict(flat: dict) -> dict[str, np.ndarray]:
    """Flat dotted keys -> the reference learner's torch names, the exact
    inverse of :func:`map_reference_state_dict`: Linear kernels back to
    (out, in), the stacked coupler unstacked into
    ``mvlpt_proj.resblocks.{i}.*``; no ``token_prefix``/``token_suffix``
    (the reference drops them on load and loads non-strictly). Unknown
    keys pass through."""
    inv_direct = {v: k for k, v in _REF_DIRECT.items()}
    inv_linear = {v: k for k, v in _REF_LINEAR.items()}
    out: dict[str, np.ndarray] = {}
    for k, v in flat.items():
        v = _tensor_to_np(v)
        if k in inv_direct:
            out[inv_direct[k]] = v
            continue
        mod, _, leaf = k.rpartition(".")
        if mod in inv_linear and leaf in ("kernel", "bias"):
            if leaf == "kernel":
                out[f"{inv_linear[mod]}.weight"] = np.ascontiguousarray(v.T)
            else:
                out[f"{inv_linear[mod]}.bias"] = v
            continue
        if k.startswith("mvlpt_proj.transformer."):
            grp, leaf = k.split(".")[2], k.split(".")[3]
            ref_leaf, transpose = _REF_RESBLOCK_LEAVES[(grp, leaf)]
            for i in range(v.shape[0]):
                vi = v[i].T if transpose else v[i]
                out[f"mvlpt_proj.resblocks.{i}.{ref_leaf}"] = np.ascontiguousarray(vi)
            continue
        out[k] = v
    return out


def export_reference_checkpoint(path: str, prompt_params, epoch: int = 0,
                                val_result: float | None = None):
    """``torch.save`` a prompt tree (or a flat state_dict) as the reference
    trainer's own checkpoint: its payload (state_dict, epoch, val_result)
    under its learner's key names, for its warm starts and averaging."""
    # A flat state_dict has no dict values; a prompt tree is nested.
    if any(isinstance(v, dict) for v in prompt_params.values()):
        flat = flatten_params(prompt_params)
    else:
        flat = dict(prompt_params)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in to_reference_state_dict(flat).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": sd, "epoch": int(epoch),
                "val_result": None if val_result is None else float(val_result)}, path)


def _read_torch_payload(path: str) -> dict:
    """Read a ``torch.save`` archive: the reference's payload dict or a bare
    state_dict. As in the JAX package, the archive is unpickled whole
    (``weights_only=False``): a Dassl payload carries more than tensors."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        sd, epoch = obj["state_dict"], int(obj.get("epoch") or 0)
        val = obj.get("val_result")
    else:
        sd, epoch, val = obj, 0, None
    return {
        "state_dict": {k: _tensor_to_np(v) for k, v in sd.items()},
        "epoch": epoch,
        "val_result": None if val is None else float(val),
    }


# The first pickle frame of a legacy (pre-zip) torch.save archive
# (torch/serialization.py MAGIC_NUMBER).
_TORCH_LEGACY_MAGIC = 0x1950A86A20F9469CFC6C


class ForeignState(tuple):
    """What a JAX-written payload's optimizer state (``opt_state``: optax's
    NamedTuples, the JAX package's own states) unpickles to here, where
    neither package is imported: each state a plain tuple of its fields."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class _PayloadUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("optax", "mvlpt_tpu", "jax", "jaxlib"):
            return ForeignState
        return super().find_class(module, name)


def _read_payload(path: str) -> dict:
    """This package's (or the JAX package's) numpy pickle, or a torch archive."""
    if zipfile.is_zipfile(path):
        return _read_torch_payload(path)
    with open(path, "rb") as f:
        payload = _PayloadUnpickler(f).load()  # a corrupt file raises its own error
    if isinstance(payload, dict) and "state_dict" in payload:
        return payload
    if isinstance(payload, int) and payload == _TORCH_LEGACY_MAGIC:
        return _read_torch_payload(path)
    raise ValueError(
        f"{path!r} unpickles to {type(payload).__name__}, which is neither a prompt "
        "checkpoint payload (a dict with 'state_dict') nor a torch archive (zip or "
        "legacy-magic pickle): the file is not a prompt checkpoint")


def load_prompt_checkpoint(path: str) -> dict:
    payload = _read_payload(path)
    sd = {k.replace("upt_proj", "mvlpt_proj"): v for k, v in payload["state_dict"].items()}
    if is_reference_state_dict(sd):
        sd = map_reference_state_dict(sd)
    for drop in list(sd):
        if "token_prefix" in drop or "token_suffix" in drop:
            del sd[drop]
    payload["state_dict"] = sd
    return payload


def apply_state_dict(prompt_params: dict, state_dict: dict, strict: bool = False):
    """Merge a flat state_dict into a prompt tree -> (tree, loaded,
    skipped). Non-strict by default: unknown keys and shape mismatches are
    skipped, missing keys keep their values. The new tree's leaves are
    tensors of each old leaf's dtype on its device."""
    current = _leaves(prompt_params)
    merged = {k: _tensor_to_np(v) for k, v in current.items()}
    loaded, skipped = 0, []
    for k, v in state_dict.items():
        if k in merged:
            if merged[k].shape != np.asarray(v).shape:
                if strict:
                    raise ValueError(f"shape mismatch for {k}")
                skipped.append(k)
                continue
            merged[k] = np.asarray(v, merged[k].dtype)
            loaded += 1
        elif strict:
            raise KeyError(f"unexpected key {k}")
        else:
            skipped.append(k)
    tree = unflatten_params({
        k: torch.from_numpy(np.array(v)).to(device=current[k].device, dtype=current[k].dtype)
        for k, v in merged.items()})
    return tree, loaded, skipped


def average_checkpoints(paths: list[str]) -> dict:
    """The tensor-wise mean of several seeds' checkpoints (summed in fp64)."""
    payloads = [load_prompt_checkpoint(p) for p in paths]
    keys = set(payloads[0]["state_dict"])
    for p in payloads[1:]:
        keys &= set(p["state_dict"])
    avg = {
        k: np.mean([p["state_dict"][k].astype(np.float64) for p in payloads],
                   axis=0).astype(payloads[0]["state_dict"][k].dtype)
        for k in sorted(keys)
    }
    vals = [p["val_result"] for p in payloads if p.get("val_result") is not None]
    return {"state_dict": avg, "epoch": payloads[0]["epoch"],
            "val_result": float(np.mean(vals)) if vals else None}
