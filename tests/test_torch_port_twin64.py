"""The plain twins' ``acc`` keyword and the bf16 rule of chip_smoke.py.

Every plain twin (ops/block.py, ops/attention.py) takes ``acc``, the
dtype of its sums. With the default it must return exactly the tensors
it returned before it took the keyword (tests/torch_port_twins_fp32.py
keeps those twins verbatim), in bf16 and fp32: the twin each kernel is
held to does not move. ``acc=torch.float64`` is the fp64-summed twin;
on fp32 inputs it stays within 1e-5 x max|ref| of the fp32 twin.
chip_smoke.verdict holds a bf16 row to max|out - ref64| <= max(2 x
max|ref - ref64|, 5e-3 x max|ref64|), and an fp32 row to 1e-4 x max|ref|
as before."""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_port_twins_fp32 as frozen
from tests.torch_port_util import block_params_np

from mvlpt_torch.core import layers
from mvlpt_torch.ops import attention, block

ROOT = Path(__file__).resolve().parent.parent
B, S, W, H = 2, 9, 32, 4
D = W // H

_NEW = types.SimpleNamespace(
    **{n: getattr(block, n) for n in (
        "attn_fwd_plain", "attn_fwd_part_plain", "attn_bwd_plain", "attn_bwd_part_plain",
        "mlp_fwd_plain", "mlp_fwd_part_plain", "mlp_bwd_plain", "mlp_bwd_part_plain",
        "_ln_bwd")},
    attend_fwd_plain=attention.attend_fwd_plain, attend_bwd_plain=attention.attend_bwd_plain)


def _calls(dtype, mask):
    """Each twin, called on one set of seeded inputs in ``dtype`` through
    a module of twins (the port's, or the frozen copies), with keyword
    arguments passed on: name -> fn(twins, **kw)."""
    rng = np.random.RandomState(21)
    p = {g: {k: torch.from_numpy(a).to(dtype) for k, a in d.items()}
         for g, d in block_params_np(rng, W).items()}
    x = torch.from_numpy(rng.randn(B, S, W).astype(np.float32)).to(dtype)
    gy = torch.from_numpy(rng.randn(B, S, W).astype(np.float32)).to(dtype)
    dxh = torch.from_numpy(rng.randn(B, S, W).astype(np.float32))
    ln1, at, ln2, ml = p["ln_1"], p["attn"], p["ln_2"], p["mlp"]
    attn = (x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"], at["out_b"],
            mask, H)
    mlp = (x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"], ml["proj_b"])
    _, (qkv, probs, mu, rstd) = frozen.attn_fwd_plain(*attn)
    _, (hpre, mu2, rstd2) = frozen.mlp_fwd_plain(*mlp)
    q, k, v = (t.reshape(B * H, S, D).contiguous()
               for t in qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4))
    do = gy.view(B, S, H, D).transpose(1, 2).reshape(B * H, S, D)
    return {
        "attn_fwd": lambda m, **kw: m.attn_fwd_plain(*attn, **kw),
        "attn_fwd_no_residual": lambda m, **kw: m.attn_fwd_plain(*attn, save_residuals=False,
                                                                 **kw),
        "attn_fwd_part": lambda m, **kw: m.attn_fwd_part_plain(*attn[:6], mask, H, **kw),
        "attn_bwd": lambda m, **kw: m.attn_bwd_plain(x, mu, rstd, qkv, probs, ln1["scale"],
                                                     at["qkv_w"], at["out_w"], gy, H, **kw),
        "attn_bwd_part": lambda m, **kw: m.attn_bwd_part_plain(qkv, probs, at["qkv_w"],
                                                               at["out_w"], gy, H, **kw),
        "mlp_fwd": lambda m, **kw: m.mlp_fwd_plain(*mlp, **kw),
        "mlp_fwd_no_residual": lambda m, **kw: m.mlp_fwd_plain(*mlp, save_residuals=False,
                                                               **kw),
        "mlp_fwd_part": lambda m, **kw: m.mlp_fwd_part_plain(*mlp[:6], **kw),
        "mlp_bwd": lambda m, **kw: m.mlp_bwd_plain(x, mu2, rstd2, hpre, ln2["scale"],
                                                   ml["fc_w"], ml["proj_w"], gy, **kw),
        "mlp_bwd_part": lambda m, **kw: m.mlp_bwd_part_plain(hpre, ml["fc_w"], ml["proj_w"], gy,
                                                             **kw),
        "ln_bwd": lambda m, **kw: m._ln_bwd(x, mu, rstd, ln1["scale"], dxh, gy, **kw),
        "attend_fwd": lambda m, **kw: m.attend_fwd_plain(q, k, v, mask, **kw),
        "attend_bwd": lambda m, **kw: m.attend_bwd_plain(q, k, v, mask, do, **kw),
    }


NAMES = list(_calls(torch.float32, None))


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [] if out is None else [out]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("name", NAMES)
def test_default_twin_is_bit_for_bit_the_fp32_twin(name, dtype):
    """With the default ``acc`` each twin returns exactly what it returned
    before it took the keyword, with and without a mask."""
    for mask in (None, layers.causal_mask(S)):
        calls = _calls(dtype, mask)
        got, want = _leaves(calls[name](_NEW)), _leaves(calls[name](frozen))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), name
        explicit = _leaves(calls[name](_NEW, acc=torch.float32))
        assert all(torch.equal(g, e) for g, e in zip(got, explicit))


@pytest.mark.parametrize("name", NAMES)
def test_fp64_summed_twin_stays_near_the_fp32_twin(name):
    """On fp32 inputs the fp64-summed twin (acc=torch.float64) sits within
    1e-5 x max|ref| of the fp32 twin, output by output; its outputs in the
    compute dtype keep that dtype."""
    calls = _calls(torch.float32, layers.causal_mask(S))
    ref = _leaves(calls[name](_NEW))
    ref64 = _leaves(calls[name](_NEW, acc=torch.float64))
    assert len(ref) == len(ref64)
    for r, r64 in zip(ref, ref64):
        assert r64.dtype in (torch.float32, torch.float64)
        scale = r.double().abs().max().item()
        assert (r.double() - r64.double()).abs().max().item() <= 1e-5 * scale, name


def test_fp64_summed_twin_keeps_the_bf16_rounding_points():
    """In bf16 the fp64-summed twin rounds where the twin does: its bf16
    outputs are bf16 tensors, and each differs from the fp32 twin's by
    rounding alone (at most one bf16 ulp of the largest output)."""
    calls = _calls(torch.bfloat16, None)
    for name in ("attn_fwd", "mlp_fwd", "mlp_bwd", "attend_fwd"):
        ref = _leaves(calls[name](_NEW))[0]
        ref64 = _leaves(calls[name](_NEW, acc=torch.float64))[0]
        assert ref64.dtype == torch.bfloat16
        top = ref.float().abs().max().item()
        assert (ref.float() - ref64.float()).abs().max().item() <= 2.0 ** (np.floor(np.log2(top))
                                                                           - 7), name


# ----------------------------------------------------- the bf16 rule

def _smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _bf(*v):
    return torch.tensor(v, dtype=torch.bfloat16)


# max|ref64| 5.46875 sits in [4, 8), where one bf16 ulp (0.03125) is above
# the old floor 5e-3 x 5.46875 = 0.02734; in [2, 4) one ulp is 0.015625.
REF64 = (5.46875, 2.5, -1.0, 3.0)
ULP = 0.03125


@pytest.mark.parametrize("out, ref, ok, ok_old", [
    (REF64, REF64, True, True),                                       # equal to ref64
    ((5.5, 2.5, -1.0, 3.0), (5.46875, 2.515625, -1.0, 3.0), True, False),  # 1 ulp; twin 1/2
    ((5.5, 2.5, -1.0, 3.0), REF64, False, False),                     # 1 ulp; twin exact
    ((5.5625, 2.5, -1.0, 3.0), (5.46875, 2.515625, -1.0, 3.0), False, False),  # 3 ulps
    ((5.5625, 2.5, -1.0, 3.0), (5.5, 2.5, -1.0, 3.0), False, False),  # 3 ulps; twin 1 ulp
], ids=["equal", "one-ulp-twin-half-ulp", "one-ulp-twin-exact", "three-ulps",
        "three-ulps-twin-one-ulp"])
def test_bf16_rule(out, ref, ok, ok_old):
    """max|out - ref64| <= max(2 max|ref - ref64|, 5e-3 max|ref64|): a
    one-ulp flip of the top binade passes where the twin sits half an ulp
    from exact sums there, and fails where the twin is exact and the
    floor is below one ulp; three ulps fail. ok_old is the old bound
    against ref, printed beside it."""
    chip_smoke = _smoke()
    row = chip_smoke.verdict("bfloat16", _bf(*out), _bf(*ref), _bf(*REF64))
    twin = max(abs(a - b) for a, b in zip(ref, REF64))
    err64 = max(abs(a - b) for a, b in zip(out, REF64))
    assert row["twin_err64"] == twin and row["max_abs_err64"] == err64
    assert row["tol"] == max(2 * twin, 5e-3 * 5.46875)
    assert row["tol_old"] == 5e-3 * max(abs(v) for v in ref)
    assert (row["ok"], row["ok_old"]) == (ok, ok_old)
    assert row["differ_share"] == np.mean([a != b for a, b in zip(out, ref)])
    assert row["differ_share64"] == np.mean([a != b for a, b in zip(out, REF64)])


def test_rule_over_several_outputs_and_in_fp32():
    """A row of several outputs passes only if each does and reports the
    one furthest past its bound; fp32 rows keep 1e-4 x max|ref| against
    ref, and a non-finite output fails."""
    chip_smoke = _smoke()
    good, bad = (_bf(*REF64),) * 3, (_bf(5.5, 2.5, -1.0, 3.0), _bf(*REF64), _bf(*REF64))
    row = chip_smoke.verdict("bfloat16", (good[0], bad[0]), good[:2], good[:2])
    assert not row["ok"] and row["max_abs_err64"] == ULP
    assert chip_smoke.verdict("bfloat16", good, good, good)["ok"]
    ref = torch.tensor([1.0, -2.0, 0.5])
    row = chip_smoke.verdict("float32", ref + torch.tensor([0.0, 1.5e-4, 0.0]), ref)
    assert row["ok"] and row["tol"] == 1e-4 * 2.0 and "ok_old" not in row
    assert not chip_smoke.verdict("float32", ref + torch.tensor([0.0, 2.5e-4, 0.0]), ref)["ok"]
    assert not chip_smoke.verdict("float32", ref + float("nan"), ref)["ok"]
    assert not chip_smoke.verdict("bfloat16", _bf(float("nan"), 0, 0, 0), _bf(*REF64),
                                  _bf(*REF64))["ok"]


def test_rule_names_each_output_and_compares_beside_it():
    """With the outputs' names a row reports each one's error, tol and
    verdict and which output it takes its numbers from; _compared gives
    another reference's numbers to print and decides nothing."""
    chip_smoke = _smoke()
    good, off = _bf(*REF64), _bf(5.5, 2.5, -1.0, 3.0)
    row = chip_smoke.verdict("bfloat16", (good, off), (good, good), (good, good),
                             ("y", "probs"))
    assert not row["ok"] and row["worst_output"] == "probs"
    assert row["by_output"]["y"]["ok"] and not row["by_output"]["probs"]["ok"]
    assert row["by_output"]["probs"]["max_abs_err64"] == ULP
    assert "by_output" not in chip_smoke.verdict("bfloat16", good, good, good)
    beside = chip_smoke._compared("bfloat16", off, good, good)
    assert beside == {k: row[k] for k in beside} and not beside["ok"]
