"""The attention half-block forwards' plain twins, which the card's
kernels (#1, #5, #7) are held to, against the JAX package's Pallas bodies
in interpret mode: in bf16 at the card's TOL (5e-3 x max|ref|), and the
tensor-parallel part also in fp32 at the block tolerance. CLIP's head
width (D = 64) at a ragged length (S = 17) and at the ViT-L/14@336px
image tower's length with 4 VPT rows (S = 581), with and without a
causal mask. Also ``select_attn_fn``'s reading of ``TPU.USE_PALLAS``
against the reference's, value by value; the bf16 route's checks
(``ATTN_FWD_ROUTES``, ``_check_attn_route``) and its core's route by S
(``RESIDENT_KEYS``, counted in ``LAUNCHES``); and, at D = 64, the
identities the bf16 cores rely on: the half-block twin's scores T(q D^-1/2)
k^T + mask equal the standalone convention's fl(q k^T D^-1/2) + mask bit
for bit, and the one-pass core's softmax (exact row max, one exponential
a score, an fp32 sum, the IEEE divide, one rounding) gives the twin's
probabilities within one bf16 ulp."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mvlpt_tpu.core import layers as jlayers
from mvlpt_tpu.ops import attention as jattention
from mvlpt_tpu.ops import block as jblock
from tests.torch_port_util import block_params_np

from mvlpt_torch.core import layers, text
from mvlpt_torch.ops import attention, block
from mvlpt_torch.parallel import shard_blocks

W, H = 128, 2  # two heads of CLIP's 64
S_VITL336 = 1 + 24 * 24 + 4  # ViT-L/14@336px: CLS, 24 x 24 patches, 4 VPT rows


def _close(got, want, name, dtype=torch.bfloat16):
    """bf16: 5e-3 x max|ref|, the card's TOL (the products sum in another
    order, so an output on a rounding boundary moves by one bf16 ulp);
    fp32: 2e-6, the block tolerance."""
    want = np.asarray(want, np.float32)
    atol = 5e-3 * np.abs(want).max() if dtype == torch.bfloat16 else 2e-6
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, err_msg=name)


def _inputs(seed, b, s, kind, dtype=torch.bfloat16):
    """(jax x, jax params, jax mask, torch x, torch params, torch mask)."""
    rng = np.random.RandomState(seed)
    p_np = block_params_np(rng, W)
    x_np = rng.randn(b, s, W).astype(np.float32)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), p_np)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(dtype), p_np)
    jm, tm = (None, None) if kind == "none" else (jlayers.causal_mask(s), layers.causal_mask(s))
    return jnp.asarray(x_np, jd), jp, jm, torch.from_numpy(x_np).to(dtype), tp, tm


def _twin_args(tp, tm):
    ln, at = tp["ln_1"], tp["attn"]
    return (ln["scale"], ln["bias"], at["qkv_w"], at["qkv_b"], at["out_w"], at["out_b"], tm, H)


@pytest.mark.parametrize("b,s,kind", [(3, 17, "none"), (3, 17, "causal"),
                                      (1, S_VITL336, "none"), (1, S_VITL336, "causal")])
def test_attn_fwd_twin_matches_pallas_in_bf16(b, s, kind):
    """attn_fwd_plain in bf16 against _attn_fwd (y and the residuals qkv,
    probs, mu, rstd) and, without residuals, against attn_block_infer."""
    jx, jp, jm, tx, tp, tm = _inputs(s, b, s, kind)
    jy, (_, _, _, jqkvt, jprobs, jmu, jrstd) = jblock._attn_fwd(jx, jp["ln_1"], jp["attn"], jm,
                                                               H, 1e-5)
    y, (qkv, probs, mu, rstd) = block.attn_fwd_plain(tx, *_twin_args(tp, tm))
    assert y.dtype == qkv.dtype == probs.dtype == torch.bfloat16
    _close(y, jy, "y")
    _close(qkv, np.asarray(jqkvt, np.float32).transpose(0, 2, 1), "qkv")
    _close(probs, jprobs, "probs")
    # The LayerNorm statistics are fp32 of the same bf16 x.
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu)[..., 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[..., 0], rtol=1e-5)
    jyi = jblock.attn_block_infer(jx, jp["ln_1"], jp["attn"], jm, H)
    yi, res = block.attn_fwd_plain(tx, *_twin_args(tp, tm), save_residuals=False)
    assert res is None
    _close(yi, jyi, "y (no residuals)")


def _jax_attn_part(x, ln_p, w3_l, b3_l, wout_l, mask, h_loc):
    """The JAX package's part kernel (_attn_fwd_kernel, part=True) as
    _attn_tp_fwd calls it on one model rank's shard, one image a program:
    -> (fp32 partial, qkv^T, probs, mu, rstd)."""
    b, s, w = x.shape
    wl = wout_l.shape[0]
    row2 = pl.BlockSpec((1, s, 1), lambda i: (i, 0, 0), memory_space=jblock.pltpu.VMEM)
    in_specs = [jblock._row3(1, s, w), jblock._full(w), jblock._full(w),
                jblock._full(3 * wl, w), jblock._full(3 * wl, 1), jblock._full(wl, w)]
    args = [x, ln_p["scale"], ln_p["bias"], w3_l, b3_l, wout_l]
    if mask is not None:
        in_specs.append(jblock._full(s, s))
        args.append(mask.astype(jnp.float32))
    f32 = jnp.float32
    return pl.pallas_call(
        functools.partial(jblock._attn_fwd_kernel, n_heads=h_loc, head_dim=wl // h_loc, eps=1e-5,
                          g_imgs=1, has_mask=mask is not None, part=True),
        grid=(b,),
        in_specs=in_specs,
        out_specs=(jblock._row3(1, s, w),
                   pl.BlockSpec((1, 3 * wl, s), lambda i: (i, 0, 0),
                                memory_space=jblock.pltpu.VMEM),
                   pl.BlockSpec((1, h_loc, s, s), lambda i: (i, 0, 0, 0),
                                memory_space=jblock.pltpu.VMEM),
                   row2, row2),
        out_shape=(jax.ShapeDtypeStruct((b, s, w), f32),
                   jax.ShapeDtypeStruct((b, 3 * wl, s), x.dtype),
                   jax.ShapeDtypeStruct((b, h_loc, s, s), x.dtype),
                   jax.ShapeDtypeStruct((b, s, 1), f32), jax.ShapeDtypeStruct((b, s, 1), f32)),
        scratch_shapes=[jblock.pltpu.VMEM((wl, s), x.dtype),
                        jblock.pltpu.VMEM((h_loc, s, s), f32)],
        interpret=jblock._interpret(),
    )(*args)


@pytest.mark.parametrize("dtype,s,kind", [(torch.bfloat16, 17, "causal"),
                                          (torch.float32, 17, "causal"),
                                          (torch.bfloat16, S_VITL336, "none")])
def test_attn_fwd_part_twin_matches_pallas_part_kernel(dtype, s, kind):
    """attn_fwd_part_plain on the second of two head shards against the
    Pallas part kernel on the same shard (_qkv_tp_layout's rows): the
    fp32 partial, qkv, probs, mu and rstd."""
    tp_size, rank = 2, 1
    jx, jp, jm, tx, tp, tm = _inputs(40 + s, 2, s, kind, dtype)
    wl, h_loc = W // tp_size, H // tp_size
    w3tp, b3tp = jblock._qkv_tp_layout(jp["attn"], H, tp_size)
    rows = slice(rank * 3 * wl, (rank + 1) * 3 * wl)
    want = _jax_attn_part(jx, jp["ln_1"], w3tp[rows], b3tp[rows],
                          jp["attn"]["out_w"][rank * wl:(rank + 1) * wl], jm, h_loc)
    sh = shard_blocks(tp, H, tp_size, rank)["attn"]
    ypart, (qkv, probs, mu, rstd) = block.attn_fwd_part_plain(
        tx, tp["ln_1"]["scale"], tp["ln_1"]["bias"], sh["qkv_w"], sh["qkv_b"], sh["out_w"], tm,
        h_loc)
    assert ypart.dtype == torch.float32 and qkv.dtype == probs.dtype == dtype
    _close(ypart, want[0], "ypart", dtype)
    _close(qkv, np.asarray(want[1], np.float32).transpose(0, 2, 1), "qkv", dtype)
    _close(probs, want[2], "probs", dtype)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want[3])[..., 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(want[4])[..., 0], rtol=1e-5)


def _kind(jax_sel, port_sel):
    """The selection each side resolved to, in one vocabulary."""
    if jax_sel is None:
        j = "plain"
    elif jax_sel is jattention.pallas_attention:
        j = "standalone"
    else:
        j = "blocks, inference" if jax_sel.inference else "blocks"
    if port_sel is None:
        t = "plain"
    elif port_sel is attention.fused_attention:
        t = "standalone"
    else:
        t = "blocks, inference" if port_sel.inference else "blocks"
    return j, t


@pytest.mark.parametrize("value", [True, 1, "1", "on", False, 0, "0", None, "off", "block"],
                         ids=repr)
@pytest.mark.parametrize("inference", [False, True])
def test_select_attn_fn_reads_the_reference_values(value, inference):
    """Every TPU.USE_PALLAS value the reference resolves without a TPU
    measurement resolves the same way in the port: True, 1 and "1" to the
    standalone attention, False, 0, "0" and None to the plain path. ('auto'
    is left out: the reference resolves it by a TPU measurement.)"""
    j, t = _kind(jattention.select_attn_fn(value, inference=inference),
                 attention.select_attn_fn(value, inference=inference))
    assert j == t


def test_select_attn_fn_refuses_an_unknown_selection():
    """The one deliberate difference: the reference reads an unknown
    string as the plain path; the port raises."""
    assert jattention.select_attn_fn("fast") is None
    with pytest.raises(ValueError, match="unknown kernel selection"):
        attention.select_attn_fn("fast")


def test_attn_bf16_route_checks_head_width_widths_and_alignment():
    """The bf16 route (ATTN_FWD_ROUTES) takes D = 64, W and Wl in
    multiples of 64 and 16-byte-aligned tensors, and raises on anything
    else; fp32 keeps the CUDA cores and takes any width."""
    assert set(block.ATTN_FWD_ROUTES) == {torch.bfloat16, torch.float32}
    assert "mma.sync" in block.ATTN_FWD_ROUTES[torch.bfloat16]
    bf = torch.bfloat16
    x, qkv_w = torch.zeros(2, 3, 64, dtype=bf), torch.zeros(64, 192, dtype=bf)
    block._check_attn_route("t", x, 64, 1, (qkv_w,))
    with pytest.raises(ValueError, match="head width of 64"):
        block._check_attn_route("t", torch.zeros(2, 3, 128, dtype=bf), 128, 4, ())  # D = 32
    with pytest.raises(ValueError, match="head width of 64"):
        block._check_attn_route("t", torch.zeros(2, 3, 128, dtype=bf), 128, 1, ())  # D = 128
    with pytest.raises(ValueError, match="multiples of 64"):
        block._check_attn_route("t", torch.zeros(2, 3, 96, dtype=bf), 64, 1, ())  # W = 96
    with pytest.raises(ValueError, match="multiples of 64"):
        block._check_attn_route("t", x, 96, 1, ())  # Wl = 96
    with pytest.raises(ValueError, match="16-byte-aligned"):
        block._check_attn_route("t", x, 64, 1, (torch.zeros(64 * 192 + 1, dtype=bf)[1:],))
    block._check_attn_route("t", torch.zeros(2, 3, 96), 96, 3, ())  # fp32: D = 32, any width


@pytest.mark.parametrize("entry", ["attn_fwd", "attn_fwd_part"])
def test_attn_fwd_wrappers_raise_off_the_bf16_route(entry, monkeypatch):
    """attn_fwd and attn_fwd_part pick the bf16 route before any launch:
    at D = 32, off the tensor cores' shapes, they launch the CUDA cores'
    route on bf16 operands (dtype code 2, BF16_CUDA_CORES); at D = 64 a
    base off the 16-byte alignment of the tensor cores' route raises,
    with nothing launched. (Tensors on the meta device, the device check
    of _dims passed over; the launch is recorded, not made.)"""
    monkeypatch.setattr(block, "_dims", lambda name, x: x.shape)
    monkeypatch.setattr(block._build, "LAUNCHES", dict(block._build.LAUNCHES))
    monkeypatch.setattr(block, "_stream", lambda: None)
    calls = []
    monkeypatch.setattr(block._build, "call", lambda name, code, *args: calls.append((name, code)))
    bf, meta = torch.bfloat16, "meta"

    def z(*shape):
        return torch.zeros(shape, dtype=bf, device=meta)

    def run(w, h, out_w=None):
        x = z(2, 3, w)
        if entry == "attn_fwd":
            return block.attn_fwd(x, z(w), z(w), z(w, 3 * w), z(3 * w),
                                  z(w, w) if out_w is None else out_w, z(w), None, h)
        return block.attn_fwd_part(x, z(w), z(w), z(w, 3 * w // 2), z(3 * w // 2),
                                   z(w // 2, w) if out_w is None else out_w, None, h // 2)

    run(128, 4)  # D = 32
    assert calls == [(entry, 2)]
    assert block.BF16_CUDA_CORES.startswith("CUDA cores")
    calls.clear()
    w = 256  # D = 64 (the part: 2 heads of 64 on 128 columns)
    bad = torch.zeros(w * w + 1, dtype=bf, device=meta)[1:]
    with pytest.raises(ValueError, match="16-byte-aligned"):
        run(w, 4, bad.view(w, w) if entry == "attn_fwd" else bad[:w * w // 2].view(w // 2, w))
    assert calls == []


@pytest.mark.parametrize("kind", ["none", "packed"])
def test_half_block_scores_equal_the_standalone_convention_at_d64(kind):
    """At D = 64 the scale 1/8 is a power of two, so the half-block twin's
    scores T(q / 8) k^T + mask (ops/block._mha_plain) equal the standalone
    convention's fl(q k^T / 8) + mask (ops/attention._scores, the bf16
    core's mma.cuh convention) bit for bit, on seeded bf16 qkv with and
    without the text tower's packed block-causal mask; so do the
    probabilities."""
    b, h, d = 2, 3, 64
    g, seg = 7, 18  # the synthetic vocab's packing: 7 classes of 18 tokens a row
    s = g * seg
    rng = np.random.RandomState(21)
    qkv = torch.from_numpy(rng.randn(b, s, 3 * h * d).astype(np.float32)).to(torch.bfloat16)
    mask = text.block_causal_mask(g, seg) if kind == "packed" else None
    q, k, _ = qkv.view(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
    scale = d ** -0.5
    assert scale == 0.125
    qs = (q.float() * scale).to(torch.bfloat16)
    assert torch.equal(qs.float(), q.float() * scale)  # T(q / 8) is exact
    half_block = block._mm(qs, k.transpose(-1, -2))
    standalone = block._mm(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        half_block, standalone = half_block + mask, standalone + mask
    assert torch.equal(half_block, standalone)
    _, probs = block._mha_plain(qkv, mask, h)
    assert torch.equal(probs, attention._scores(q, k, mask).to(torch.bfloat16))


@pytest.mark.parametrize("s, route", [(17, "attn_core_resident"), (70, "attn_core_resident"),
                                      (126, "attn_core_resident"), (201, "attn_core_resident"),
                                      (213, "attn_core_resident"), (256, "attn_core_resident"),
                                      (257, "attn_core_windowed"), (581, "attn_core_windowed")])
@pytest.mark.parametrize("entry", ["attn_fwd", "attn_fwd_infer", "attn_fwd_tp"])
def test_attn_fwd_core_route_counts_by_s(entry, s, route, monkeypatch):
    """On the bf16 tensor cores' route each attention forward launch
    counts the core it takes by the row's keys, as csrc/attn_fwd.cu's
    launch_core picks it: the one-pass core up to RESIDENT_KEYS (256),
    the windowed core past it. Each call bumps exactly one route counter,
    beside its own wrapper's count. (Meta tensors, as above.)"""
    monkeypatch.setattr(block, "_dims", lambda name, x: x.shape)
    monkeypatch.setattr(block._build, "LAUNCHES", dict.fromkeys(block._build.LAUNCHES, 0))
    monkeypatch.setattr(block, "_stream", lambda: None)
    calls = []
    monkeypatch.setattr(block._build, "call", lambda name, code, *args: calls.append((name, code)))
    assert block.RESIDENT_KEYS == 256

    def z(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device="meta")

    w, h = 256, 4  # D = 64 (the part: 2 heads of 64 on 128 columns)
    x = z(2, s, w)
    for _ in range(2):
        if entry == "attn_fwd_tp":
            block.attn_fwd_part(x, z(w), z(w), z(w, 3 * w // 2), z(3 * w // 2), z(w // 2, w),
                                None, h // 2)
        else:
            block.attn_fwd(x, z(w), z(w), z(w, 3 * w), z(3 * w), z(w, w), z(w), None, h,
                           save_residuals=entry == "attn_fwd")
    assert calls == [(entry.removesuffix("_infer").replace("_tp", "_part"), 1)] * 2
    want = dict.fromkeys(block._build.LAUNCHES, 0)
    want.update({entry: 2, route: 2})
    assert block._build.LAUNCHES == want


def _one_pass_probs(qkv, mask, h):
    """The one-pass core's probabilities (csrc/attn_fwd.cu, res), written
    out in fp32: s = fl(q k^T / 8) + mask, the row's exact max, exp(s -
    max), the fp32 sum of a row, the IEEE divide, one rounding to bf16."""
    b, s, wl3 = qkv.shape
    q, k, _ = qkv.view(b, s, 3, h, wl3 // 3 // h).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * 0.125
    if mask is not None:
        scores = scores + mask
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True, dtype=torch.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("kind", ["none", "causal"])
@pytest.mark.parametrize("s", [17, 201])
def test_one_pass_softmax_within_one_ulp_of_the_twin(s, kind):
    """The one-pass core's contract against the half-block twin
    (ops/block._mha_plain) on seeded bf16 qkv: every probability within
    one bf16 ulp (probabilities are not negative, so neighbouring bf16
    values are neighbouring bit patterns). The twin's torch.softmax sums
    in its own order, so the two need not agree bit for bit."""
    b, h, d = 2, 3, 64
    rng = np.random.RandomState(23 + s)
    qkv = torch.from_numpy(rng.randn(b, s, 3 * h * d).astype(np.float32)).to(torch.bfloat16)
    mask = layers.causal_mask(s) if kind == "causal" else None
    _, twin = block._mha_plain(qkv, mask, h)
    got = _one_pass_probs(qkv, mask, h)
    bits = (got.view(torch.int16).int() - twin.view(torch.int16).int()).abs()
    assert (got >= 0).all() and (twin >= 0).all()
    assert bits.max().item() <= 1
    if kind == "causal":
        assert (got[..., torch.triu(torch.ones(s, s, dtype=torch.bool), 1)] == 0).all()
