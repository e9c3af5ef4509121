"""The attention half-block backwards' plain twins, which the card's
kernels (#2, #8) are held to, against the JAX package's Pallas bodies in
interpret mode, each fed the Pallas forward's residuals (qkv^T transposed
to the port's (B, S, 3W) layout, the probabilities, mu and rstd): bf16 at
the card's TOL (5e-3 x max|ref|), fp32 at 5e-6 x max|ref|. CLIP's head
width (D = 64) at a ragged length (S = 17) and at the ViT-L/14@336px image
tower's length with 4 VPT rows (S = 581), with no mask, a causal mask and
the text tower's packed block-causal mask (581 = 7 classes of 83 tokens;
17 is prime, so its packed row is 3 classes of 6 tokens, S = 18). Also the
bf16 route's checks (``ATTN_BWD_ROUTES``, ``_check_attn_route``), and that
the wrappers raise off that route before any launch."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mvlpt_tpu.ops import block as jblock
from tests.torch_port_util import block_params_np

from mvlpt_torch.core import layers, text
from mvlpt_torch.ops import block
from mvlpt_torch.parallel import shard_blocks

W, H = 128, 2  # two heads of CLIP's 64
S_VITL336 = 1 + 24 * 24 + 4  # ViT-L/14@336px: CLS, 24 x 24 patches, 4 VPT rows
CASES = [(17, "none"), (17, "causal"), (18, "packed"),
         (S_VITL336, "none"), (S_VITL336, "causal"), (S_VITL336, "packed")]
DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _close(got, want, name, dtype):
    """bf16: 5e-3 x max|ref|, the card's TOL (sums in another order move
    an output on a rounding boundary by one bf16 ulp, and ds carries such
    a step into dq and dk); fp32: 5e-6 x max|ref|."""
    want = np.asarray(want, np.float32)
    atol = (5e-3 if dtype == torch.bfloat16 else 5e-6) * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, err_msg=name)


def _mask(s, kind):
    """(jax mask, torch mask) of an (s, s) attention, None without one."""
    if kind == "none":
        return None, None
    if kind == "causal":
        tm = layers.causal_mask(s)
    else:
        g = 7 if s == S_VITL336 else 3
        tm = text.block_causal_mask(g, s // g)
    return jnp.asarray(tm.numpy()), tm


def _forward(seed, b, s, kind, dtype):
    """The Pallas forward's residuals on seeded inputs, with the cotangent:
    -> (jax params, jax gy, jax residuals, torch params, torch mask,
    torch gy)."""
    rng = np.random.RandomState(seed)
    p_np = block_params_np(rng, W)
    x_np = rng.randn(b, s, W).astype(np.float32)
    gy_np = rng.randn(b, s, W).astype(np.float32)
    jd = DTYPES[dtype]
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), p_np)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(dtype), p_np)
    jm, tm = _mask(s, kind)
    _, res = jblock._attn_fwd(jnp.asarray(x_np, jd), jp["ln_1"], jp["attn"], jm, H, 1e-5)
    return jp, jnp.asarray(gy_np, jd), res, tp, tm, torch.from_numpy(gy_np).to(dtype)


def _torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("s,kind", CASES)
def test_attn_bwd_twin_matches_pallas(s, kind, dtype):
    """attn_bwd_plain against _attn_bwd on _attn_fwd's residuals: dx."""
    b = 2 if s < 100 else 1
    jp, jgy, res, tp, _, gy = _forward(s, b, s, kind, dtype)
    jdx = jblock._attn_bwd(H, 1e-5, res, jgy)[0]
    jx, _, _, jqkvt, jprobs, jmu, jrstd = res
    qkv = _torch(np.asarray(jqkvt, np.float32).transpose(0, 2, 1), dtype)
    dx = block.attn_bwd_plain(_torch(jx, dtype), _torch(jmu, torch.float32)[..., 0],
                              _torch(jrstd, torch.float32)[..., 0], qkv,
                              _torch(jprobs, dtype), tp["ln_1"]["scale"], tp["attn"]["qkv_w"],
                              tp["attn"]["out_w"], gy, H)
    assert dx.dtype == dtype
    _close(dx, jdx, "dx", dtype)


def _jax_attn_bwd_part(qkvt_l, p_l, w3_l, wout_l, gy, h_loc):
    """The JAX package's part kernel (_attn_bwd_kernel, part=True) as
    _attn_tp_bwd calls it on one model rank's shard, one image a program:
    -> the fp32 partial dxh."""
    b, s, w = gy.shape
    wl = wout_l.shape[0]
    vmem = jblock.pltpu.VMEM
    return pl.pallas_call(
        functools.partial(jblock._attn_bwd_kernel, n_heads=h_loc, head_dim=wl // h_loc, eps=1e-5,
                          g_imgs=1, part=True),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, 3 * wl, s), lambda i: (i, 0, 0), memory_space=vmem),
                  pl.BlockSpec((1, h_loc, s, s), lambda i: (i, 0, 0, 0), memory_space=vmem),
                  jblock._full(3 * wl, w), jblock._full(wl, w), jblock._row3(1, s, w)],
        out_specs=jblock._row3(1, s, w),
        out_shape=jax.ShapeDtypeStruct((b, s, w), jnp.float32),
        scratch_shapes=[vmem((3 * wl, s), gy.dtype), vmem((h_loc, s, s), jnp.float32)],
        interpret=jblock._interpret(),
    )(qkvt_l, p_l, w3_l, wout_l, gy)


@pytest.mark.parametrize("dtype,s,kind", [(torch.bfloat16, 17, "causal"),
                                          (torch.float32, 17, "causal"),
                                          (torch.bfloat16, 18, "packed"),
                                          (torch.bfloat16, S_VITL336, "none"),
                                          (torch.float32, S_VITL336, "packed")], ids=str)
def test_attn_bwd_part_twin_matches_pallas_part_kernel(dtype, s, kind):
    """attn_bwd_part_plain on the second of two head shards against the
    Pallas part body on the same shard (_qkv_tp_layout's rows), both fed
    that shard's heads of the Pallas forward's residuals: the fp32 partial
    dxh."""
    tp_size, rank = 2, 1
    wl, h_loc = W // tp_size, H // tp_size
    jp, jgy, res, tp, _, gy = _forward(60 + s, 2, s, kind, dtype)
    _, _, _, jqkvt, jprobs, _, _ = res
    # This rank's [q | k | v] rows of qkv^T, and its heads' probabilities.
    qkvt_l = jnp.concatenate([jqkvt[:, i * W + rank * wl:i * W + (rank + 1) * wl]
                              for i in range(3)], axis=1)
    p_l = jprobs[:, rank * h_loc:(rank + 1) * h_loc]
    w3tp, _ = jblock._qkv_tp_layout(jp["attn"], H, tp_size)
    want = _jax_attn_bwd_part(qkvt_l, p_l, w3tp[rank * 3 * wl:(rank + 1) * 3 * wl],
                              jp["attn"]["out_w"][rank * wl:(rank + 1) * wl], jgy, h_loc)
    sh = shard_blocks(tp, H, tp_size, rank)["attn"]
    qkv = _torch(np.asarray(qkvt_l, np.float32).transpose(0, 2, 1), dtype)
    dxh = block.attn_bwd_part_plain(qkv, _torch(p_l, dtype), sh["qkv_w"], sh["out_w"], gy, h_loc)
    assert dxh.dtype == torch.float32
    _close(dxh, want, "dxh", dtype)


def test_attn_bwd_routes_and_their_check():
    """ATTN_BWD_ROUTES: bf16 on the tensor cores (wgmma products, an
    mma.sync core), fp32 on the CUDA cores; the backwards share the
    forwards' route check (D = 64, W and Wl multiples of 64, 16-byte
    aligned bases; fp32 any width), walked here as the part's shard
    shapes reach it."""
    assert set(block.ATTN_BWD_ROUTES) == {torch.bfloat16, torch.float32}
    assert "wgmma" in block.ATTN_BWD_ROUTES[torch.bfloat16]
    assert "mma.sync" in block.ATTN_BWD_ROUTES[torch.bfloat16]
    assert "CUDA cores" in block.ATTN_BWD_ROUTES[torch.float32]
    bf = torch.bfloat16
    gy = torch.zeros(2, 3, 128, dtype=bf)
    block._check_attn_route("t", gy, 64, 1, (torch.zeros(2, 3, 192, dtype=bf),))  # tp = 2 shard
    block._check_attn_route("t", gy, 128, 2, ())
    with pytest.raises(ValueError, match="head width of 64"):
        block._check_attn_route("t", gy, 64, 2, ())  # a shard of D = 32 heads
    with pytest.raises(ValueError, match="multiples of 64"):
        block._check_attn_route("t", gy, 32, 1, ())  # Wl = 32
    with pytest.raises(ValueError, match="multiples of 64"):
        block._check_attn_route("t", torch.zeros(2, 3, 192 + 32, dtype=bf), 64, 1, ())
    with pytest.raises(ValueError, match="16-byte-aligned"):
        block._check_attn_route("t", gy, 64, 1, (torch.zeros(2 * 3 * 64 + 1, dtype=bf)[1:],))
    block._check_attn_route("t", torch.zeros(2, 3, 96), 48, 3, ())  # fp32: D = 16, any width


def test_attn_bwd_scratch_is_the_routes():
    """The bf16 route's core scratch is the (B, H, S) fp32 t alone; the
    fp32 route's the (B, H, S, S) ds. The bf16 wrapper asks for no
    (B, H, S, S) tensor."""
    t = block._attn_bwd_scratch(torch.zeros(2, 5, 128, dtype=torch.bfloat16), 2, 2, 5)
    assert (tuple(t.shape), t.dtype) == ((2, 2, 5), torch.float32)
    ds = block._attn_bwd_scratch(torch.zeros(2, 5, 128), 2, 2, 5)
    assert (tuple(ds.shape), ds.dtype) == ((2, 2, 5, 5), torch.float32)


@pytest.mark.parametrize("entry,w,wl,h", [("attn_bwd", 128, 128, 4), ("attn_bwd", 96, 96, 1),
                                          ("attn_bwd_part", 128, 128, 4),
                                          ("attn_bwd_part", 96, 96, 1),
                                          ("attn_bwd_part", 128, 96, 1)],
                         ids=["attn_bwd-D32", "attn_bwd-W96", "attn_bwd_part-D32",
                              "attn_bwd_part-W96", "attn_bwd_part-Wl96"])
def test_attn_bwd_wrappers_raise_off_the_bf16_route(entry, w, wl, h, monkeypatch):
    """attn_bwd and attn_bwd_part pick the bf16 route before any launch:
    off the tensor cores' shapes (D = 32, W = 96, and for the part Wl =
    96) they launch the CUDA cores' route on bf16 operands (dtype code 2)
    with its (B, H, S, S) fp32 ds scratch, not the twin; at the tensor
    cores' shapes a misaligned base raises, with nothing launched. (Meta
    tensors, with the wrappers' device check lifted, reach the launch
    without a card; it is recorded, not made.)"""
    monkeypatch.setattr(block, "_dims", lambda name, x: x.shape)
    monkeypatch.setattr(block._build, "LAUNCHES", dict(block._build.LAUNCHES))
    monkeypatch.setattr(block, "_stream", lambda: None)
    calls = []
    monkeypatch.setattr(block._build, "call",
                        lambda name, code, *args: calls.append((name, code, args)))
    b, s = 2, 3

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device="meta")

    def run(w, wl, h, qkv_w=None):
        gy, stats = z(b, s, w), z(b, s, dtype=torch.float32)
        if entry == "attn_bwd":
            return block.attn_bwd(z(b, s, w), stats, stats, z(b, s, 3 * w), z(b, h, s, s), z(w),
                                  z(w, 3 * w) if qkv_w is None else qkv_w, z(w, w), gy, h)
        return block.attn_bwd_part(z(b, s, 3 * wl), z(b, h, s, s),
                                   z(w, 3 * wl) if qkv_w is None else qkv_w, z(wl, w), gy, h)

    run(w, wl, h)
    [(name, code, args)] = calls
    assert (name, code) == (entry, 2)
    calls.clear()
    with pytest.raises(ValueError, match=f"{entry}: the bf16 tensor-core route needs 16-byte"):
        run(128, 128, 2, torch.zeros(128 * 384 + 1, dtype=torch.bfloat16,
                                     device="meta")[1:].view(128, 384))
    assert calls == []


def test_attn_bwd_cuda_core_route_scratch():
    """The bf16 CUDA cores' route keeps the CUDA cores' (B, H, S, S) fp32
    ds scratch, as fp32 does."""
    like = torch.zeros(2, 5, 96, dtype=torch.bfloat16)
    ds = block._attn_bwd_scratch(like, 2, 3, 5, 2)
    assert (tuple(ds.shape), ds.dtype) == ((2, 3, 5, 5), torch.float32)