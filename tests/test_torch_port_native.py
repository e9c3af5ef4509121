"""DATALOADER.BACKEND "native" in the port (``mvlpt_torch/native``,
``mvlpt_torch/data/native_transform.py``) against PIL and against the JAX
package's native core, bit for bit: every case of
tests/test_native_pipe.py (decode of baseline, progressive and grey
JPEG and of PNG; the palette, alpha, 1-bit and WEBP fallbacks; a
truncated JPEG raising as PIL does; the decompression-bomb guard;
``resample`` under every filter; the train and eval transforms;
``fast_jpeg``'s draw alignment and pixel error), the loader's batches
on both backends, the C++ sources held byte-equal to the JAX package's,
the library built under ``build/`` (never ``~/.cache``), a broken g++
making "native" raise, and the route a host without libjpeg and libpng
headers takes (the headers under ``native/include`` against Pillow's
own libraries)."""

import ctypes
import io
import os
import random
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mvlpt_tpu import native as jnative
from mvlpt_tpu.data import native_transform as jnt
from mvlpt_torch import native
from mvlpt_torch.data.native_transform import NativeEvalTransform, NativeTrainTransform
from mvlpt_torch.data.transforms import EvalTransform, TrainTransform

ROOT = Path(__file__).resolve().parent.parent
_PIL_FILTERS = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
                "lanczos": Image.LANCZOS}


@pytest.fixture(scope="module", autouse=True)
def jax_core_in_tmp(tmp_path_factory):
    """The JAX package's core builds under a tmp dir, not ~/.cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MVLPT_TPU_NATIVE_CACHE", str(tmp_path_factory.mktemp("jax_native")))
        yield


def _rand_rgb(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3), np.uint8)


def _encode(arr, fmt, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, fmt, **kw)
    return buf.getvalue()


def _gray(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


DECODE_CASES = {
    "jpeg-q90": lambda: _encode(_rand_rgb((48, 64), 0), "JPEG", quality=90),
    "jpeg-q75-odd": lambda: _encode(_rand_rgb((131, 97), 1), "JPEG", quality=75),
    "jpeg-q100-wide": lambda: _encode(_rand_rgb((17, 301), 2), "JPEG", quality=100),
    "jpeg-progressive": lambda: _encode(_rand_rgb((60, 80), 3), "JPEG", quality=85,
                                        progressive=True),
    "jpeg-grey": lambda: _encode(_gray((50, 70), 4), "JPEG", "L", quality=92),
    "png-rgb": lambda: _encode(_rand_rgb((33, 57), 5), "PNG"),
    "png-grey": lambda: _encode(_gray((40, 22), 6), "PNG", "L"),
}


def test_sources_are_the_jax_packages_byte_for_byte():
    for name in ("imagepipe.cpp", "bpetok.cpp"):
        assert (ROOT / "mvlpt_torch/native" / name).read_bytes() == \
            (ROOT / "mvlpt_tpu/native" / name).read_bytes(), name


def test_library_builds_under_build_not_home(monkeypatch, tmp_path):
    """The default build directory is build/mvlpt_torch_native beside the
    package; MVLPT_TORCH_BUILD_DIR moves it; nothing goes to ~/.cache."""
    monkeypatch.delenv("MVLPT_TORCH_BUILD_DIR", raising=False)
    assert native.build_dir() == ROOT / "build" / "mvlpt_torch_native"
    info = native.toolchain()
    assert Path(info["library"]).parent == native.build_dir()
    assert info["route"] in ("system", "vendored headers")
    assert any("libjpeg" in line for line in info["linked"])
    assert any("libpng" in line for line in info["linked"])
    assert not str(info["library"]).startswith(os.path.expanduser("~/.cache"))
    monkeypatch.setenv("MVLPT_TORCH_BUILD_DIR", str(tmp_path))
    lib = native._build(native._BPE_SRC, "bpetok")
    assert lib.parent == tmp_path and lib.is_file()


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_matches_pil_and_jax(case):
    data = DECODE_CASES[case]()
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    w, h = native.probe(data)
    assert (h, w) == ref.shape[:2] and jnative.probe(data) == (w, h)
    got = native.decode(data, w, h)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jnative.decode(data, w, h))


def _palette():
    buf = io.BytesIO()
    Image.fromarray(_rand_rgb((20, 20), 7)).convert("P").save(buf, "PNG")
    return buf.getvalue()


def _rgba():
    buf = io.BytesIO()
    Image.fromarray(_rand_rgb((20, 20), 7)).convert("RGBA").save(buf, "PNG")
    return buf.getvalue()


def _one_bit():
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(16).random((60, 80)) > 0.5).save(buf, "PNG")
    return buf.getvalue()


OFF_PATH = {"palette-png": _palette, "rgba-png": _rgba, "one-bit-png": _one_bit,
            "webp": lambda: _encode(_rand_rgb((20, 20), 7), "WEBP"),
            "junk": lambda: b"not an image"}


@pytest.mark.parametrize("case", sorted(OFF_PATH))
def test_off_the_fast_path_probes_none(case):
    data = OFF_PATH[case]()
    assert native.probe(data) is None and jnative.probe(data) is None
    if case != "junk":  # and the transform falls back to PIL, bit for bit
        img = Image.open(io.BytesIO(data))
        np.testing.assert_array_equal(NativeEvalTransform(size=32)(data),
                                      EvalTransform(size=32)(img))


@pytest.mark.parametrize("name", sorted(_PIL_FILTERS))
def test_resample_matches_pil_and_jax(name):
    arr = _rand_rgb((48, 64), 8)
    img = Image.fromarray(arr)
    for out in [(224, 224), (17, 31), (64, 48), (128, 24), (300, 7)]:
        for box in [None, (3, 5, 60, 40), (0.5, 1.25, 63.5, 47.75), (10, 10, 11, 11)]:
            ref = np.asarray(img.resize(out, _PIL_FILTERS[name], box=box))
            got = native.resample(arr, box or (0, 0, 64, 48), out[0], out[1], name)
            np.testing.assert_array_equal(got, ref, err_msg=f"{out} {name} {box}")
            np.testing.assert_array_equal(
                got, jnative.resample(arr, box or (0, 0, 64, 48), out[0], out[1], name))


def test_resample_identity_and_errors():
    arr = _rand_rgb((16, 16), 9)
    np.testing.assert_array_equal(native.resample(arr, (0, 0, 16, 16), 16, 16, "bicubic"), arr)
    with pytest.raises(ValueError):
        native.resample(arr, (0, 0, 20, 16), 8, 8, "bicubic")  # box out of the image
    with pytest.raises(ValueError):
        native.resample(arr.astype(np.float32), (0, 0, 16, 16), 8, 8, "bicubic")


def _three_train(data, seed, size=32, to_uint8=False, **kw):
    """PIL's TrainTransform, the port's native one and the JAX package's,
    each on its own Random(seed)."""
    pil = TrainTransform(size=size, to_uint8=to_uint8)(Image.open(io.BytesIO(data)),
                                                       rng=random.Random(seed))
    port = NativeTrainTransform(size=size, to_uint8=to_uint8, **kw)(data, rng=random.Random(seed))
    jax_ = jnt.NativeTrainTransform(size=size, to_uint8=to_uint8, **kw)(
        data, rng=random.Random(seed))
    return pil, port, jax_


@pytest.mark.parametrize("to_uint8", [False, True], ids=["float", "uint8"])
def test_train_transform_parity_jpeg(to_uint8):
    data = _encode(_rand_rgb((90, 120), 10), "JPEG", quality=95)
    for seed in range(6):  # both flip branches, several crops
        pil, port, jax_ = _three_train(data, seed, to_uint8=to_uint8)
        assert pil.dtype == port.dtype
        np.testing.assert_array_equal(port, pil)
        np.testing.assert_array_equal(port, jax_)


def test_train_transform_parity_fallback_format():
    buf = io.BytesIO()
    Image.fromarray(_rand_rgb((64, 64), 11)).save(buf, "WEBP", lossless=True)
    for seed in range(3):
        pil, port, jax_ = _three_train(buf.getvalue(), seed)
        np.testing.assert_array_equal(port, pil)
        np.testing.assert_array_equal(port, jax_)


@pytest.mark.parametrize("shape", [(90, 120), (120, 90), (31, 224), (224, 224), (500, 35)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_eval_transform_parity(shape):
    data = _encode(_rand_rgb(shape, sum(shape)), "JPEG", quality=92)
    img = Image.open(io.BytesIO(data))
    for kw in [dict(size=32), dict(size=224), dict(size=33),
               dict(size=(64, 64), center_crop_mode=False),
               dict(size=(48, 80), center_crop_mode=False)]:
        got = NativeEvalTransform(**kw)(data)
        np.testing.assert_array_equal(got, EvalTransform(**kw)(img), err_msg=str(kw))
        np.testing.assert_array_equal(got, jnt.NativeEvalTransform(**kw)(data))


def test_eval_transform_grey_png_parity():
    data = _encode(_gray((77, 118), 13), "PNG", "L")
    got = NativeEvalTransform(size=48)(data)
    np.testing.assert_array_equal(got, EvalTransform(size=48)(Image.open(io.BytesIO(data))))
    np.testing.assert_array_equal(got, jnt.NativeEvalTransform(size=48)(data))


def test_truncated_jpeg_raises_like_pil():
    data = _encode(_rand_rgb((64, 64), 17), "JPEG", quality=90)
    cut = data[: len(data) // 2]  # header intact, scan truncated
    with pytest.raises(OSError):
        EvalTransform(size=32)(Image.open(io.BytesIO(cut)))
    with pytest.raises(OSError):  # decode reports corrupt -> the PIL path raises
        NativeEvalTransform(size=32)(cut)


def test_decompression_bomb_guard(monkeypatch):
    data = _encode(_rand_rgb((64, 48), 18), "JPEG", quality=90)
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", 1000)  # 64 x 48 > 2 x 1000
    assert native.probe(data) is None  # oversize header -> the PIL path
    with pytest.raises(Image.DecompressionBombError):
        NativeEvalTransform(size=32)(data)


def test_fast_jpeg_draws_align_and_pixels_stay_close():
    """NATIVE_FAST_JPEG: the same shapes, pixels within a mean 8/255 of the
    exact path, the JAX package's fast path bit for bit, and the draw after
    the transform the PIL backend's."""
    small = _rand_rgb((96, 128), 12)
    data = _encode(np.asarray(Image.fromarray(small).resize((1024, 768), Image.BICUBIC)),
                   "JPEG", quality=90)
    exact = NativeTrainTransform(size=64, to_uint8=True)
    fast = NativeTrainTransform(size=64, to_uint8=True, fast_jpeg=True)
    jfast = jnt.NativeTrainTransform(size=64, to_uint8=True, fast_jpeg=True)
    for seed in range(4):
        a = exact(data, rng=random.Random(seed))
        b = fast(data, rng=random.Random(seed))
        assert a.shape == b.shape == (64, 64, 3)
        assert np.abs(a.astype(int) - b.astype(int)).mean() < 8.0
        np.testing.assert_array_equal(b, jfast(data, rng=random.Random(seed)))
    ev_exact = NativeEvalTransform(size=64, to_uint8=True)(data)
    ev_fast = NativeEvalTransform(size=64, to_uint8=True, fast_jpeg=True)(data)
    assert ev_fast.shape == (64, 64, 3)
    assert np.abs(ev_exact.astype(int) - ev_fast.astype(int)).mean() < 8.0
    np.testing.assert_array_equal(
        ev_fast, jnt.NativeEvalTransform(size=64, to_uint8=True, fast_jpeg=True)(data))
    draws = []
    for t in (TrainTransform(size=64), exact, fast):
        r = random.Random(7)
        t(Image.open(io.BytesIO(data)) if t.__class__ is TrainTransform else data, rng=r)
        draws.append(r.random())
    assert draws[0] == draws[1] == draws[2]


def _items(tmp_path, n=10, seed=14):
    from mvlpt_torch.data.datum import Datum

    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        p = tmp_path / f"im_{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (40 + i, 50, 3), np.uint8)).save(p, quality=90)
        items.append(Datum(impath=str(p), label=i % 3))
    return items


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_loader_batches_match_python_backend_and_jax(tmp_path, is_train):
    """build_transform + build_data_loader on "native": the batches of the
    "python" backend and of the JAX package's "native", bit for bit."""
    from mvlpt_tpu.config.defaults import get_cfg_default as j_cfg
    from mvlpt_tpu.data.datum import Datum as JDatum
    from mvlpt_tpu.data.loader import build_data_loader as j_loader
    from mvlpt_tpu.data.transforms import build_transform as j_transform

    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.data.loader import build_data_loader
    from mvlpt_torch.data.transforms import build_transform

    items = _items(tmp_path)

    def cfg_of(make, backend):
        cfg = make()
        cfg.defrost()
        cfg.DATALOADER.BACKEND = backend
        cfg.DATALOADER.NUM_WORKERS = 2
        cfg.INPUT.SIZE = (32, 32)
        cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip", "normalize")
        cfg.SEED = 3
        return cfg

    def port(backend):
        cfg = cfg_of(get_cfg_default, backend)
        return list(build_data_loader(cfg, items, 4, build_transform(cfg, is_train), is_train))

    ref, got = port("python"), port("native")
    assert isinstance(build_transform(cfg_of(get_cfg_default, "native"), is_train),
                      (NativeTrainTransform, NativeEvalTransform))
    jcfg = cfg_of(j_cfg, "native")
    jitems = [JDatum(impath=d.impath, label=d.label) for d in items]
    want = list(j_loader(jcfg, jitems, 4, j_transform(jcfg, is_train), is_train))
    assert len(ref) == len(got) == len(want) > 0
    for r, g, w in zip(ref, got, want):
        for k in ("image", "label"):
            np.testing.assert_array_equal(g[k], r[k])
            np.testing.assert_array_equal(g[k], w[k])


def test_broken_compiler_makes_native_raise(monkeypatch, tmp_path):
    """A g++ that fails leaves no library: BACKEND "native" raises
    RuntimeError with the compiler's stderr; "python" still builds."""
    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.data.transforms import build_transform

    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "g++").write_text("#!/bin/sh\necho 'g++: fatal error: broken on purpose' >&2\n"
                              "exit 1\n")
    (fake / "g++").chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("MVLPT_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", None)
    cfg = get_cfg_default()
    cfg.DATALOADER.BACKEND = "native"
    with pytest.raises(RuntimeError, match="broken on purpose"):
        build_transform(cfg, is_train=False)
    assert not list((tmp_path / "build").glob("*.so"))
    cfg.DATALOADER.BACKEND = "python"
    assert type(build_transform(cfg, is_train=False)) is EvalTransform
    cfg.DATALOADER.BACKEND = "tf"
    with pytest.raises(NotImplementedError, match="tfdata"):
        build_transform(cfg, is_train=False)


def test_vendored_headers_route_against_pillows_libraries(monkeypatch, tmp_path):
    """The route of a host without libjpeg and libpng headers: the headers
    under native/include against the libraries Pillow ships, by full path.
    The core it builds decodes as PIL does."""
    pillow_libs = Path(Image.__file__).resolve().parent.parent / "pillow.libs"
    libs = [sorted(pillow_libs.glob(f"{stem}-*.so*")) for stem in ("libjpeg", "libpng16")]
    if not all(libs):
        pytest.skip(f"this Pillow ships no libjpeg/libpng16 under {pillow_libs}")
    libs = [str(found[0]) for found in libs]
    monkeypatch.setenv("MVLPT_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_built", {})
    include = ROOT / "mvlpt_torch" / "native" / "include"
    route = ("vendored headers", ["-I", str(include), *libs,
                                  *(f"-Wl,-rpath,{Path(p).parent}" for p in libs)])
    lib = native._bind(ctypes.CDLL(str(native._build(routes=[route]))))
    monkeypatch.setattr(native, "_lib", lib)
    for case in ("jpeg-q90", "jpeg-progressive", "jpeg-grey", "png-rgb", "png-grey"):
        data = DECODE_CASES[case]()
        w, h = native.probe(data)
        np.testing.assert_array_equal(native.decode(data, w, h),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
