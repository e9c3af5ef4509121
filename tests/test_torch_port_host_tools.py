"""The port's host tools against the JAX package's on the CPU:
``cli/build_manifest.py`` (every source kind: a vision_datasets hub dump
with zip-backed images, ImageFolder trees for a known and an unknown
task, ``--link``, TSV indexes; the manifests byte-equal, the reports
the same), ``cli/check_data.py`` and ``cli/prepare_submit.py`` (the same
reports and exit codes, the submission's members byte-equal),
``cli/draw_curves.py`` (the readers equal, the figures written, and an
ImportError naming matplotlib where it is missing),
``tokenizer/hf_adapter.py`` (a tokenizer saved to a tmp dir; an uncached
hub name refused), ``checkpoint/convert.py:convert_hf_clip`` (a random
``transformers.CLIPModel``, leaves at 1e-6) and ``load_clip`` by OpenAI
model name (a seeded cache, its sha256 checked; where the JAX package
would download, the port raises)."""

import hashlib
import io
import json
import os
import sys
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_draw_curves import _ref_column, write_minimal_xlsx
from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)


def _jax_cli(module, argv, monkeypatch):
    """Run a JAX CLI's ``cli()`` (it reads sys.argv)."""
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.cli()


def _both(jmod, tmod, argv_of, monkeypatch, capsys):
    """(JAX, port) of (stdout, SystemExit code or None) of one run each,
    ``argv_of(side)`` giving each side's argv."""
    out = {}
    for side, run in (("jax", lambda a: _jax_cli(jmod, a, monkeypatch)),
                      ("port", lambda a: tmod.cli(a))):
        capsys.readouterr()
        code = None
        try:
            run(argv_of(side))
        except SystemExit as e:
            code = e.code
        out[side] = (capsys.readouterr().out, code)
    return out["jax"], out["port"]


def _png(seed, size=(24, 24)):
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(seed).randint(0, 255, size + (3,), np.uint8)).save(
        buf, "PNG")
    return buf.getvalue()


def _hub_dump(root):
    """A miniature vision_datasets hub dump (tests/test_hub_interop.py's
    layout): cifar-10 with zip-backed train and test images."""
    task_root = root / "classification" / "cifar10_20200721"
    task_root.mkdir(parents=True)
    for n_split, (split, n) in enumerate((("train", 8), ("test", 4))):
        index = []
        with zipfile.ZipFile(task_root / f"{split}.zip", "w") as zf:
            for i in range(n):
                member = f"{split}_images/{i}.png"
                zf.writestr(member, _png(100 * n_split + i))
                index.append(f"{split}.zip@{member} {i % 10}")
        (task_root / f"{split}_index.txt").write_text("\n".join(index) + "\n")
    registry = [{"name": "cifar-10", "version": 1, "type": "classification_multiclass",
                 "root_folder": "classification/cifar10_20200721",
                 "train": {"index_path": "train_index.txt", "num_images": 8},
                 "test": {"index_path": "test_index.txt", "num_images": 4},
                 "num_classes": 10}]
    (root / "vision_datasets.json").write_text(json.dumps(registry))


def _image_folder(src, folders):
    for split in ("train", "test"):
        for i, cls in enumerate(folders):
            d = src / split / cls
            d.mkdir(parents=True)
            Image.fromarray(np.full((8, 8, 3), 20 * i, np.uint8)).save(d / "x.jpg")


def _tsv(src, max_label):
    (src / "images").mkdir(parents=True)
    for split in ("train", "test"):
        lines = []
        for i in range(max_label + 1):
            rel = f"images/{split}_{i}.jpg"
            Image.new("RGB", (8, 8)).save(src / rel)
            lines.append(f"{rel}\t{i}")
        (src / f"{split}.tsv").write_text("\n".join(lines) + "\n")


SOURCES = {
    "hub": ("cifar-10", lambda src: _hub_dump(src), ()),
    "folder-known-task": ("cifar-10", lambda src: _image_folder(
        src, ["Truck", "airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse",
              "ship"]), ()),
    "folder-own-task": ("my-task", lambda src: _image_folder(src, ["b", "a", "c"]), ()),
    "folder-link": ("my-task", lambda src: _image_folder(src, ["b", "a"]), ("--link",)),
    "tsv-subset": ("cifar-10", lambda src: _tsv(src, 6), ()),
    "tsv-own-task": ("my-task", lambda src: _tsv(src, 3), ("--multilabel",)),
    "tsv-too-many-labels": ("cifar-10", lambda src: _tsv(src, 11), ()),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_build_manifest_matches_jax(tmp_path, monkeypatch, capsys, source):
    from mvlpt_tpu.cli import build_manifest as jbm
    from mvlpt_torch.cli import build_manifest as tbm

    task, make, flags = SOURCES[source]
    src = tmp_path / "src"
    src.mkdir()
    make(src)
    roots = {"jax": tmp_path / "jax_root", "port": tmp_path / "port_root"}
    j, t = _both(jbm, tbm, lambda side: ["--src", str(src), "--task", task, "--root",
                                         str(roots[side]), *flags], monkeypatch, capsys)
    assert t[1] == j[1]
    assert t[0].replace(str(roots["port"]), "ROOT") == j[0].replace(str(roots["jax"]), "ROOT")
    if source == "tsv-too-many-labels":
        assert not (roots["port"] / task / "manifest.json").exists()
        return
    got = (roots["port"] / task / "manifest.json").read_bytes()
    assert got == (roots["jax"] / task / "manifest.json").read_bytes()
    if flags == ("--link",):
        assert os.path.islink(roots["port"] / task / "train")
    from mvlpt_torch.data.elevater import load_task_manifest

    m = load_task_manifest(str(roots["port"]), task, test_set="test",
                           strict_classnames=False)
    assert len(m.train) == len(json.loads(got)["splits"]["train"])


def _coop_and_elevater_root(root):
    pets = root / "oxford_pets"
    (pets / "images").mkdir(parents=True)
    for i in range(3):
        Image.new("RGB", (8, 8)).save(pets / "images" / f"a_{i}.jpg")
    (pets / "split_zhou_OxfordPets.json").write_text("{}")
    (root / "dtd").mkdir()  # no images/ and no split json: two problems
    (root / "corrupt.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    hub = root / "hub"
    hub.mkdir()
    _hub_dump(hub)
    from mvlpt_torch.cli import build_manifest

    build_manifest.cli(["--src", str(hub), "--task", "cifar-10", "--root", str(root)])


@pytest.mark.parametrize("argv", [
    ["--dataset", "OxfordPets,DescribableTextures,NoSuch"],
    ["--dataset", "OxfordPets", "--skip-decode"],
    ["--dataset", "cifar-10,mnist,not-a-task", "--elevater"],
    ["--dataset", "cifar-10", "--elevater", "--skip-decode"],
], ids=["coop", "coop-skip-decode", "elevater", "elevater-zip-only"])
def test_check_data_matches_jax(tmp_path, monkeypatch, capsys, argv):
    from mvlpt_tpu.cli import check_data as jcd
    from mvlpt_torch.cli import check_data as tcd

    _coop_and_elevater_root(tmp_path)
    capsys.readouterr()
    j, t = _both(jcd, tcd, lambda side: ["--root", str(tmp_path), *argv], monkeypatch, capsys)
    assert t == j
    assert t[1] in (0, 1) and t[0].startswith("[")


def test_prepare_submit_matches_jax(tmp_path, monkeypatch, capsys):
    from mvlpt_tpu.cli import prepare_submit as jps
    from mvlpt_torch.cli import prepare_submit as tps

    preds = tmp_path / "preds"
    preds.mkdir()
    rng = np.random.RandomState(0)
    np.savez(preds / "cifar-10.npz", logits=rng.randn(6, 10).astype(np.float32))
    np.savez(preds / "my-task.npz", logits=rng.randn(4, 3).astype(np.float32))
    (preds / "notes.txt").write_text("skipped")
    zips = {"jax": tmp_path / "jax" / "submit.zip", "port": tmp_path / "port" / "submit.zip"}
    for z in zips.values():
        z.parent.mkdir()
    j, t = _both(jps, tps, lambda side: ["--predictions-dir", str(preds), "--output-zip",
                                         str(zips[side])], monkeypatch, capsys)
    assert t[0].replace(str(zips["port"]), "ZIP") == j[0].replace(str(zips["jax"]), "ZIP")
    with zipfile.ZipFile(zips["port"]) as a, zipfile.ZipFile(zips["jax"]) as b:
        assert a.namelist() == b.namelist() == ["cifar-10.json", "my-task.json"]
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    with pytest.raises(ValueError, match="sum to 1"):
        tps.validate_predictions(np.full((2, 3), 0.5), 3)
    with pytest.raises(ValueError, match=r"\(N, 4\)"):
        tps.validate_predictions(np.full((2, 3), 1 / 3), 4)


@pytest.mark.parametrize("omit_empty_rows", [False, True], ids=["explicit", "excel-sparse"])
def test_draw_curves_readers_match_jax(tmp_path, omit_empty_rows):
    from mvlpt_tpu.cli import draw_curves as jdc
    from mvlpt_torch.cli import draw_curves as tdc

    rng = np.random.RandomState(0)
    cols = {"OxfordPets": _ref_column(rng), "DTD": _ref_column(rng)}
    path = str(tmp_path / "Results.xlsx")
    write_minimal_xlsx(path, cols, omit_empty_rows=omit_empty_rows)
    got = tdc.read_xlsx_sheet(path, "imcls_fewshot")
    assert got == jdc.read_xlsx_sheet(path, "imcls_fewshot")
    assert got["DTD"][1] is None and got["DTD"][0] == cols["DTD"][0]
    with pytest.raises(SystemExit, match="nope"):
        tdc.read_xlsx_sheet(path, "nope")
    assert (tdc.METHODS, tdc.SHOTS, tdc.DEFAULT_DATASETS) == \
        (jdc.METHODS, jdc.SHOTS, jdc.DEFAULT_DATASETS)


def test_draw_curves_writes_the_figures(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    from mvlpt_torch.cli import draw_curves as tdc

    rng = np.random.RandomState(1)
    path = str(tmp_path / "Results.xlsx")
    write_minimal_xlsx(path, {"OxfordPets": _ref_column(rng), "DTD": _ref_column(rng)})
    tdc.cli(["--xlsx", path, "--output-dir", str(tmp_path / "sheet"), "--format", "png"])
    for name in ("OxfordPets", "DTD", "average"):
        assert (tmp_path / "sheet" / f"{name}.png").stat().st_size > 0
    csv_path = tmp_path / "res.csv"
    csv_path.write_text("method,dataset,shots,accuracy\n"
                        "coop,pets,1,60\ncoop,pets,16,80\nlinear,pets,1,40\n")
    tdc.cli(["--csv", str(csv_path), "--output-dir", str(tmp_path / "csv")])
    assert (tmp_path / "csv" / "pets_curve.png").stat().st_size > 0


def test_draw_curves_names_matplotlib_where_it_is_missing(tmp_path, monkeypatch):
    """The readers need no matplotlib; drawing without it raises an
    ImportError that names it (the GPU host has none)."""
    from mvlpt_torch.cli import draw_curves as tdc

    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    csv_path = tmp_path / "res.csv"
    csv_path.write_text("method,dataset,shots,accuracy\ncoop,pets,1,60\n")
    with pytest.raises(ImportError, match="matplotlib"):
        tdc.draw_from_csv(str(csv_path), str(tmp_path / "out"))
    path = str(tmp_path / "Results.xlsx")
    write_minimal_xlsx(path, {"DTD": _ref_column(np.random.RandomState(2))})
    assert "DTD" in tdc.read_xlsx_sheet(path, "imcls_fewshot")


@pytest.fixture(scope="module")
def saved_tokenizers(tmp_path_factory):
    """A WordPiece (BERT) and a byte-level BPE (GPT-2, no pad token)
    tokenizer built from local vocab files and saved to tmp dirs."""
    transformers = pytest.importorskip("transformers")
    root = tmp_path_factory.mktemp("hf_tok")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "photo", "of", "the", "dog",
             "cat", "##s", "big", "."]
    (root / "vocab.txt").write_text("\n".join(words) + "\n")
    bert = transformers.BertTokenizer(str(root / "vocab.txt"))
    bert.save_pretrained(str(root / "bert"))
    chars = sorted(set("aphotofthedgcbis.Ġ"))
    vocab = {c: i for i, c in enumerate(chars)}
    merges = ["p h", "o t", "ph ot", "Ġ a", "Ġ c"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    gpt2 = transformers.GPT2Tokenizer(str(root / "vocab.json"), str(root / "merges.txt"))
    gpt2.save_pretrained(str(root / "gpt2"))
    return root


@pytest.mark.parametrize("kind", ["bert", "gpt2"])
def test_hf_adapter_matches_jax(saved_tokenizers, kind):
    from mvlpt_tpu.tokenizer.hf_adapter import HFPTTokenizer as JTok
    from mvlpt_torch.tokenizer.hf_adapter import HFPTTokenizer

    path = str(saved_tokenizers / kind)
    tok, jtok = HFPTTokenizer(path), JTok(path)
    texts = ["a photo of the dog.", "the big cats"]
    got = tok(texts, context_length=12)
    assert got.dtype == np.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got, jtok(texts, context_length=12))
    np.testing.assert_array_equal(tok.tokenize("a photo", 5), jtok.tokenize("a photo", 5))
    assert tok.vocab_size == jtok.vocab_size
    assert tok.tokenizer.pad_token is not None


def test_hf_adapter_refuses_an_uncached_hub_name(monkeypatch, tmp_path, synthetic_vocab):  # noqa: F811
    """local_files_only: a name the local cache lacks raises (the JAX
    package would fetch it); build_tokenizer('clip') is the CLIP BPE."""
    pytest.importorskip("transformers")
    from mvlpt_torch.tokenizer import bpe
    from mvlpt_torch.tokenizer.hf_adapter import HFPTTokenizer, build_tokenizer

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        HFPTTokenizer("no-such-org/no-such-tokenizer")
    assert build_tokenizer("clip") is bpe.get_tokenizer()


@pytest.fixture(scope="module")
def hf_clip():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPConfig(
        projection_dim=32,
        text_config=dict(hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=77, vocab_size=49408,
                         hidden_act="quick_gelu"),
        vision_config=dict(hidden_size=48, intermediate_size=192, num_hidden_layers=2,
                           num_attention_heads=4, image_size=32, patch_size=8,
                           hidden_act="quick_gelu"))
    torch.manual_seed(0)
    return transformers.CLIPModel(cfg).eval()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.float() if isinstance(tree, torch.Tensor) else tree)}


def test_convert_hf_clip_matches_jax(hf_clip):
    """Every leaf and the config of the port's conversion equal the JAX
    converter's (1e-6), and the converted towers give transformers'
    features (2e-4, as tests/test_clip_parity.py holds the JAX ones)."""
    import jax

    from mvlpt_tpu.checkpoint.convert import convert_hf_clip as j_convert
    from mvlpt_torch.checkpoint.convert import convert_hf_clip
    from mvlpt_torch.core import clip as clip_core

    params, cfg = convert_hf_clip(hf_clip, device="cpu")
    jparams, jcfg = j_convert(hf_clip)
    assert cfg.__dict__ == jcfg.__dict__
    got, want = _leaves(params), _leaves(jax.tree_util.tree_map(np.asarray, jparams))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
    assert params["logit_scale"].dtype == torch.float32 and params["logit_scale"].dim() == 0
    imgs = np.random.RandomState(1).randn(3, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        want_img = hf_clip.get_image_features(
            pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2)))
        got_img = clip_core.encode_image(params, torch.from_numpy(imgs), cfg)
    np.testing.assert_allclose(got_img.numpy(), want_img.numpy(), rtol=2e-4, atol=2e-4)
    with pytest.raises(TypeError, match="CLIPModel"):
        convert_hf_clip(hf_clip.state_dict(), device="cpu")


def _sha256(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_load_clip_by_name_from_a_seeded_cache(tmp_path, monkeypatch):
    """A model name resolves to ~/.cache/clip/<file>, checked against its
    sha256 (here the seeded file's own); a wrong digest raises; a missing
    file raises FileNotFoundError naming it, where the JAX package's
    load_clip would download (its _download is called with the URL)."""
    from mvlpt_tpu.checkpoint import convert as jconvert
    from mvlpt_torch.checkpoint import convert
    from tests.test_torch_port_checkpoint import _openai_state_dict

    monkeypatch.setenv("HOME", str(tmp_path))
    cache = tmp_path / ".cache" / "clip"
    cache.mkdir(parents=True)
    fname, _ = convert.OPENAI_VIT_FILES["ViT-B/16"]
    torch.save(_openai_state_dict(0), str(cache / fname))
    monkeypatch.setitem(convert.OPENAI_VIT_FILES, "ViT-B/16", (fname, _sha256(cache / fname)))
    by_name, cfg = convert.load_clip("ViT-B/16", device="cpu")
    by_path, cfg_path = convert.load_clip(str(cache / fname), device="cpu")
    assert cfg == cfg_path
    a, b = _leaves(by_name), _leaves(by_path)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    monkeypatch.setitem(convert.OPENAI_VIT_FILES, "ViT-B/16", (fname, "0" * 64))
    with pytest.raises(RuntimeError, match="sha256"):
        convert.load_clip("ViT-B/16", device="cpu")

    urls = []

    def no_download(url, root=None):
        urls.append(url)
        raise ConnectionError("downloads are refused in this test")

    monkeypatch.setattr(jconvert, "_download", no_download)
    with pytest.raises(ConnectionError):
        jconvert.load_clip("ViT-B/32")
    assert urls == [jconvert.OPENAI_MODELS["ViT-B/32"]]
    with pytest.raises(FileNotFoundError, match="ViT-B-32.pt"):
        convert.load_clip("ViT-B/32", device="cpu")
    with pytest.raises(FileNotFoundError, match="nope.pt"):
        convert.load_clip(str(tmp_path / "nope.pt"), device="cpu")
