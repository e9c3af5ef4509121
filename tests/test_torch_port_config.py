"""The port's config (``mvlpt_torch/config``) against the JAX package's:
its YAML reader against PyYAML's ``safe_load`` on every file under
configs/, its writer against ``safe_dump``, the defaults, the merge order
and the value coercion against the JAX ``CfgNode``, and what
``validate_support`` refuses."""

from pathlib import Path

import pytest
import yaml

from mvlpt_tpu.config import get_cfg_default as j_defaults
from mvlpt_tpu.config.defaults import validate_support as j_validate
from mvlpt_tpu.config.config import _coerce as j_coerce

from mvlpt_torch.config import dump_yaml, get_cfg_default, load_yaml, validate_support
from mvlpt_torch.config.config import _coerce

ROOT = Path(__file__).resolve().parent.parent
CONFIG_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.yaml"))


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_yaml_reader_matches_safe_load(name):
    text = (ROOT / name).read_text()
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_merged_config_matches_jax(name):
    """Each file merged into the defaults, as the CLI merges it: the same
    tree, and the same dump (the CLI prints it)."""
    cfg, jcfg = get_cfg_default(), j_defaults()
    cfg.merge_from_file(str(ROOT / name))
    jcfg.merge_from_file(str(ROOT / name))
    assert cfg == jcfg
    assert cfg.dump() == jcfg.dump()


SNIPPETS = [
    "A: on\nB: off\nC: Yes\nD: NO\nE: TRUE\nF: y\n",
    "LR: 1e-5\nX: 2.0e-3\nY: .5\nZ: -3\nW: 0x1F\nV: 010\nU: 1_000\nT: +7\nS: .inf\nR: -.Inf\n",
    "SIZE: (224, 224)\nNAME: \"ViT-B/16\"\nQ: 'it''s'\nE: \"a\\tb\\\"c\"\n",
    "# a comment\nTOP:   # trailing comment\n  INNER:\n    LIST: [1, 'two', 3.0, on]  # x\n"
    "  EMPTY: []\n  MAP: {a: 1, b: [x, y]}\n  NONE: ~\n  NULL2: null\n  BLANK:\n",
    "SEQ:\n- a\n- 1\n- [2, 3]\n-\n  - nested\nNEXT: 'has # hash'\nURL: a#b\n",
    "K:\n  - x\n  - y\nL: value with spaces\nM: 'quoted: colon'\n",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_yaml_reader_matches_safe_load_on_the_subset(text):
    assert load_yaml(text) == yaml.safe_load(text)


def test_yaml_writer_matches_safe_dump():
    tree = {"A": {"B": [1, 2.5, "x"], "C": (0.08, 1.0), "D": "", "E": "on", "F": None,
                  "G": 1e-05, "H": "ViT-B/16", "I": [], "J": "a: b", "K": "-x", "L": True},
            "M": {}, "N": "1e-5", "O": "(224, 224)", "P": 3}
    assert dump_yaml(tree) == yaml.safe_dump(tree, sort_keys=False)
    assert load_yaml(dump_yaml(tree)) == yaml.safe_load(yaml.safe_dump(tree, sort_keys=False))


def test_defaults_match_jax():
    cfg, jcfg = get_cfg_default(), j_defaults()
    assert cfg == jcfg
    for key in ("TRAIN.STEPS_PER_DISPATCH", "TRAIN.WINDOW_MIN_TAIL", "TPU.DEVICE_NORMALIZE",
                "TPU.PRE_EMBED_WINDOW"):
        a, b = key.split(".")
        assert cfg[a][b] == jcfg[a][b]


COERCE = [("(224, 224)", (1, 1)), ("2e-3", 0.1), ("5", 0.1), ("True", False), ("yes", False),
          ("abc", "x"), ("[1, 2]", (0,)), ("None", None), (3, 0.5), ("'quoted'", "x"),
          ("('a', 'b')", ()), ("off", True), ([1, 2], (0,)), ("1", 2)]


@pytest.mark.parametrize("value,old", COERCE)
def test_coerce_matches_jax(value, old):
    got, want = _coerce(value, old), j_coerce(value, old)
    assert got == want and type(got) is type(want)


def test_merge_order_and_list_merge_match_jax():
    """dataset yaml < trainer yaml < opts, as the CLI merges them."""
    opts = ["OPTIM.LR", "0.05", "INPUT.SIZE", "(32, 32)", "TPU.USE_PALLAS", "off",
            "TRAIN.STEPS_PER_DISPATCH", "20", "TEST.NO_TEST", "True",
            "INPUT.TRANSFORMS", "('random_resized_crop', 'random_flip', 'normalize')",
            "DATASET.NAME", "Caltech101"]
    trees = []
    for make in (get_cfg_default, j_defaults):
        cfg = make()
        cfg.merge_from_file(str(ROOT / "configs/datasets/oxford_pets.yaml"))
        cfg.merge_from_file(str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml"))
        cfg.merge_from_list(opts)
        cfg.freeze()
        trees.append(cfg)
    assert trees[0] == trees[1]
    assert trees[0].OPTIM.LR == 0.05 and trees[0].INPUT.SIZE == (32, 32)
    assert trees[0].DATASET.NAME == "Caltech101" and trees[0].TPU.DEVICE_NORMALIZE is True


@pytest.mark.parametrize("make", [get_cfg_default, j_defaults], ids=["port", "jax"])
def test_frozen_and_unknown_keys_raise(make, tmp_path):
    """The same errors from both packages: unknown keys in a list or a
    file, any write to a frozen config; a clone is independent."""
    cfg = make()
    with pytest.raises(KeyError):
        cfg.merge_from_list(["OPTIM.NOPE", "1"])
    bad = tmp_path / "bad.yaml"
    bad.write_text("OPTIM:\n  NOPE: 1\n")
    with pytest.raises(KeyError):
        cfg.merge_from_file(str(bad))
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.merge_from_list(["OPTIM.LR", "0.1"])
    with pytest.raises(AttributeError):
        cfg.OPTIM.LR = 0.1
    clone = cfg.clone()
    clone.defrost()
    clone.OPTIM.LR = 0.1
    assert cfg.OPTIM.LR != 0.1 and clone.OPTIM.LR == 0.1


@pytest.mark.parametrize("opts,item", [
    (["TPU.MESH_MODEL", "2"], "item 8"),
    (["TPU.MESH_DATA", "4"], "item 8"),
    (["DATALOADER.BACKEND", "tf"], "tfdata"),
])
def test_validate_support_names_the_roadmap_item(opts, item):
    cfg = get_cfg_default()
    cfg.merge_from_list(["TRAINER.NAME", "MVLPT", "DATASET.COOP", "True"] + opts)
    with pytest.raises(NotImplementedError, match=item):
        validate_support(cfg)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_validate_support_passes_the_data_backends(backend):
    """The "python" and "native" data backends run (Queue 1, item 9); the
    JAX package passes both too."""
    for make in (get_cfg_default, j_defaults):
        cfg = make()
        cfg.merge_from_list(["TRAINER.NAME", "MVLPT", "DATASET.COOP", "True",
                             "DATALOADER.BACKEND", backend])
        (validate_support if make is get_cfg_default else j_validate)(cfg)


@pytest.mark.parametrize("opts", [
    ["OPTIM.NAME", "adam"],
    ["TRAINER.MVLPT.VPT.DROPOUT", "0.1"],
    ["OPTIM.NAME", "adamw"],
    ["OPTIM.NAME", "rmsprop"],
], ids=["adam", "vpt-dropout", "adamw", "rmsprop"])
def test_validate_support_passes_item_11(opts):
    """The optimizers and VPT dropout of Queue 1 item 11 run: both packages
    pass them, as they pass the flagship."""
    cfg = get_cfg_default()
    cfg.merge_from_list(["TRAINER.NAME", "MVLPT", "DATASET.COOP", "True"] + opts)
    validate_support(cfg)
    j_cfg = j_defaults()
    j_cfg.merge_from_list(["TRAINER.NAME", "MVLPT", "DATASET.COOP", "True"] + opts)
    j_validate(j_cfg)


@pytest.mark.parametrize("opts", [["TRAINER.NAME", "CoCoOp"],
                                  ["TRAINER.MVLPT.COCOOP.N_CTX", "4"]],
                         ids=["cocoop-trainer", "mvlpt-cocoop-ctx"])
def test_validate_support_passes_cocoop(opts):
    """CoCoOp runs (Queue 1 item 6): the CoCoOp trainer and the MVLPT
    trainer with a conditioned context pass, as in the JAX package."""
    cfg = get_cfg_default()
    cfg.merge_from_list(["TRAINER.NAME", "MVLPT", "DATASET.COOP", "True"] + opts)
    validate_support(cfg)
    j_cfg = j_defaults()
    j_cfg.merge_from_list(["TRAINER.NAME", "MVLPT", "DATASET.COOP", "True"] + opts)
    j_validate(j_cfg)


def test_validate_support_passes_the_flagship_and_keeps_jax_checks():
    cfg = get_cfg_default()
    cfg.merge_from_file(str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml"))
    cfg.merge_from_list(["TRAINER.NAME", "MVLPT", "DATASET.COOP", "True"])
    validate_support(cfg)
    cfg.merge_from_list(["DATALOADER.K_TRANSFORMS", "2"])
    with pytest.raises(NotImplementedError, match="K_TRANSFORMS"):
        validate_support(cfg)


def test_validate_support_passes_elevater_and_remat():
    """What the ELEVATER scripts set (scripts/mvlpt/main_mt_elevater_cut.sh,
    main_single_elevater_cut.sh, zeroshot.sh): no --dataset-coop,
    --multi-task, --act-ckpt 4, the zero-shot trainers."""
    for opts in (["TRAINER.NAME", "MVLPT", "DATASET.MULTITASK", "True",
                  "DATASET.MULTITASK_LABEL_PERTASK", "True", "TRAINER.ACT_CKPT", "4"],
                 ["TRAINER.NAME", "MVLPT", "TRAINER.ACT_CKPT", "4"],
                 ["TRAINER.NAME", "ZeroshotCLIP", "DATASET.COOP", "True"],
                 ["TRAINER.NAME", "ZeroshotCLIP2"]):
        cfg = get_cfg_default()
        cfg.merge_from_file(str(ROOT / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml"))
        cfg.merge_from_list(opts)
        validate_support(cfg)
