"""The port's YAML reader / writer (``tvc_torch/_yaml.py``) against PyYAML's
``safe_load`` on every file under ``configs/`` and on YAML 1.1's scalar
corner cases, and the port's config loader (``tvc_torch/config``) against
the JAX package's on every experiment config."""

import math
from pathlib import Path

import pytest
import yaml

from tvc.config import Config as JConfig, ConfigLoader as JConfigLoader
from tvc_torch import _yaml
from tvc_torch.config import (
    Config,
    ConfigLoader,
    apply_overrides,
    deep_merge,
    get_by_path,
    get_config,
)

REPO = Path(__file__).resolve().parent.parent
CONFIG_FILES = sorted(str(p.relative_to(REPO / "configs")) for p in (REPO / "configs").rglob("*.yaml"))
EXPERIMENTS = [f for f in CONFIG_FILES if f.startswith("experiments/")]


def test_configs_hold_the_46_files():
    assert len(CONFIG_FILES) == 46 and len(EXPERIMENTS) == 26


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_reader_equals_safe_load(name):
    text = (REPO / "configs" / name).read_text()
    assert _yaml.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_writer_output_loads_back_equal(name):
    data = yaml.safe_load((REPO / "configs" / name).read_text())
    text = _yaml.dump(data)
    assert yaml.safe_load(text) == data
    assert _yaml.load(text) == data


SCALARS = (
    "1e-5", "1.0e-5", "1.0e5", "1E-5", "-1.5e+3", "1.", ".5", "-.5", "0.", "3.14_15",
    "yes", "Yes", "YES", "no", "on", "Off", "y", "n", "true", "False", "TRUE",
    "~", "null", "Null", "NULL", "", "-1", "+1", "0", "-0", "00", "017", "0o17", "0x1f", "0b101", "1_000",
    "1:30", "-1:30:15", "1:30.5", ".inf", "-.inf", "+.INF", ".nan", ".NaN",
    "'5'", '"5"', "'yes'", '"1e-5"', "'it''s'", '"a\\tb\\u00e9\\x41"', "ViT-B/32", "a b  c", "x#y",
    "[]", "{}", "[a, 'b', 1, -1, 1.0e-5, yes, ~]", "[[1, 2], [3]]", "{a: 1, b: [x, 'y'], c: {d: e}}",
    "[a, b, ]", "{a, b: 2}", "{a: }",
)


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_safe_load(text):
    want, got = yaml.safe_load(text), _yaml.load(text)
    if isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    else:
        assert got == want and type(got) is type(want)
    doc = f"k: {text}\nl:\n- {text}\n"
    if not (isinstance(want, float) and math.isnan(want)):
        assert _yaml.load(doc) == yaml.safe_load(doc)


BLOCKS = (
    "a:\n- 1\n- 2\nb: c",
    "a:\n  - 1\n  - 2",
    "- a: 1\n  b: 2\n- c\n- - d\n  - e",
    "a:\n  b:\n    c: [1, 2]\n  d: ~\ne:",
    "# head\n\na: 1  # tail\n'b c': \"d # e\"\n",
    "1: one\ntrue: yes\n",
    "- 1\n- two",
)


@pytest.mark.parametrize("text", BLOCKS)
def test_block_structure_as_safe_load(text):
    assert _yaml.load(text) == yaml.safe_load(text)


REFUSED = (
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x", "---\na: 1", "%YAML 1.1\n---\na: 1",
    "a: 2001-12-14", "? a\n: b", "a: b\n  c", "a: [1,\n 2]", "a: b: c", "<<: {a: 1}", "a:\n\t- 1",
    "a: 'open", "a: [1, 2", "a: [k: v]",
)


@pytest.mark.parametrize("text", REFUSED)
def test_reader_refuses_what_it_does_not_handle(text):
    with pytest.raises(_yaml.YAMLError):
        _yaml.load(text)


def test_writer_round_trips_every_scalar_kind():
    data = {
        "floats": [1e-5, 1.0, -0.5, 1e20, 3.0e-300, math.inf, -math.inf],
        "strings": ["yes", "no", "1e-5", "0x1", "x: y", "#c", "", " s", "a\nb", "é", "ViT-B/32", "TPU v5 lite",
                    "null", "~", "-", "[a]", "'q'", '"dq"', "a  b", "trailing "],
        "other": [None, True, False, 0, -7, 2**40],
        "nested": {"empty_map": {}, "empty_list": [], "lists": [[1, [2, 3]], {"k": [4]}], 1: "int key"},
        "tuple": (1, 2),
    }
    want = dict(data, tuple=[1, 2])
    text = _yaml.dump(data)
    assert yaml.safe_load(text) == want
    assert _yaml.load(text) == want
    assert _yaml.load(_yaml.dump([])) == [] and _yaml.load(_yaml.dump(None)) is None


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_loader_equals_jax_loader(name):
    assert ConfigLoader().load(name) == JConfigLoader().load(name)


def test_loader_semantics(tmp_path):
    (tmp_path / "base.yaml").write_text("a: {b: 1, c: [1, 2]}\nd: x\n")
    (tmp_path / "mid.yaml").write_text("inherits: base\na: {b: 2}\n")
    (tmp_path / "top.yaml").write_text("inherits: [mid.yaml]\noverrides:\n  a.c: [3]\n  d: y\n")
    for loader in (ConfigLoader(tmp_path), JConfigLoader(tmp_path)):
        assert loader.load("top.yaml") == {"a": {"b": 2, "c": [3]}, "d": "y"}
    (tmp_path / "x.yaml").write_text("inherits: [y.yaml]\n")
    (tmp_path / "y.yaml").write_text("inherits: [x.yaml]\n")
    with pytest.raises(ValueError, match="circular"):
        ConfigLoader(tmp_path).load("x.yaml")
    assert deep_merge({"a": {"b": 1}}, {"a": {"c": 2}}) == {"a": {"b": 1, "c": 2}}
    assert apply_overrides({"a": {"b": 1}}, {"a.b": 3, "e": 4}) == {"a": {"b": 3}, "e": 4}
    assert get_by_path({"a": {"b": 1}}, "a.b") == 1 and get_by_path({}, "a.b", 7) == 7


def test_save_yaml_loads_back_in_both(tmp_path):
    cfg = ConfigLoader().load("experiments/coco_pgd_full.yaml")
    path = tmp_path / "out" / "cfg.yaml"
    ConfigLoader().save_yaml(cfg, path)
    assert yaml.safe_load(path.read_text()) == cfg
    assert ConfigLoader().load_yaml(path) == JConfigLoader().load_yaml(path) == cfg


def test_config_facade_equals_jax():
    got, want = Config(), JConfig()
    assert got.data == want.data
    assert got.loader.config_dir == want.loader.config_dir == REPO / "configs"
    got.validate()
    exp = "experiments/efficiency_profile.yaml"
    assert got.load_experiment_config(exp) == want.load_experiment_config(exp)
    for accessor in ("get_dataset_config", "get_attack_config", "get_defense_config", "get_model_config"):
        assert getattr(got, accessor)() == getattr(want, accessor)()
    assert got.get("models.clip.default_model") == "ViT-B/32"
    assert get_config() is get_config()
