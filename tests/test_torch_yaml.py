"""The port's YAML reader, writer and config helpers
(posteriflow_torch/utils/config.py) against PyYAML's safe_load and the JAX
package's posteriflow_tpu/utils/config.py.

The reader must give exactly what safe_load gives (YAML 1.1 resolution:
`1e-4` without a dot is a string, `3.0e-4` a float, yes/no/on/off bools)
on every configs/*.yaml and on generated scalar tokens, and refuse
anything outside its subset with a YAMLError naming the line. Exact
equality throughout (no tolerance: the values are parsed, not computed).
"""

import dataclasses
import json
import math
import re
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from posteriflow_torch.train.checkpoints import _cfg_to_dict
from posteriflow_torch.utils.config import (ConfigDict, YAMLError,
                                            dump_yaml, load_config,
                                            parse_yaml, save_config,
                                            to_train_config)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))


def _json(d: dict) -> dict:
    """JAX's dict with its nested tuples as JSON lists, as the port's."""
    return json.loads(json.dumps(d))


def test_all_twelve_configs_are_covered():
    assert len(CONFIGS) == 12


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_reader_equals_safe_load_on_configs(path):
    text = path.read_text()
    assert parse_yaml(text, str(path)) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_load_config_equals_jax(path):
    """The TrainConfig of each file, as a dict, is JAX's load_config's."""
    from posteriflow_tpu.train.checkpoints import _cfg_to_dict as j_dict
    from posteriflow_tpu.utils.config import load_config as j_load
    assert _cfg_to_dict(load_config(path)) == _json(j_dict(j_load(path)))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_save_config_round_trips_through_both_readers(path, tmp_path):
    cfg = load_config(path)
    out = tmp_path / "cfg.yaml"
    save_config(cfg, out)
    text = out.read_text()
    assert yaml.safe_load(text) == parse_yaml(text) == _cfg_to_dict(cfg)
    assert load_config(out) == cfg


def test_save_config_writes_floats_that_stay_floats(tmp_path):
    """1e-05 in Python's repr is a string to safe_load; the writer adds
    the dot as PyYAML's own representer does."""
    cfg = dataclasses.replace(load_config(CONFIGS[0]), lr=1e-5,
                              weight_decay=2.5e-7)
    text = dump_yaml(_cfg_to_dict(cfg))
    assert "lr: 1.0e-05" in text
    back = yaml.safe_load(text)
    assert back["lr"] == 1e-5 and back["weight_decay"] == 2.5e-7
    assert parse_yaml(text) == back


_EXP = st.sampled_from(["", "e-4", "e+5", "E-12", "e4", "e05"])
_FLOATS = st.builds(lambda s, a, dot, b, e: f"{s}{a}{dot}{b}{e}",
                    st.sampled_from(["", "-", "+"]),
                    st.sampled_from(["0", "1", "3", "10", "1_0", "25"]),
                    st.sampled_from([".", ""]),
                    st.sampled_from(["", "0", "5", "25", "0_1"]), _EXP)
_INTS = st.builds(lambda s, d: f"{s}{d}", st.sampled_from(["", "-", "+"]),
                  st.sampled_from(["0", "7", "42", "017", "09", "0x1F",
                                   "0b101", "1_000", "1:30", "190:20:30"]))
_WORDS = st.sampled_from(
    ["yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE", "false",
     "False", "FALSE", "on", "On", "ON", "off", "Off", "OFF", "y", "n",
     "yEs", "~", "null", "Null", "NULL", "nULL", ".inf", "-.inf", "+.Inf",
     ".NaN", ".nan", "nan", "inf", "coherent", "bfloat16", "mass_1",
     "1.0.0", ".5", "-.5", "1.", "1e", "0o17", "abc#def"])


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def _exotic_number(token: str, value) -> bool:
    """safe_load built a number from a base prefix, base 60 or `_`
    separators: forms no config uses, which the reader refuses."""
    return (isinstance(value, (int, float)) and not isinstance(value, bool)
            and re.search(r"^[-+]?(?:0b|0x|0[0-9_])|[_:]", token) is not None)


@settings(max_examples=300, deadline=None)
@given(token=st.one_of(_FLOATS, _INTS, _WORDS))
def test_scalar_tokens_resolve_as_safe_load(token):
    """Floats with and without a dot and with exponents, ints with signs,
    the bools of YAML 1.1, null, plain words: as a value and inside a flow
    sequence, as safe_load resolves them. A number in a base, base 60 or
    with `_` separators raises naming its line instead."""
    for doc, get in ((f"k: {token}\n", lambda d: d["k"]),
                     (f"k: [{token}, x]\n", lambda d: d["k"][0])):
        ref = get(yaml.safe_load(doc))
        if _exotic_number(token, ref):
            with pytest.raises(YAMLError, match=":1:"):
                parse_yaml(doc)
        else:
            assert _same(get(parse_yaml(doc)), ref), (doc, ref)


def test_flow_sequences_span_lines_with_comments():
    text = ("# head\n"
            "a:\n"
            "  names: [m1, 'm 2',   # trailing\n"
            "          3.0e-4, [1, 2],\n"
            "          ]\n"
            "  b: x#y  # a # inside a plain scalar stays\n"
            "c:\n"
            "d: ''\n")
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text, line", [
    ("a: &x 1\n", 1), ("a: *x\n", 1), ("a: !!float 1\n", 1),
    ("a: |\n  text\n", 1), ("a: >\n  text\n", 1), ("a:\n  - 1\n", 2),
    ("a: {b: 1}\n", 1), ("a: \"x\\ty\"\n", 1), ("a: b\n  c\n", 2),
    ("---\na: 1\n", 1), ("a: 2001-12-14\n", 1), ("<<: 1\n", 1),
    ("a:\n\tb: 1\n", 2), ("a: [1, 2\n", 1), ("a: [1,, 2]\n", 1),
    ("a: b: c\n", 1), ("a:\n    b: 1\n  c: 2\n", 3), ("a: 'x\n", 1)])
def test_outside_the_subset_raises_and_names_the_line(text, line):
    with pytest.raises(YAMLError, match=f":{line}:"):
        parse_yaml(text)


def test_config_dict_dot_access_and_get_path():
    d = ConfigDict(parse_yaml(CONFIGS[0].read_text()))
    assert d.npe.flow_bins == d["npe"]["flow_bins"]
    assert d.get_path("sim.prior.max_signals") == \
        d["sim"]["prior"]["max_signals"]
    assert d.get_path("sim.nope", 7) == 7
    with pytest.raises(AttributeError):
        d.nope


def test_to_train_config_equals_jax_and_rejects_unknown_keys():
    from posteriflow_tpu.train.checkpoints import _cfg_to_dict as j_dict
    from posteriflow_tpu.utils.config import to_train_config as j_to
    over = {"lr": 2.0e-4, "sim": {"glitch_prob": 0.1}}
    assert _cfg_to_dict(to_train_config(over)) == _json(j_dict(j_to(over)))
    with pytest.raises(KeyError):
        to_train_config({"nope": 1})


def test_flagship_yaml_matches_the_release_but_lr_and_steps():
    """configs/npe_r6.yaml is the flagship's config: its TrainConfig is
    npe_r7_best's meta.json but for lr and total_steps."""
    a = load_config(ROOT / "configs" / "npe_r6.yaml")
    b = load_config(ROOT / "model_release" / "npe_r7_best")
    assert (a.lr, a.total_steps) != (b.lr, b.total_steps)
    assert dataclasses.replace(a, lr=b.lr, total_steps=b.total_steps) == b


def test_bench_tool_model_and_sim_from_yaml_equal_the_release_meta():
    """tools/bench.py reads configs/npe_r6.yaml as bench.py does; its model
    and SimConfig are those of the release meta it read before."""
    from posteriflow_torch.physics.simulator import sim_config_from_dict
    from posteriflow_torch.tools.bench import bench_config
    from posteriflow_torch.train.checkpoints import load_release
    release = ROOT / "model_release" / "npe_r7_best"
    _, npe, sim = bench_config(release)
    _, rel_npe, meta = load_release(release)
    assert npe == rel_npe
    assert sim == sim_config_from_dict(meta["config"]["sim"])
    with pytest.raises(ValueError):
        bench_config(ROOT / "model_release" / "npe_r2_best")
