"""One config system: YAML or JSON <-> nested dict <-> TrainConfig.

Port of posteriflow_tpu/utils/config.py:19-63: the file's keys are merged
over TrainConfig()'s defaults, and a key the config does not have is an
error. The card's machine has no PyYAML, so the port reads YAML with its
own reader (`parse_yaml`) of the subset that `configs/*.yaml` use:

  - block maps by indentation (spaces only);
  - flow sequences `[a, b, [c]]`, which may span lines;
  - full-line and trailing comments;
  - plain scalars resolved as PyYAML's safe_load (YAML 1.1) resolves them:
    decimal ints with signs, floats only with a dot (`3.0e-4` is a float,
    `1e-4` a string; an exponent needs its sign), `.inf`/`.nan`, bools
    yes/no/on/off/true/false in three cases, null as `~`/null/Null/NULL/
    empty, everything else a string;
  - single-quoted strings (`''` for a quote) and double-quoted strings
    without backslash escapes.

Anything else (block sequences, flow maps, anchors, aliases, tags, block
scalars, multi-line plain scalars, document markers, timestamps, merge
keys, escapes, and numbers that safe_load would build from a base prefix,
base 60 or `_` separators) raises YAMLError naming the line: the reader
never guesses.
`save_config` writes YAML that both the reader and safe_load read back to
the same dict; a release's meta.json (or its directory) is read too.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any, List, Tuple

from posteriflow_torch.train.checkpoints import (_cfg_to_dict,
                                                 train_cfg_from_dict)
from posteriflow_torch.train.trainer import TrainConfig


class YAMLError(ValueError):
    pass


# PyYAML's implicit resolvers of YAML 1.1 (yaml/resolver.py), in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# resolved by PyYAML to types outside the subset (merge key, timestamp,
# the value tag): refused
_REFUSED = re.compile(r"""^(?:<<|=
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]
                     (?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?
                     (?::[0-9][0-9])?))?)$""", re.X)
# characters that may not start a plain scalar; `-`, `?` and `:` may when
# a non-space follows
_INDICATORS = set("[]{},#&*!|>'\"%@`")


# ints and floats that PyYAML builds from tokens the configs never hold:
# base prefixes (0b, 0-led octal, 0x), base 60 (`1:30`) and `_` separators
_EXOTIC = re.compile(r"^[-+]?(?:0b|0x|0[0-9_])|[_:]")


def resolve_scalar(token: str, where: str = "") -> Any:
    """A plain scalar -> its value as safe_load resolves it; a number
    written in a form the configs do not use raises."""
    if _BOOL.match(token):
        return token.lower() in ("yes", "true", "on")
    is_float = _FLOAT.match(token) is not None
    if is_float or _INT.match(token):
        if _EXOTIC.search(token):
            raise YAMLError(f"{where}: {token!r} is a number in a base, "
                            f"base 60 or with `_` separators, outside the "
                            f"YAML subset")
        if not is_float:
            return int(token)
        low = token.lower()
        if low.lstrip("+-") == ".inf":
            return -math.inf if low[0] == "-" else math.inf
        return math.nan if low == ".nan" else float(token)
    if _NULL.match(token):
        return None
    if _REFUSED.match(token):
        raise YAMLError(f"{where}: {token!r} is a merge key, timestamp or "
                        f"value tag, outside the YAML subset")
    return token


def _check_plain(token: str, where: str, flow: bool):
    """Refuse a plain scalar that YAML would read as something else."""
    if not token:
        return
    c0, c1 = token[0], token[1:2]
    if c0 in _INDICATORS or (c0 in "-?:" and c1 in ("", " ")):
        raise YAMLError(f"{where}: {token!r} starts with an indicator "
                        f"outside the YAML subset")
    if ": " in token or token.endswith(":") or "\t" in token:
        raise YAMLError(f"{where}: {token!r} holds a mapping indicator")
    if flow and any(c in token for c in ",[]{}"):
        raise YAMLError(f"{where}: {token!r} holds a flow indicator")


def _strip_comment(line: str, where: str) -> str:
    """The line without its comment: a `#` at the start or after a space,
    outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    if quote:
        raise YAMLError(f"{where}: a quoted scalar that does not end on its "
                        f"line is outside the YAML subset")
    return line.rstrip()


def _quoted(text: str, i: int, where: str) -> Tuple[str, int]:
    """The quoted scalar starting at text[i] -> (its value, the index after
    its closing quote)."""
    q = text[i]
    out, j = [], i + 1
    while j < len(text):
        c = text[j]
        if c == q:
            if q == "'" and text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            raise YAMLError(f"{where}: escapes in double-quoted scalars are "
                            f"outside the YAML subset")
        out.append(c)
        j += 1
    raise YAMLError(f"{where}: unterminated quoted scalar")


def _scalar(token: str, where: str, flow: bool = False) -> Any:
    """A block or flow scalar token (plain or quoted) -> its value."""
    token = token.strip()
    if token[:1] in ("'", '"'):
        value, end = _quoted(token, 0, where)
        if token[end:].strip():
            raise YAMLError(f"{where}: text after a quoted scalar")
        return value
    _check_plain(token, where, flow)
    return resolve_scalar(token, where)


def _flow_seq(text: str, i: int, where: str) -> Tuple[list, int]:
    """The flow sequence starting at text[i] == '[' -> (list, index after
    its ']')."""
    out, i = [], i + 1
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise YAMLError(f"{where}: unterminated flow sequence")
        c = text[i]
        if c == "]":
            return out, i + 1
        if c == "[":
            item, i = _flow_seq(text, i, where)
        elif c in "'\"":
            item, i = _quoted(text, i, where)
        elif c == "{":
            raise YAMLError(f"{where}: flow mappings are outside the YAML "
                            f"subset")
        elif c == ",":
            raise YAMLError(f"{where}: an empty entry in a flow sequence")
        else:
            j = i
            while j < len(text) and text[j] not in ",]":
                j += 1
            item, i = _scalar(text[i:j], where, flow=True), j
        out.append(item)
        while i < len(text) and text[i] == " ":
            i += 1
        if i < len(text) and text[i] == ",":
            i += 1
        elif i >= len(text) or text[i] != "]":
            raise YAMLError(f"{where}: expected ',' or ']' in a flow "
                            f"sequence")


def _split_key(content: str, where: str) -> Tuple[Any, str]:
    """`key: rest` -> (key, rest)."""
    if content[:1] in ("'", '"'):
        key, end = _quoted(content, 0, where)
        rest = content[end:]
        if not (rest == ":" or rest.startswith(": ")):
            raise YAMLError(f"{where}: expected ':' after a quoted key")
        return key, rest[1:].strip()
    m = re.search(r":( |$)", content)
    if m is None:
        raise YAMLError(f"{where}: {content!r} is not `key: value` (block "
                        f"sequences and multi-line scalars are outside the "
                        f"YAML subset)")
    key = content[:m.start()]
    if key.startswith("- ") or key == "-":
        raise YAMLError(f"{where}: block sequences are outside the YAML "
                        f"subset")
    return _scalar(key, where), content[m.end():].strip()


def parse_yaml(text: str, source: str = "<yaml>"):
    """YAML text in the subset above -> the dict safe_load gives (None for
    a document with no content)."""
    lines: List[Tuple[int, str, int]] = []      # (indent, content, lineno)
    for no, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{no}"
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise YAMLError(f"{where}: tabs in indentation")
        content = _strip_comment(body, where)
        if not content:
            continue
        if raw.startswith(("---", "...", "%")):
            raise YAMLError(f"{where}: document markers and directives are "
                            f"outside the YAML subset")
        lines.append((len(raw) - len(body), content, no))
    if not lines:
        return None
    value, i = _block_map(lines, 0, lines[0][0], source)
    if i < len(lines):
        raise YAMLError(f"{source}:{lines[i][2]}: bad indentation")
    return value


def _block_map(lines, i: int, indent: int, source: str) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        _, content, no = lines[i]
        where = f"{source}:{no}"
        key, rest = _split_key(content, where)
        i += 1
        if rest == "":
            if i < len(lines) and lines[i][0] > indent:
                value, i = _block_map(lines, i, lines[i][0], source)
            else:
                value = None
        elif rest[0] == "[":
            text = rest
            while _depth(text) > 0:
                if i >= len(lines) or lines[i][0] <= indent:
                    raise YAMLError(f"{where}: unterminated flow sequence")
                text += " " + lines[i][1]
                i += 1
            value, end = _flow_seq(text, 0, where)
            if text[end:].strip():
                raise YAMLError(f"{where}: text after a flow sequence")
        else:
            if rest[0] in "|>&*!{":
                raise YAMLError(f"{where}: block scalars, anchors, aliases, "
                                f"tags and flow maps are outside the YAML "
                                f"subset")
            value = _scalar(rest, where)
            if i < len(lines) and lines[i][0] > indent:
                raise YAMLError(f"{source}:{lines[i][2]}: multi-line plain "
                                f"scalars are outside the YAML subset")
        out[key] = value
    if i < len(lines) and lines[i][0] > indent:
        raise YAMLError(f"{source}:{lines[i][2]}: bad indentation")
    return out, i


def _depth(text: str) -> int:
    """'[' minus ']' outside quotes."""
    depth, quote = 0, None
    for c in text:
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
    return depth


def _dump_scalar(v) -> str:
    """A value -> a token that both safe_load and parse_yaml read back as
    `v` (floats as PyYAML's represent_float writes them: `1e-05` would be
    a string, `1.0e-05` is a float)."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r
    if isinstance(v, str):
        if "\n" in v:
            raise YAMLError(f"cannot write the multi-line string {v!r}")
        try:
            _check_plain(v, "", flow=True)
            plain = v == v.strip() and resolve_scalar(v) == v
        except YAMLError:
            plain = False
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise YAMLError(f"cannot write {type(v).__name__} as YAML")


def _dump_flow(v) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_flow(x) for x in v) + "]"
    return _dump_scalar(v)


def dump_yaml(d: dict, indent: int = 0) -> str:
    """A nested dict -> block-map YAML (lists as flow sequences)."""
    pad, out = " " * indent, []
    for k, v in d.items():
        key = _dump_scalar(k)
        if isinstance(v, dict):
            if not v:
                raise YAMLError(f"cannot write the empty map {k!r}")
            out.append(f"{pad}{key}:\n{dump_yaml(v, indent + 2)}")
        else:
            out.append(f"{pad}{key}: {_dump_flow(v)}\n")
    return "".join(out)


class ConfigDict(dict):
    """Nested dict with attribute/dot access."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return ConfigDict(v) if isinstance(v, dict) else v

    def get_path(self, dotted: str, default: Any = None):
        cur: Any = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur


def load_config(path) -> TrainConfig:
    """A YAML or JSON TrainConfig (or overrides of it), a release's
    meta.json, or a release directory -> TrainConfig."""
    p = Path(path)
    if p.is_dir():
        p = p / "meta.json"
    if p.suffix in (".yaml", ".yml"):
        raw = parse_yaml(p.read_text(), source=str(p))
    else:
        raw = json.loads(p.read_text())
    raw = raw or {}
    if isinstance(raw.get("config"), dict):          # a release's meta.json
        raw = raw["config"]
    return to_train_config(raw)


def save_config(cfg: TrainConfig, path):
    """Write `cfg` as YAML that safe_load and load_config read back."""
    Path(path).write_text(dump_yaml(_cfg_to_dict(cfg)))


def to_train_config(d: dict) -> TrainConfig:
    return train_cfg_from_dict(_deep_merge(_cfg_to_dict(TrainConfig()), d))


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k not in out:
            raise KeyError(f"unknown config key: {k!r} "
                           f"(valid: {sorted(out)})")
        if isinstance(v, dict) and isinstance(out[k], dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
