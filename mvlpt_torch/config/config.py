"""Hierarchical config (the yacs surface the trainer needs), and a reader
and writer for the YAML the config files use.

The counterpart of ``mvlpt_tpu/config/config.py``: attribute access,
YAML merge, dotted-key list merge, freeze/clone, with the same value
coercion, so the repo's ``configs/`` files and ``KEY.SUBKEY value``
override lists work unchanged. The GPU host has no PyYAML, so
:func:`load_yaml` reads the YAML subset of ``configs/`` itself, with
PyYAML ``safe_load``'s YAML 1.1 scalar rules (``on`` is True, ``1e-5``
and ``(224, 224)`` stay strings), and :func:`dump_yaml` writes what
``yaml.safe_dump(..., sort_keys=False)`` writes for a config tree.
"""

from __future__ import annotations

import ast
import copy
import math
import re


class CfgNode(dict):
    """A dict with attribute access, freezing, and recursive merging."""

    _FROZEN = "__frozen__"

    def __init__(self, init_dict=None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if getattr(self, CfgNode._FROZEN):
            raise AttributeError(f"Cannot set {name}: CfgNode is frozen")
        self[name] = value

    def __setitem__(self, key, value):
        # enforced here (not just __setattr__) so the merges also raise
        # on a frozen config, as yacs does
        if getattr(self, CfgNode._FROZEN, False):
            raise AttributeError(f"Cannot set {key}: CfgNode is frozen")
        super().__setitem__(key, value)

    # -- freezing ----------------------------------------------------------
    def freeze(self):
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self):
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self):
        return getattr(self, CfgNode._FROZEN)

    def clone(self):
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = CfgNode()
        for k, v in self.items():
            out[k] = copy.deepcopy(v, memo)
        return out

    # -- merging -----------------------------------------------------------
    def merge_from_file(self, path: str):
        with open(path) as f:
            loaded = load_yaml(f.read())
        if loaded:
            _merge_into(CfgNode(loaded), self, strict=True)

    def merge_from_list(self, opts):
        if not opts:
            return
        if len(opts) % 2:
            raise ValueError(f"Override list must be key/value pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(value, node[leaf])

    def dump(self) -> str:
        return dump_yaml(_to_plain(self))


def _to_plain(node):
    if isinstance(node, CfgNode):
        return {k: _to_plain(v) for k, v in node.items()}
    return node


def _merge_into(src: CfgNode, dst: CfgNode, strict: bool = False, prefix: str = ""):
    for k, v in src.items():
        if strict and k not in dst:
            # yacs raises on non-existent keys so yaml typos fail loudly
            raise KeyError(f"Non-existent config key: {prefix}{k}")
        if isinstance(v, (CfgNode, dict)) and isinstance(dst.get(k), CfgNode):
            _merge_into(CfgNode(v) if not isinstance(v, CfgNode) else v,
                        dst[k], strict=strict, prefix=f"{prefix}{k}.")
        else:
            dst[k] = _coerce(v, dst.get(k))


def _coerce(value, old):
    """Coerce a yaml/CLI value to the type of the existing default."""
    if isinstance(value, str):
        # yacs-style: strings that parse as python literals become them,
        # so `INPUT.SIZE "(224, 224)"` and `OPTIM.LR 2e-3` both work.
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    if old is None or value is None:
        return value
    if isinstance(old, bool) and isinstance(value, str):
        return value.lower() in ("true", "1", "yes")
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    return value


# --- YAML: the subset the config files use -----------------------------------
#
# Block mappings by indentation, block sequences ("- item"), flow
# sequences and mappings ([a, b], {k: v}), plain, single- and
# double-quoted scalars, and comments. Plain scalars resolve as PyYAML's
# SafeLoader resolves them (YAML 1.1).

_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
         "OFF": False}
_NULL = ("~", "null", "Null", "NULL", "")
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


def _sexagesimal(digits: str, last: float | int):
    value = 0
    for part in digits.split(":")[:-1]:
        value = value * 60 + int(part)
    return value * 60 + last


def _resolve_plain(text: str):
    """A plain scalar's value, by SafeLoader's implicit resolvers."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        sign, body = (-1, text[1:]) if text[0] == "-" else (1, text.lstrip("+"))
        body = body.replace("_", "")
        if body == "0":
            return 0
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body.startswith("0"):
            return sign * int(body, 8)
        if ":" in body:
            return sign * _sexagesimal(body, int(body.split(":")[-1]))
        return sign * int(body)
    if _FLOAT.match(text):
        body = text.replace("_", "").lower()
        sign, body = (-1.0, body[1:]) if body[0] == "-" else (1.0, body.lstrip("+"))
        if body == ".inf":
            return sign * math.inf
        if body == ".nan":
            return math.nan
        if ":" in body:
            return sign * _sexagesimal(body, float(body.split(":")[-1]))
        return sign * float(body)
    return text


class _Lines:
    """The document's lines with comments and blank lines dropped, as
    (indent, text) pairs."""

    def __init__(self, text: str):
        self.items = []
        for raw in text.splitlines():
            line = _strip_comment(raw).rstrip()
            if line.strip() and line.strip() not in ("---", "..."):
                if "\t" in line[: len(line) - len(line.lstrip())]:
                    raise ValueError(f"yaml: tab in indentation: {raw!r}")
                self.items.append((len(line) - len(line.lstrip(" ")), line.strip()))
        self.pos = 0

    def peek(self):
        return self.items[self.pos] if self.pos < len(self.items) else None


def _strip_comment(line: str) -> str:
    """The line up to a ``#`` that starts a comment (outside quotes, at the
    line's start or after whitespace)."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _split_key(text: str):
    """(key, rest) of a ``key: rest`` line, or None when it has no
    mapping colon."""
    if text[0] in "'\"":
        value, end = _quoted(text, 0)
        rest = text[end:].lstrip()
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return value, rest[1:].strip()
        return None
    m = re.search(r":(?: |$)", text)
    if m is None:
        return None
    return _resolve_plain(text[: m.start()].rstrip()), text[m.end():].strip()


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", '"': '"', "\\": "\\", "/": "/",
            " ": " ", "a": "\a", "b": "\b", "e": "\x1b", "f": "\f", "v": "\v"}


def _quoted(text: str, i: int):
    """(value, index past it) of the quoted scalar starting at text[i]."""
    q, out, i = text[i], [], i + 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            nxt = text[i + 1]
            if nxt in "xuU":
                width = {"x": 2, "u": 4, "U": 8}[nxt]
                out.append(chr(int(text[i + 2:i + 2 + width], 16)))
                i += 2 + width
                continue
            out.append(_ESCAPES[nxt])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise ValueError(f"yaml: unterminated quoted scalar in {text!r}")


def _flow(text: str, i: int):
    """(value, index past it) of the flow node at text[i]."""
    while text[i] == " ":
        i += 1
    c = text[i]
    if c in "'\"":
        return _quoted(text, i)
    if c in "[{":
        close, seq, out = ("]", True, []) if c == "[" else ("}", False, {})
        i += 1
        while True:
            while text[i] == " ":
                i += 1
            if text[i] == close:
                return out, i + 1
            if seq:
                value, i = _flow(text, i)
                out.append(value)
            else:
                key, i = _flow(text, i)
                while text[i] == " ":
                    i += 1
                if text[i] != ":":
                    raise ValueError(f"yaml: expected ':' in flow mapping {text!r}")
                value, i = _flow(text, i + 1)
                out[key] = value
            while text[i] == " ":
                i += 1
            if text[i] == ",":
                i += 1
            elif text[i] != close:
                raise ValueError(f"yaml: expected ',' or {close!r} in {text!r}")
    j = i
    while j < len(text) and text[j] not in ",]}" and not (text[j] == ":" and
                                                          text[j + 1:j + 2] in (" ", "")):
        j += 1
    return _resolve_plain(text[i:j].strip()), j


def _scalar_or_flow(text: str):
    if text[0] in "[{'\"":
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"yaml: trailing text after {text!r}")
        return value
    if text[0] in "|>&*!%@`":
        raise ValueError(f"yaml: unsupported node {text!r}")
    return _resolve_plain(text)


def _block(lines: _Lines, indent: int):
    """The block node whose lines sit at ``indent``."""
    first = lines.peek()
    if first[1].startswith("- ") or first[1] == "-":
        out = []
        while (cur := lines.peek()) is not None and cur[0] == indent and (
                cur[1].startswith("- ") or cur[1] == "-"):
            lines.pos += 1
            rest = cur[1][1:].strip()
            if rest and rest[0] not in "[{'\"" and _split_key(rest) is not None:
                raise ValueError(f"yaml: mappings in block sequences are not read: {rest!r}")
            if rest:
                out.append(_scalar_or_flow(rest))
            else:
                nxt = lines.peek()
                out.append(_block(lines, nxt[0]) if nxt and nxt[0] > indent else None)
        return out
    out = {}
    while (cur := lines.peek()) is not None and cur[0] == indent:
        kv = _split_key(cur[1])
        if kv is None:
            raise ValueError(f"yaml: expected 'key: value', got {cur[1]!r}")
        key, rest = kv
        lines.pos += 1
        if rest:
            out[key] = _scalar_or_flow(rest)
            continue
        nxt = lines.peek()
        if nxt is not None and (nxt[0] > indent or (nxt[0] == indent and (
                nxt[1].startswith("- ") or nxt[1] == "-"))):
            out[key] = _block(lines, nxt[0])
        else:
            out[key] = None
    return out


def load_yaml(text: str):
    """The document of ``text``, as ``yaml.safe_load`` reads it (for the
    subset above; anything else raises ValueError)."""
    lines = _Lines(text)
    if lines.peek() is None:
        return None
    first = lines.peek()
    if first[0] == 0 and _split_key(first[1]) is None and not first[1].startswith("-"):
        lines.pos += 1
        value = _scalar_or_flow(first[1])
    else:
        value = _block(lines, first[0])
    if lines.peek() is not None:
        raise ValueError(f"yaml: unexpected indentation at {lines.peek()[1]!r}")
    return value


# --- writing ---------------------------------------------------------------

_PLAIN_UNSAFE_START = set(",[]{}#&*!|>'\"%@`")


def _scalar_text(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        plain = (value and value == value.strip() and value[0] not in _PLAIN_UNSAFE_START
                 and not (value[0] in "-?:" and value[1:2] in ("", " "))
                 and ": " not in value and " #" not in value and not value.endswith(":")
                 and isinstance(_resolve_plain(value), str) and value.isprintable())
        if plain:
            return value
        if value.isprintable():
            return "'" + value.replace("'", "''") + "'"
        return '"' + value.encode("unicode_escape").decode("ascii").replace('"', '\\"') + '"'
    raise TypeError(f"dump_yaml: cannot write a {type(value).__name__}")


def _dump_node(value, indent: int, out: list) -> None:
    pad = " " * indent
    for key, v in value.items():
        head = f"{pad}{_scalar_text(key)}:"
        if isinstance(v, dict) and v:
            out.append(head)
            _dump_node(v, indent + 2, out)
        elif isinstance(v, (list, tuple)) and v:
            out.append(head)
            for item in v:
                out.append(f"{pad}- {_scalar_text(item)}")
        elif isinstance(v, dict):
            out.append(f"{head} {{}}")
        elif isinstance(v, (list, tuple)):
            out.append(f"{head} []")
        else:
            out.append(f"{head} {_scalar_text(v)}")


def dump_yaml(tree: dict) -> str:
    """Block-style YAML of a config tree (nested dicts whose leaves are
    scalars or flat lists of scalars), as ``yaml.safe_dump(tree,
    sort_keys=False)`` writes it."""
    out: list = []
    _dump_node(tree, 0, out)
    return "\n".join(out) + "\n"
