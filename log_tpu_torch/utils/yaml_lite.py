"""A reader and writer for the YAML subset the configs under config/ use.

The port reads its YAML with this module whatever is installed, so one path
serves every machine (PyYAML is not on every one). `safe_load` gives what
PyYAML's `yaml.safe_load` gives on that subset, types included, with YAML
1.1's plain-scalar rules: `on`/`off`/`yes`/`no` are booleans, `100_000` is
an int, `1.` is a float and `1e-5` (no dot) is a string. Supported: block
mappings and block sequences (a sequence may sit at its key's indentation),
flow sequences and flow mappings (nested, possibly over several lines),
single- and double-quoted scalars, and comments. Not supported: anchors,
aliases, tags, block scalars (`|`, `>`), multi-document streams; they raise
ValueError.

`dump` writes block YAML that this reader and `yaml.safe_load` both read
back equal: mappings and lists of mappings as blocks, lists of scalars as
flow lists, strings quoted where a plain scalar would read as another type.
"""
from __future__ import annotations

import json
import math
import re

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                           "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_NULL = ("~", "null", "Null", "NULL", "")
# PyYAML's YAML 1.1 resolvers (yaml/resolver.py), without sexagesimals
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)


def _plain(text: str):
    """The value of a plain (unquoted) scalar."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t[0] == "-" else math.inf
        if t.endswith(".nan"):
            return math.nan
        return float(t)
    return text


def _strip_comment(line: str) -> str:
    """The line without its comment (a '#' at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _unquote(text: str):
    if text[0] == '"':
        if not text.endswith('"') or len(text) < 2:
            raise ValueError(f"unterminated string: {text}")
        return json.loads(text)
    if not text.endswith("'") or len(text) < 2:
        raise ValueError(f"unterminated string: {text}")
    return text[1:-1].replace("''", "'")


def _scalar(text: str):
    text = text.strip()
    if text[:1] in ("'", '"'):
        return _unquote(text)
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"unsupported YAML: {text}")
    return _plain(text)


class _Flow:
    """Parser of one flow collection: '[...]' or '{...}'."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def skip(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def value(self):
        self.skip()
        ch = self.s[self.i]
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.map()
        if ch in "'\"":
            j = self.i + 1
            while True:
                j = self.s.index(ch, j)
                if ch == "'" and self.s[j + 1:j + 2] == "'":
                    j += 2
                    continue
                if ch == '"' and self.s[j - 1] == "\\" and \
                        self.s[j - 2] != "\\":
                    j += 1
                    continue
                break
            out = _unquote(self.s[self.i:j + 1])
            self.i = j + 1
            return out
        j = self.i
        while j < len(self.s) and self.s[j] not in ",]}" and not (
                self.s[j] == ":" and self.s[j + 1:j + 2] in (" ", "")):
            j += 1
        out = _plain(self.s[self.i:j].strip())
        self.i = j
        return out

    def seq(self):
        self.i += 1
        out = []
        while True:
            self.skip()
            if self.s[self.i] == "]":
                self.i += 1
                return out
            out.append(self.value())
            self.skip()
            if self.s[self.i] == ",":
                self.i += 1

    def map(self):
        self.i += 1
        out = {}
        while True:
            self.skip()
            if self.s[self.i] == "}":
                self.i += 1
                return out
            key = self.value()
            self.skip()
            if self.s[self.i] == ":":
                self.i += 1
                out[key] = self.value()
            else:
                out[key] = None
            self.skip()
            if self.s[self.i] == ",":
                self.i += 1


def _flow(text: str):
    p = _Flow(text)
    out = p.value()
    p.skip()
    if p.i != len(p.s):
        raise ValueError(f"trailing text after a flow collection: {text}")
    return out


def _split_key(text: str):
    """(key, rest) of 'key: rest' or 'key:'; None if text is no mapping
    entry."""
    if text[:1] in ("'", '"'):
        q = text[0]
        j = text.index(q, 1)
        while q == "'" and text[j + 1:j + 2] == "'":
            j = text.index(q, j + 2)
        if text[j + 1:j + 2] == ":":
            return _unquote(text[:j + 1]), text[j + 2:].strip()
        return None
    if text[:1] in ("[", "{"):
        return None
    m = re.search(r":(\s|$)", text)
    if m is None:
        return None
    return _plain(text[:m.start()].strip()), text[m.end():].strip()


def _lines(text: str):
    """(indent, content) of every line that holds something, with flow
    collections that span lines joined into one."""
    out = []
    pending, depth = None, 0
    for raw in text.splitlines():
        line = _strip_comment(raw.rstrip("\r"))
        if not line.strip():
            continue
        if line.strip() in ("---", "...") or line.startswith("%"):
            if out or pending:
                raise ValueError("multi-document YAML is not supported")
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError("tabs in indentation")
        if pending is not None:
            pending[1] += " " + line.strip()
        else:
            pending = [len(line) - len(line.lstrip()), line.strip()]
        depth = _bracket_depth(pending[1])
        if depth == 0:
            out.append(tuple(pending))
            pending = None
    if pending is not None:
        raise ValueError(f"unclosed flow collection: {pending[1]}")
    return out


def _bracket_depth(text: str) -> int:
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _inline(text: str):
    """A value written on its key's line or after '- '."""
    if text[:1] in ("[", "{"):
        return _flow(text)
    return _scalar(text)


class _Block:
    def __init__(self, lines):
        self.lines, self.i = lines, 0

    def node(self, indent: int):
        """The block node whose lines start at self.i, indented `indent`."""
        ind, text = self.lines[self.i]
        if text == "-" or text.startswith("- "):
            return self.seq(ind)
        if _split_key(text) is not None:
            return self.map(ind)
        self.i += 1
        return _inline(text)

    def child(self, parent_indent: int, seq_ok: bool):
        """The value of a key (or '- ') whose inline part is empty: the
        more indented block below it, a sequence at the same indentation
        (seq_ok), or null."""
        if self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind > parent_indent:
                return self.node(ind)
            if seq_ok and ind == parent_indent and (
                    text == "-" or text.startswith("- ")):
                return self.seq(ind)
        return None

    def map(self, indent: int):
        out = {}
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"bad indentation: {text}")
            kv = _split_key(text)
            if kv is None:
                break
            key, rest = kv
            self.i += 1
            out[key] = _inline(rest) if rest else self.child(indent, True)
        return out

    def seq(self, indent: int):
        out = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind != indent or not (text == "-" or text.startswith("- ")):
                break
            rest = text[1:].strip()
            if not rest:
                self.i += 1
                out.append(self.child(indent, False))
                continue
            nested = rest == "-" or rest.startswith("- ")
            if nested or (_split_key(rest) is not None
                          and rest[:1] not in "[{"):
                # '- key: value' opens a mapping, '- - x' a sequence, at
                # the column of what follows the dash
                col = indent + len(text) - len(rest)
                self.lines[self.i] = (col, rest)
                out.append(self.seq(col) if nested else self.map(col))
            else:
                self.i += 1
                out.append(_inline(rest))
        return out


def safe_load(stream):
    """The document in `stream` (a str or a text file)."""
    text = stream if isinstance(stream, str) else stream.read()
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    out = block.node(lines[0][0])
    if block.i != len(lines):
        raise ValueError(f"unparsed YAML from: {lines[block.i][1]}")
    return out


# ------------------------------------------------------------------ writer
def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r:
            mant, exp = r.split("e")
            r = f"{mant}.0e{exp if exp[0] in '+-' else '+' + exp}"
        return r
    if isinstance(v, str):
        safe = (v and v == v.strip() and _plain(v) == v
                and v[0] not in "-?:,[]{}#&*!|>'\"%@`"
                and ": " not in v and " #" not in v and not v.endswith(":"))
        return v if safe else json.dumps(v)
    raise TypeError(f"cannot dump {type(v).__name__}")


def _dump(node, indent: int, out: list):
    pad = " " * indent
    if isinstance(node, dict):
        for k, v in node.items():
            key = _dump_scalar(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:")
                _dump(v, indent + 2, out)
            elif isinstance(v, (list, tuple)) and any(
                    isinstance(x, (dict, list, tuple)) for x in v):
                out.append(f"{pad}{key}:")
                _dump(list(v), indent + 2, out)
            else:
                out.append(f"{pad}{key}: {_flow_value(v)}")
    else:
        for v in node:
            if isinstance(v, dict) and v:
                sub = []
                _dump(v, indent + 2, sub)
                out.append(f"{pad}- {sub[0].lstrip()}")
                out.extend(sub[1:])
            elif isinstance(v, (list, tuple)) and any(
                    isinstance(x, (dict, list, tuple)) for x in v):
                out.append(f"{pad}-")
                _dump(list(v), indent + 2, out)
            else:
                out.append(f"{pad}- {_flow_value(v)}")


def _flow_value(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_dump_scalar(k)}: {_flow_value(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow_value(x) for x in v) + "]"
    return _dump_scalar(v)


def dump(data) -> str:
    """Block YAML of nested dicts, lists and scalars."""
    if not isinstance(data, (dict, list, tuple)):
        return _dump_scalar(data) + "\n"
    out = []
    _dump(data, 0, out)
    return "\n".join(out) + "\n"
