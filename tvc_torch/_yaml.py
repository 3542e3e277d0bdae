"""A reader and writer for the YAML subset that ``configs/`` uses.

The card's machine has no PyYAML, so the port carries its own, as it
carries ``_flax_msgpack.py`` and ``_safetensors.py``. The subset:

* block mappings and block sequences (a sequence may sit at its key's
  indent, and ``- key: value`` items open a mapping);
* flow sequences ``[a, "b", 1]`` and flow mappings ``{name: x, mode: y}``,
  nested, on one line;
* plain, single-quoted and double-quoted scalars, and comments.

Plain scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1):
``1e-5`` (no dot) and ``1.0e5`` (no exponent sign) stay strings, ``yes`` /
``no`` / ``on`` / ``off`` are booleans, ``~`` and an empty value are null,
``0x1f`` / ``017`` / ``1_000`` / ``1:30`` are ints. Anything else (anchors,
aliases, tags, block scalars, documents markers, directives, complex keys,
timestamps, a scalar or flow collection over several lines) raises
:class:`YAMLError`: the reader never guesses.

:func:`dump` writes block style that ``yaml.safe_load`` reads back to the
same value.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["YAMLError", "load", "dump"]


class YAMLError(ValueError):
    """A construct outside the subset, or malformed input."""


# -- scalar resolution (PyYAML's SafeLoader implicit resolvers) ---------------

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$"
)
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+"
    r"|[-+]?0[0-7_]+"
    r"|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_MERGE_OR_VALUE = re.compile(r"^(?:<<|=)$")


def _sexagesimal(digits: str) -> float:
    value = 0.0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def _construct_int(text: str) -> int:
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * int(_sexagesimal(v))
    return sign * int(v)


def _construct_float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        return sign * _sexagesimal(v)
    return sign * float(v)


def resolve_plain(text: str) -> Any:
    """A plain scalar's value, as ``yaml.safe_load`` resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _construct_int(text)
    if _FLOAT.match(text):
        return _construct_float(text)
    if _TIMESTAMP.match(text):
        raise YAMLError(f"timestamps are outside the subset: {text!r}")
    if _MERGE_OR_VALUE.match(text):
        raise YAMLError(f"merge / value keys are outside the subset: {text!r}")
    return text


# -- quoted scalars -----------------------------------------------------------

_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f",
    "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
    "L": "\u2028", "P": "\u2029",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _double_quoted(s: str, i: int) -> Tuple[str, int]:
    """Parse a double-quoted scalar starting at s[i] == '"'; returns (value,
    index after the closing quote)."""
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            if i + 1 >= len(s):
                raise YAMLError("a double-quoted scalar may not span lines")
            e = s[i + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[i + 2 : i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise YAMLError(f"bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                raise YAMLError(f"unknown escape \\{e}")
        else:
            out.append(c)
            i += 1
    raise YAMLError("a double-quoted scalar may not span lines")


def _single_quoted(s: str, i: int) -> Tuple[str, int]:
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == "'":
            if s[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise YAMLError("a single-quoted scalar may not span lines")


def _quoted(s: str, i: int) -> Tuple[str, int]:
    return _double_quoted(s, i) if s[i] == '"' else _single_quoted(s, i)


# -- lines --------------------------------------------------------------------

def _strip_comment(line: str) -> str:
    """The line without its comment (``#`` at the start or after a space,
    outside quotes), right-stripped."""
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c in "\"'" and (i == 0 or line[i - 1] in " \t[{,:-?"):
            _, i = _quoted(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


_Line = Tuple[int, str, int]  # (indent, text, line number)


def _lines(text: str) -> List[_Line]:
    out: List[_Line] = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        indent = len(body) - len(stripped)
        if stripped.startswith("\t") or "\t" in body[:indent]:
            raise YAMLError(f"line {no}: tabs in indentation")
        if indent == 0 and (stripped.startswith(("---", "...")) or stripped[0] == "%"):
            raise YAMLError(f"line {no}: document markers and directives are outside the subset")
        out.append((indent, stripped, no))
    return out


# -- flow collections and inline values ----------------------------------------

_FLOW_STOP = ",]}"


def _check_plain_start(text: str, no: int) -> None:
    if not text:
        return
    c = text[0]
    if c in "&*!|>%@`":
        raise YAMLError(f"line {no}: {c!r} (anchor, alias, tag, block scalar or reserved) is outside the subset")
    if c == "?" and (len(text) == 1 or text[1] == " "):
        raise YAMLError(f"line {no}: complex keys are outside the subset")


class _Flow:
    """Parser of one line's flow collection."""

    def __init__(self, s: str, no: int):
        self.s, self.i, self.no = s, 0, no

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def _err(self, msg: str) -> YAMLError:
        return YAMLError(f"line {self.no}: {msg} in {self.s!r}")

    def value(self, in_map_key: bool = False) -> Any:
        self._ws()
        if self.i >= len(self.s):
            raise self._err("a flow collection may not span lines")
        c = self.s[self.i]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in "\"'":
            v, self.i = _quoted(self.s, self.i)
            return v
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in _FLOW_STOP or ch in "[{":
                break
            if ch == ":" and (self.i + 1 >= len(self.s) or self.s[self.i + 1] in " ,]}"):
                break
            self.i += 1
        text = self.s[start : self.i].strip()
        _check_plain_start(text, self.no)
        return resolve_plain(text)

    def _seq(self) -> List[Any]:
        self.i += 1
        out: List[Any] = []
        self._ws()
        if self.s[self.i : self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            item = self.value()
            self._ws()
            if self.s[self.i : self.i + 1] == ":":
                raise self._err("single-pair mappings in flow sequences are outside the subset")
            out.append(item)
            if self.i >= len(self.s):
                raise self._err("a flow collection may not span lines")
            c = self.s[self.i]
            self.i += 1
            if c == "]":
                return out
            if c != ",":
                raise self._err(f"expected ',' or ']', got {c!r}")
            self._ws()
            if self.s[self.i : self.i + 1] == "]":
                self.i += 1
                return out

    def _map(self) -> Dict[Any, Any]:
        self.i += 1
        out: Dict[Any, Any] = {}
        self._ws()
        if self.s[self.i : self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.value()
            if isinstance(key, (list, dict)):
                raise self._err("collection keys are outside the subset")
            self._ws()
            if self.s[self.i : self.i + 1] == ":":
                self.i += 1
                self._ws()
                if self.s[self.i : self.i + 1] in (",", "}"):
                    val = None
                else:
                    val = self.value()
            else:
                val = None
            out[key] = val
            self._ws()
            if self.i >= len(self.s):
                raise self._err("a flow collection may not span lines")
            c = self.s[self.i]
            self.i += 1
            if c == "}":
                return out
            if c != ",":
                raise self._err(f"expected ',' or '}}', got {c!r}")
            self._ws()
            if self.s[self.i : self.i + 1] == "}":
                self.i += 1
                return out

    def end(self) -> None:
        self._ws()
        if self.i != len(self.s):
            raise self._err("text after a flow collection or quoted scalar")


def _inline(text: str, no: int) -> Any:
    """A value written on one line: flow collection, quoted or plain scalar."""
    if text[0] in "[{\"'":
        f = _Flow(text, no)
        v = f.value()
        f.end()
        return v
    _check_plain_start(text, no)
    if text.startswith("- ") or text == "-":
        raise YAMLError(f"line {no}: a block sequence may not start after a key on its line")
    if ": " in text or text.endswith(":"):
        raise YAMLError(f"line {no}: mapping values are not allowed here: {text!r}")
    if " #" in text:
        raise YAMLError(f"line {no}: unexpected comment")
    return resolve_plain(text)


def _split_key(text: str, no: int) -> Optional[Tuple[Any, str]]:
    """``key: rest`` -> (key, rest); None when the line holds no mapping key."""
    if text[0] in "\"'":
        key, i = _quoted(text, 0)
        rest = text[i:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if text[0] in "[{":
        return None
    m = re.search(r":(?: |$)", text)
    if m is None:
        return None
    key_text = text[: m.start()].rstrip()
    _check_plain_start(key_text, no)
    return resolve_plain(key_text), text[m.end() :].strip()


# -- block structure ----------------------------------------------------------

class _Block:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.k = 0

    def peek(self) -> Optional[_Line]:
        return self.lines[self.k] if self.k < len(self.lines) else None

    def node(self, indent: int) -> Any:
        """The node whose first line is the next one, at ``indent``."""
        ind, text, no = self.peek()
        if text == "-" or text.startswith("- "):
            return self.seq(ind)
        if _split_key(text, no) is not None:
            return self.map(ind)
        self.k += 1
        nxt = self.peek()
        if nxt is not None and nxt[0] > ind:
            raise YAMLError(f"line {nxt[2]}: a scalar over several lines is outside the subset")
        return _inline(text, no)

    def _value_after(self, rest: str, parent_indent: int, no: int, seq_at_parent: bool) -> Any:
        """The value of a key (or sequence entry) whose line ends with
        ``rest``: inline, or the block below it."""
        if rest:
            nxt = self.peek()
            if nxt is not None and nxt[0] > parent_indent:
                raise YAMLError(f"line {nxt[2]}: a scalar over several lines is outside the subset")
            return _inline(rest, no)
        nxt = self.peek()
        if nxt is None:
            return None
        ind, text, _ = nxt
        if ind > parent_indent:
            return self.node(ind)
        if seq_at_parent and ind == parent_indent and (text == "-" or text.startswith("- ")):
            return self.seq(ind)
        return None

    def map(self, indent: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while True:
            line = self.peek()
            if line is None or line[0] < indent:
                return out
            ind, text, no = line
            if ind > indent:
                raise YAMLError(f"line {no}: bad indentation")
            if text == "-" or text.startswith("- "):
                if out:
                    raise YAMLError(f"line {no}: a sequence entry inside a mapping")
                return out
            kv = _split_key(text, no)
            if kv is None:
                raise YAMLError(f"line {no}: expected 'key: value', got {text!r}")
            key, rest = kv
            if isinstance(key, (list, dict)):
                raise YAMLError(f"line {no}: collection keys are outside the subset")
            self.k += 1
            out[key] = self._value_after(rest, indent, no, seq_at_parent=True)

    def seq(self, indent: int) -> List[Any]:
        out: List[Any] = []
        while True:
            line = self.peek()
            if line is None or line[0] < indent:
                return out
            ind, text, no = line
            if ind > indent:
                raise YAMLError(f"line {no}: bad indentation")
            if not (text == "-" or text.startswith("- ")):
                return out
            rest = text[1:].lstrip(" ")
            if not rest:
                self.k += 1
                out.append(self._value_after("", indent, no, seq_at_parent=False))
                continue
            col = ind + (len(text) - len(rest))
            if rest == "-" or rest.startswith("- ") or _split_key(rest, no) is not None:
                # a compact nested node: re-read the entry as a line at its column
                self.lines[self.k] = (col, rest, no)
                out.append(self.node(col))
                continue
            self.k += 1
            out.append(self._value_after(rest, indent, no, seq_at_parent=False))


def load(stream: Any) -> Any:
    """``yaml.safe_load`` for the subset: ``stream`` is text or a file."""
    text = stream.read() if hasattr(stream, "read") else stream
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    if text.startswith("\ufeff"):
        text = text[1:]
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    first = lines[0]
    if first[0] != 0:
        raise YAMLError(f"line {first[2]}: the document must start at column 0")
    value = block.node(0)
    rest = block.peek()
    if rest is not None:
        raise YAMLError(f"line {rest[2]}: unexpected text {rest[1]!r}")
    return value


# -- writer -------------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"^[A-Za-z_/.][A-Za-z0-9_ ./()+-]*$")


def _scalar(v: Any) -> str:
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
        s = repr(v).lower()
        if "." not in s and "e" in s:
            s = s.replace("e", ".0e", 1)
        return s
    if isinstance(v, str):
        if _PLAIN_SAFE.match(v) and not v.endswith(" ") and "  " not in v:
            try:
                if resolve_plain(v) == v:
                    return v
            except YAMLError:
                pass
        return _double_quote(v)
    raise YAMLError(f"cannot represent {type(v).__name__}")


def _double_quote(s: str) -> str:
    out = ['"']
    for ch in s:
        o = ord(ch)
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif o < 0x20 or o == 0x7F or 0x80 <= o < 0xA0 or o in (0x2028, 0x2029, 0xFEFF):
            out.append(f"\\u{o:04x}")
        else:
            out.append(ch)
    out.append('"')
    return "".join(out)


def _key(k: Any) -> str:
    if isinstance(k, (dict, list, tuple)):
        raise YAMLError("collection keys are outside the subset")
    return _scalar(k)


def _emit(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            if isinstance(x, dict) and x:
                out.append(f"{pad}{_key(k)}:")
                _emit(x, indent + 2, out)
            elif isinstance(x, (list, tuple)) and len(x):
                out.append(f"{pad}{_key(k)}:")
                _emit(x, indent, out)
            else:
                out.append(f"{pad}{_key(k)}: {_inline_value(x)}")
    else:
        for x in v:
            if isinstance(x, dict) and x:
                inner: List[str] = []
                _emit(x, indent + 2, inner)
                out.append(f"{pad}- {inner[0][indent + 2 :]}")
                out.extend(inner[1:])
            elif isinstance(x, (list, tuple)) and len(x):
                inner = []
                _emit(x, indent + 2, inner)
                out.append(f"{pad}- {inner[0][indent + 2 :]}")
                out.extend(inner[1:])
            else:
                out.append(f"{pad}- {_inline_value(x)}")


def _inline_value(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def dump(data: Any) -> str:
    """Block-style YAML text that ``yaml.safe_load`` (and :func:`load`) read
    back equal to ``data``: dicts (in insertion order), lists and tuples
    (read back as lists), str, int, float, bool and None."""
    if isinstance(data, (dict, list, tuple)) and len(data):
        out: List[str] = []
        _emit(data, 0, out)
        return "\n".join(out) + "\n"
    return _inline_value(data) + "\n"
