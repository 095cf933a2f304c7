"""Read and write the YAML subset of the repo's configs, without PyYAML.

The JAX package reads configs with `yaml.load(..., Loader=yaml.FullLoader)`
and writes a run's `config.yaml` with `yaml.dump`. The port has no PyYAML,
so this module reads and writes the subset those files use:

* block mappings, and block sequences indented under their key or not
  (`yaml.dump` writes them at the key's indent);
* one-line flow sequences and flow mappings (`[2]`,
  `{'pp': 3.5, 'pf': 8}`), nested;
* plain, single-quoted and double-quoted scalars, and `#` comments;
* the YAML 1.1 implicit types that PyYAML's resolver applies: a float
  needs a dot and a signed exponent (`1.0e-3` is a float, `1e-3` and
  `1.0e3` are strings); `yes`/`on`/`true` (and their No forms) in three
  cases are bools; `~`, `null` and the empty value are None; ints are
  decimal or hex, with `_` separators;
* in double-quoted scalars, the one-character escapes (`\\n`, `\\t`,
  `\\"`, ...).

Anything else -- anchors, aliases, tags, block scalars, multi-line
scalars, directives, dates, binary, octal (`017`) and base-60 (`1:30`)
numbers, `\\x`/`\\u`/`\\U` and named escapes, complex keys, several
documents -- raises `YamlError`: this reader never guesses. `dump` writes
sorted block mappings and indentless block sequences as `yaml.dump` does,
and its output reads back equal through `load` and through PyYAML.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple


class YamlError(ValueError):
    """Input outside the supported subset, or malformed."""


_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
# PyYAML resolves these to dates, merge keys, value keys, binary, octal and
# base-60 numbers: not supported
_UNSUPPORTED = re.compile(r"""^(?:[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=
    |[-+]?0b[0-1_]+|[-+]?0[0-7_]+
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$""", re.X)
_INDICATORS = "&*!|>%@`"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _resolve_int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    t = t.lstrip("+-")
    return sign * int(t[2:], 16) if t.startswith("0x") else sign * int(t)


def _resolve_float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t.endswith(".inf"):
        return -math.inf if t[0] == "-" else math.inf
    if t == ".nan":
        return math.nan
    return float(t)


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar's value under PyYAML's YAML 1.1 rules."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _UNSUPPORTED.match(text):
        raise YamlError(f"unsupported implicit type for {text!r}")
    if _INT.match(text):
        return _resolve_int(text)
    if _FLOAT.match(text):
        return _resolve_float(text)
    return text


# ------------------------------------------------------------------ reader


class _Line:
    __slots__ = ("number", "indent", "text")

    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


def _strip_comment(raw: str, number: int) -> str:
    """`raw` without its comment. A quote opens a quoted scalar only where
    a scalar can start; `#` starts a comment at the start or after a
    space, outside quotes."""
    out: List[str] = []
    quote = None
    i = 0
    while i < len(raw):
        c = raw[i]
        if quote:
            out.append(c)
            if quote == '"' and c == "\\":
                if i + 1 < len(raw):
                    out.append(raw[i + 1])
                i += 2
                continue
            if c == quote:
                if quote == "'" and raw[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                quote = None
            i += 1
            continue
        prev = "".join(out).rstrip()
        if c == "#" and (not out or out[-1] in " \t"):
            break
        if c in "'\"" and (not prev or prev[-1] in ":-[{,"):
            quote = c
        out.append(c)
        i += 1
    if quote:
        raise YamlError(f"line {number}: unterminated quoted scalar "
                        f"(multi-line scalars are not supported)")
    return "".join(out).rstrip()


def _lines(text: str) -> List[_Line]:
    lines = []
    for number, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise YamlError(f"line {number}: tab in indentation")
        content = _strip_comment(body, number)
        if not content:
            continue
        if content.startswith(("---", "...", "%")):
            raise YamlError(f"line {number}: document markers and "
                            f"directives are not supported")
        lines.append(_Line(number, len(raw) - len(body), content))
    return lines


def _quoted(text: str, pos: int, number: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[pos]: (value, position after)."""
    q = text[pos]
    out: List[str] = []
    i = pos + 1
    while i < len(text):
        c = text[i]
        if c == q:
            if q == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e not in _ESCAPES:
                raise YamlError(f"line {number}: unsupported escape \\{e}")
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    raise YamlError(f"line {number}: unterminated quoted scalar")


class _Flow:
    """One-line flow collection parser."""

    def __init__(self, text: str, number: int):
        self.text, self.number, self.pos = text, number, 0

    def error(self, msg: str) -> YamlError:
        return YamlError(f"line {self.number}: {msg} in flow collection "
                         f"{self.text!r}")

    def skip(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] == " ":
            self.pos += 1

    def peek(self) -> str:
        self.skip()
        return self.text[self.pos:self.pos + 1]

    def node(self) -> Any:
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        return self.scalar()

    def scalar(self) -> Any:
        c = self.peek()
        if c in ("'", '"'):
            value, self.pos = _quoted(self.text, self.pos, self.number)
            return value
        if c and c in _INDICATORS + "?":
            raise self.error(f"unsupported indicator {c!r}")
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c in ",[]{}":
                break
            if c == ":" and self.text[self.pos + 1:self.pos + 2] in (
                    " ", ",", "]", "}", ""):
                break
            self.pos += 1
        return resolve_plain(self.text[start:self.pos].strip())

    def sequence(self) -> list:
        self.pos += 1
        out = []
        while True:
            if self.peek() == "]":
                self.pos += 1
                return out
            out.append(self.node())
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c != "]":
                raise self.error("expected ',' or ']'")

    def mapping(self) -> dict:
        self.pos += 1
        out = {}
        while True:
            if self.peek() == "}":
                self.pos += 1
                return out
            key = self.scalar()
            if self.peek() != ":":
                raise self.error("expected ':' after a key")
            self.pos += 1
            if self.peek() in (",", "}"):
                value = None
            else:
                value = self.node()
            _check_key(key, self.number)
            out[key] = value
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c != "}":
                raise self.error("expected ',' or '}'")

    def whole(self) -> Any:
        value = self.node()
        if self.peek():
            raise self.error("trailing characters")
        return value


def _check_key(key: Any, number: int) -> None:
    if isinstance(key, (list, dict)):
        raise YamlError(f"line {number}: collection keys are not supported")


def _inline(text: str, number: int) -> Any:
    """The value written on a line after `key:` or `- `."""
    c = text[0]
    if c in "[{":
        return _Flow(text, number).whole()
    if c in "'\"":
        value, end = _quoted(text, 0, number)
        if text[end:].strip():
            raise YamlError(f"line {number}: text after a quoted scalar")
        return value
    if c in _INDICATORS or text.startswith(("? ", "- ")) or text in ("?", "-"):
        raise YamlError(f"line {number}: unsupported construct {text!r}")
    if _split_key(text) is not None:
        raise YamlError(f"line {number}: a mapping inside a sequence entry "
                        f"or on one line is not supported: {text!r}")
    return resolve_plain(text)


def _split_key(text: str):
    """(key text, value text) where `text` is a block mapping entry, else
    None. The key ends at the first ':' followed by a space or the end of
    the line, outside quotes."""
    if text[0] in "'\"":
        try:
            _, end = _quoted(text, 0, 0)
        except YamlError:
            return None
        rest = text[end:].lstrip(" ")
        if rest == ":" or rest.startswith(": "):
            return text[:end], rest[1:].strip()
        return None
    if text[0] in "[{":
        return None
    m = re.search(r":( |$)", text)
    if m is None:
        return None
    return text[:m.start()].rstrip(), text[m.end():].strip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:

    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.i = 0

    def current(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, indent: int) -> Any:
        line = self.current()
        if _is_item(line.text):
            return self.sequence(indent)
        if _split_key(line.text) is not None:
            return self.mapping(indent)
        self.i += 1
        return _inline(line.text, line.number)

    def key(self, text: str, number: int) -> Any:
        if text[0] in "'\"":
            return _quoted(text, 0, number)[0]
        if text[0] in _INDICATORS + "?[{":
            raise YamlError(f"line {number}: unsupported key {text!r}")
        return resolve_plain(text)

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            line = self.current()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise YamlError(f"line {line.number}: unexpected indent "
                                f"(multi-line scalars are not supported)")
            split = _split_key(line.text)
            if split is None:
                raise YamlError(f"line {line.number}: expected 'key: value'"
                                f", got {line.text!r}")
            key = self.key(split[0], line.number)
            _check_key(key, line.number)
            self.i += 1
            if split[1]:
                out[key] = _inline(split[1], line.number)
                continue
            nxt = self.current()
            if nxt is not None and nxt.indent > indent:
                out[key] = self.node(nxt.indent)
            elif (nxt is not None and nxt.indent == indent
                  and _is_item(nxt.text)):
                out[key] = self.sequence(indent)
            else:
                out[key] = None

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            line = self.current()
            if (line is None or line.indent < indent
                    or (line.indent == indent and not _is_item(line.text))):
                return out
            if line.indent > indent or not _is_item(line.text):
                raise YamlError(f"line {line.number}: unexpected indent")
            self.i += 1
            rest = line.text[1:].strip()
            if rest:
                out.append(_inline(rest, line.number))
                continue
            nxt = self.current()
            if nxt is not None and nxt.indent > indent:
                raise YamlError(f"line {nxt.number}: block collections "
                                f"inside a sequence are not supported")
            out.append(None)


def load(text: str) -> Any:
    """The value of one YAML document in the supported subset."""
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0].indent)
    if block.current() is not None:
        line = block.current()
        raise YamlError(f"line {line.number}: unexpected content "
                        f"{line.text!r}")
    return value


def load_file(path) -> Any:
    with open(path) as f:
        return load(f.read())


# ------------------------------------------------------------------ writer


def _plain_ok(s: str) -> bool:
    """Whether `s` can be written unquoted and read back as this string."""
    if not s or s != s.strip() or not s.isprintable():
        return False
    if s[0] in "-?:,[]{}#&*!|>'\"%@`" or any(c in s for c in ",[]{}"):
        return False
    if ":" in s or " #" in s:
        return False
    try:
        return resolve_plain(s) == s
    except YamlError:
        return False


def _scalar(value: Any) -> str:
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
        if _plain_ok(value):
            return value
        if "\n" in value or not value.isprintable():
            raise YamlError(f"cannot write multi-line or non-printable "
                            f"string {value!r}")
        return "'" + value.replace("'", "''") + "'"
    raise YamlError(f"cannot write a {type(value).__name__}")


def _sorted_keys(mapping: dict) -> list:
    """The keys in order, as `yaml.dump` sorts them (insertion order where
    they do not compare)."""
    try:
        return sorted(mapping)
    except TypeError:
        return list(mapping)


def _flow(value: Any) -> str:
    if isinstance(value, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(value[k])}"
                               for k in _sorted_keys(value)) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow(v) for v in value) + "]"
    return _scalar(value)


def _block(value: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for k in _sorted_keys(value):
            if isinstance(k, (dict, list, tuple)):
                raise YamlError("cannot write collection keys")
            v = value[k]
            head = f"{pad}{_scalar(k)}:"
            if isinstance(v, dict) and v:
                out.append(head)
                _block(v, indent + 2, out)
            elif isinstance(v, (list, tuple)) and v:
                out.append(head)
                _block(v, indent, out)
            else:
                out.append(f"{head} {_flow(v)}")
    else:
        for v in value:
            out.append(f"{pad}- {_flow(v)}")


def dump(value: Any) -> str:
    """`value` (dicts, lists, tuples and scalars) as YAML text."""
    if isinstance(value, dict) and value:
        out: List[str] = []
        _block(value, 0, out)
        return "\n".join(out) + "\n"
    if isinstance(value, (list, tuple)) and value:
        out = []
        _block(value, 0, out)
        return "\n".join(out) + "\n"
    return _flow(value) + "\n"


def dump_file(value: Any, path) -> None:
    with open(path, "w") as f:
        f.write(dump(value))
