"""A YAML reader for configs, without PyYAML (the machine with the card has none).

Reads what the JAX package's configs and its writer (``yaml.safe_dump``) hold, to the values
``yaml.safe_load`` gives:

- block mappings, and block sequences both indented and at their key's own column (``key:`` then
  ``- a``), with compact entries (``- key: value``, ``- - a``);
- flow sequences and flow mappings (``[]`` and ``{}`` too) on one line;
- comments and a leading ``---`` (a trailing ``...`` ends the document);
- single-quoted (``''``) and double-quoted scalars with PyYAML's escapes;
- plain scalars resolved as PyYAML's YAML 1.1 resolver does: ``null``, ``~`` and empty are None;
  ``true``/``false``/``yes``/``no``/``on``/``off`` in PyYAML's case forms are bools; ints in decimal,
  ``0b``, ``0x``, leading-0 octal and base 60; floats only with a dot (``1.0e-05`` is a float,
  ``1e-3`` a string); ``.inf`` and ``.nan``.

- plain and quoted scalars continued on later lines, folded as PyYAML folds them (one line break is a
  space, each empty line a line break, an escaped break in double quotes joins the lines): what
  ``yaml.safe_dump`` writes for a string past 80 columns or one that holds line breaks.

Raises ValueError with the line number on what it does not read: anchors and aliases, tags, block
scalars (``|``, ``>``), several documents, directives, complex (``?``) and merge (``<<``) keys,
timestamps, flow collections continued on another line, tabs used as indentation, and
duplicate keys (which PyYAML would let the last one win).
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, List, NamedTuple, Optional, Tuple, Union

# PyYAML's implicit resolvers (yaml/resolver.py), in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
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
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# double-quoted escapes (yaml/scanner.py): one character, or a code of 2, 4 or 8 hex digits
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
            "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
# a node may not start with these: anchors, aliases, tags, block scalars, directives, reserved characters
_REFUSED = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars", ">": "block scalars",
            "%": "directives", "@": "reserved characters", "`": "reserved characters"}
_FLOW_END = ",[]{}"
_UNCLOSED = "a flow collection continued on another line is not read"


class _Line(NamedTuple):
    number: int
    indent: int
    text: str  # stripped of the indentation and of trailing spaces
    raw_index: int  # the index of the line in the document, blank and comment lines included


def _sexagesimal(text: str) -> Union[int, float]:
    value = 0
    for part in text.split(":"):
        value = value * 60 + (float(part) if "." in part else int(part))
    return value


def resolve(text: str) -> Any:
    """A plain scalar's value, as PyYAML's resolver and safe constructor make it."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        return sign * float(_sexagesimal(value) if ":" in value else value)
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value != "0" and value[0] == "0":
            return sign * int(value, 8)
        return sign * (_sexagesimal(value) if ":" in value else int(value))
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise ValueError(f"the timestamp {text!r} is not read (quote it to keep it a string)")
    if text in ("<<", "="):
        raise ValueError(f"the merge and value keys ({text!r}) are not read")
    return text


def _quoted(s: str, p: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[p] and the position after its closing quote."""
    quote, out, p = s[p], [], p + 1
    while True:
        if p >= len(s):
            raise ValueError("a quoted scalar continued on another line is not read")
        c = s[p]
        if quote == "'":
            if c == "'":
                if s.startswith("''", p):
                    out.append("'")
                    p += 2
                    continue
                return "".join(out), p + 1
            out.append(c)
            p += 1
            continue
        if c == '"':
            return "".join(out), p + 1
        if c != "\\":
            out.append(c)
            p += 1
            continue
        code = s[p + 1] if p + 1 < len(s) else ""
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
            p += 2
        elif code in _ESCAPE_CODES:
            digits = s[p + 2:p + 2 + _ESCAPE_CODES[code]]
            if len(digits) != _ESCAPE_CODES[code] or not all(x in "0123456789abcdefABCDEF" for x in digits):
                raise ValueError(f"bad escape \\{code}{digits} in a double-quoted scalar")
            out.append(chr(int(digits, 16)))
            p += 2 + len(digits)
        else:
            raise ValueError(f"unknown escape \\{code} in a double-quoted scalar" if code else
                             "a double-quoted scalar continued on another line is not read")


def _quoted_lines(raw: List[str], r: int, p: int) -> Tuple[str, str, int]:
    """The quoted scalar starting at raw[r][p], which may run over the lines after it: (value, the text after
    its closing quote on its last line, the index of that line). Line breaks fold as in PyYAML: the spaces
    before a break go, one break is a space and each empty line after it a line break, the next line's
    leading spaces go; in double quotes a backslash at the end of a line joins it to the next."""
    s, quote = raw[r], raw[r][p]
    out: List[str] = []
    keep, p = 0, p + 1  # keep: the length of ``out`` up to the last character a line break does not drop

    def next_line(escaped: bool) -> str:
        nonlocal r, keep
        blanks = 0
        r += 1
        while r < len(raw) and not raw[r].strip(" \t"):
            blanks, r = blanks + 1, r + 1
        if r >= len(raw):
            raise ValueError("a quoted scalar is not closed")
        if not escaped:
            del out[keep:]
        out.append("\n" * blanks if blanks or escaped else " ")
        keep = len(out)
        return raw[r].lstrip(" \t")

    while True:
        if p >= len(s):
            s, p = next_line(escaped=False), 0
            continue
        c = s[p]
        if c == quote and not (quote == "'" and s.startswith("''", p)):
            return "".join(out), s[p + 1:], r
        if quote == "'" and c == "'":
            out.append("'")
            p += 2
        elif quote == "'" or c != "\\":
            out.append(c)
            p += 1
            if c in " \t":
                continue
        else:
            code = s[p + 1] if p + 1 < len(s) else ""
            if not code:
                s, p = next_line(escaped=True), 0
                continue
            if code in _ESCAPES:
                out.append(_ESCAPES[code])
                p += 2
            elif code in _ESCAPE_CODES:
                digits = s[p + 2:p + 2 + _ESCAPE_CODES[code]]
                if len(digits) != _ESCAPE_CODES[code] or not all(x in "0123456789abcdefABCDEF" for x in digits):
                    raise ValueError(f"bad escape \\{code}{digits} in a double-quoted scalar")
                out.append(chr(int(digits, 16)))
                p += 2 + len(digits)
            else:
                raise ValueError(f"unknown escape \\{code} in a double-quoted scalar")
        keep = len(out)


def _refuse_indicator(s: str, p: int) -> None:
    if p < len(s) and s[p] in _REFUSED:
        raise ValueError(f"{_REFUSED[s[p]]} ({s[p]!r}) are not read")
    if s.startswith("? ", p) or s[p:] == "?":
        raise ValueError("complex keys ('? ') are not read")


def _skip_space(s: str, p: int) -> int:
    """Past spaces, and past a comment (a '#' at the start or after a space) to the end."""
    while p < len(s) and s[p] == " ":
        p += 1
    return len(s) if s[p:p + 1] == "#" and (p == 0 or s[p - 1] == " ") else p


def _flow_node(s: str, p: int) -> Tuple[Any, int]:
    """The flow node (collection or scalar) starting at s[p], and the position after it."""
    p = _skip_space(s, p)
    if p >= len(s):
        raise ValueError(_UNCLOSED)
    c = s[p]
    if c == "[":
        out: list = []
        p = _skip_space(s, p + 1)
        while True:
            if p >= len(s):
                raise ValueError(_UNCLOSED)
            if s[p] == "]":
                return out, p + 1
            value, p = _flow_node(s, p)
            p = _skip_space(s, p)
            if p < len(s) and s[p] == ":":
                raise ValueError("a mapping inside a flow sequence is not read")
            out.append(value)
            p = _flow_next(s, p, "]")
    if c == "{":
        mapping: dict = {}
        p = _skip_space(s, p + 1)
        while True:
            if p >= len(s):
                raise ValueError(_UNCLOSED)
            if s[p] == "}":
                return mapping, p + 1
            key, p = _flow_node(s, p)
            p = _skip_space(s, p)
            if p >= len(s):
                raise ValueError(_UNCLOSED)
            value = None
            if s[p] == ":":
                p = _skip_space(s, p + 1)
                if p >= len(s):
                    raise ValueError(_UNCLOSED)
                if s[p] not in ",}":
                    value, p = _flow_node(s, p)
            _add_key(mapping, key, value)
            p = _flow_next(s, p, "}")
    if c in "\"'":
        return _quoted(s, p)
    if c in "]}":
        raise ValueError(f"unexpected {c!r}")
    _refuse_indicator(s, p)
    start = p
    while p < len(s) and s[p] not in _FLOW_END and not (s[p] == "#" and s[p - 1] == " "):
        if s[p] == ":" and (p + 1 == len(s) or s[p + 1] in " " + _FLOW_END):
            break
        p += 1
    return resolve(s[start:p].rstrip(" ")), p


def _flow_next(s: str, p: int, end: str) -> int:
    """Past the ',' between two entries of a flow collection, or at its closing bracket."""
    p = _skip_space(s, p)
    if p >= len(s):
        raise ValueError(_UNCLOSED)
    if s[p] == ",":
        return _skip_space(s, p + 1)
    if s[p] != end:
        raise ValueError(f"expected ',' or {end!r} in a flow collection, found {s[p]!r}")
    return p


def _add_key(mapping: dict, key: Any, value: Any) -> None:
    try:
        duplicate = key in mapping
    except TypeError:
        raise ValueError(f"the key {key!r} is not hashable") from None
    if duplicate:
        raise ValueError(f"duplicate key {key!r}")
    mapping[key] = value


def _end_of_node(s: str, p: int) -> None:
    """Only spaces or a comment may follow a node on its line."""
    p = _skip_space(s, p)
    if p < len(s):
        raise ValueError(f"unexpected text after a node: {s[p:]!r}")


def _is_entry(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Parser:
    def __init__(self, lines: List[_Line], raw: List[str]):
        self.lines, self.raw = lines, raw
        self.i = 0

    def _next(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def _key(self, line: _Line) -> Optional[Tuple[Any, str]]:
        """(key, the text after its ': ') where the line is a mapping entry, else None."""
        s = line.text
        if s[0] in "\"'":
            try:
                key, p = _quoted(s, 0)
            except ValueError:
                return None  # not a key: inline() reports it with the line
            p = _skip_space(s, p) if s[p:p + 1] == " " else p
            if s[p:p + 1] == ":" and (p + 1 == len(s) or s[p + 1] == " "):
                return key, s[p + 1:].lstrip(" ")
            return None
        if s[0] in "[{" or _is_entry(s):
            return None
        m = re.search(r":( |$)| #", s)
        if m is None or m.group(0) == " #":
            return None
        try:
            _refuse_indicator(s, 0)
            return resolve(s[:m.start()].rstrip(" ")), s[m.end():].lstrip(" ")
        except ValueError as e:
            raise ValueError(f"line {line.number}: {e}") from None

    def node(self, indent: int) -> Any:
        """The block node whose first line is the next one, at column ``indent``."""
        line = self._next()
        if _is_entry(line.text):
            return self.sequence(indent)
        if self._key(line) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.inline(line.text, line, indent - 1)

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while (line := self._next()) is not None and line.indent >= indent:
            if line.indent > indent:
                raise ValueError(f"line {line.number}: unexpected indentation")
            entry = self._key(line)
            if entry is None:
                if _is_entry(line.text):
                    break  # a sequence at its key's column ends, and so does this mapping
                raise ValueError(f"line {line.number}: expected a 'key: value' entry")
            key, rest = entry
            if key == "<<":
                raise ValueError(f"line {line.number}: merge keys ('<<') are not read")
            try:
                _add_key(out, key, None)
            except ValueError as e:
                raise ValueError(f"line {line.number}: {e}") from None
            self.i += 1
            out[key] = self.value(rest, line, indent, in_mapping=True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while (line := self._next()) is not None and line.indent == indent and _is_entry(line.text):
            rest = line.text[1:].lstrip(" ")
            column = indent + len(line.text) - len(rest)
            if rest and not rest.startswith("#") and (_is_entry(rest) or self._key(line._replace(text=rest))):
                # a compact nested node: the rest of the line is its first line, at its own column
                self.lines[self.i] = line._replace(indent=column, text=rest)
                out.append(self.node(column))
            else:
                self.i += 1
                out.append(self.value(rest, line, indent, in_mapping=False))
        if line is not None and line.indent > indent:
            raise ValueError(f"line {line.number}: unexpected indentation")
        return out

    def value(self, rest: str, line: _Line, indent: int, in_mapping: bool) -> Any:
        """The value after a key or a '-' at column ``indent``: on the rest of the line, on the deeper lines
        below it, or (a mapping's value) a sequence at the key's own column; else None."""
        if rest and not rest.startswith("#"):
            return self.inline(rest, line, indent)
        nxt = self._next()
        if nxt is not None and nxt.indent > indent:
            return self.node(nxt.indent)
        if in_mapping and nxt is not None and nxt.indent == indent and _is_entry(nxt.text):
            return self.sequence(indent)
        return None

    def _consumed(self, last: int) -> None:
        """Past the lines of a scalar that ended on the document's line ``last``."""
        while self.i < len(self.lines) and self.lines[self.i].raw_index <= last:
            self.i += 1

    def _plain_lines(self, plain: str, line: _Line, indent: int) -> str:
        """A plain scalar continued on the lines after ``line`` that are deeper than ``indent``: one line
        break folds to a space, each empty line to a line break; a comment ends it."""
        last, blanks = line.raw_index, 0
        for r in range(line.raw_index + 1, len(self.raw)):
            body = self.raw[r].strip(" \t")
            if not body:
                blanks += 1
                continue
            if len(self.raw[r]) - len(self.raw[r].lstrip(" ")) <= indent or body.startswith("#"):
                break
            cut = body.find(" #")
            plain += ("\n" * blanks if blanks else " ") + (body if cut < 0 else body[:cut].rstrip(" "))
            last, blanks = r, 0
            if cut >= 0:
                break
        self._consumed(last)
        return plain

    def inline(self, text: str, line: _Line, indent: int) -> Any:
        """A scalar or flow node on the rest of a line (a scalar may continue on the lines deeper than
        ``indent``)."""
        try:
            if text[0] in "\"'":
                value, rest, last = _quoted_lines(self.raw, line.raw_index, line.indent + len(line.text) - len(text))
                self._consumed(last)
                _end_of_node(rest, 0)
                return value
            if text[0] in "[{":
                value, p = _flow_node(text, 0)
                _end_of_node(text, p)
                return value
            _refuse_indicator(text, 0)
            if text.startswith("- "):
                raise ValueError("a block sequence may not start on a key's line")
            cut = text.find(" #")
            plain = (text if cut < 0 else text[:cut]).rstrip(" ")
            if cut < 0:
                plain = self._plain_lines(plain, line, indent)
            if re.search(r":( |$)", plain):
                raise ValueError(f"mapping values are not allowed here: {plain!r}")
            return resolve(plain)
        except ValueError as e:
            raise ValueError(f"line {line.number}: {e}") from None


def loads(text: str) -> Any:
    """The value of a YAML document, as ``yaml.safe_load`` gives it (None for an empty one)."""
    lines: List[_Line] = []
    started = ended = False
    raws = text.splitlines()
    for number, raw in enumerate(raws, 1):
        body = raw.strip(" \t")
        if not body or body.startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        if raw[indent] == "\t":
            raise ValueError(f"line {number}: a tab in the indentation")
        if ended:
            raise ValueError(f"line {number}: several documents are not read")
        if indent == 0 and re.match(r"---( |$)", body):
            if started or lines:
                raise ValueError(f"line {number}: several documents are not read")
            started = True
            if body[3:].strip() and not body[3:].strip().startswith("#"):
                raise ValueError(f"line {number}: a node on the '---' line is not read")
            continue
        if indent == 0 and re.match(r"\.\.\.( |$)", body):
            ended = True
            continue
        if indent == 0 and body.startswith("%"):
            raise ValueError(f"line {number}: directives are not read")
        lines.append(_Line(number, indent, body, number - 1))
    if not lines:
        return None
    parser = _Parser(lines, raws)
    value = parser.node(lines[0].indent)
    if parser.i < len(lines):
        line = lines[parser.i]
        raise ValueError(f"line {line.number}: unexpected text after the document's node: {line.text!r}")
    return value


def load(path: Union[str, Path]) -> Any:
    """The value of the YAML file at ``path``; a ValueError names the file and the line."""
    try:
        return loads(Path(path).read_text())
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
