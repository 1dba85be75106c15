"""A YAML writer for configs, without PyYAML (the machine with the card has none).

Writes, byte for byte, what the JAX package's ``save_config`` writes,
``yaml.safe_dump(config, f, sort_keys=False)``, for what a config holds: mappings (keys in their order),
lists and tuples, str, int, float, bool and None. The emitter's rules are PyYAML 6's (yaml/emitter.py):

- block style, two spaces a level; a list under a key at the key's own column; ``[]`` and ``{}`` when empty;
- ``null``, ``true``/``false``, ints in decimal, floats as ``repr`` with a dot before any exponent
  (``1.0e-05``), ``.inf``, ``-.inf`` and ``.nan``;
- a string is plain unless it would read as another type (``'1.0'``, ``'yes'``, ``'null'``, ``''``) or its
  characters forbid it (a leading indicator, ``: ``, `` #``, edge spaces, line breaks); then single-quoted,
  or double-quoted with escapes where it holds a character outside printable ASCII;
- a plain or quoted string that runs past column 80 is folded at a single space onto the next line,
  indented one level deeper.

Keys that PyYAML would write as complex keys (``? key``: empty, holding a line break, or of 128
characters or more) and values of other types raise ValueError.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, List, Optional, Union

from cinema_tpu_torch.yaml_reader import _BOOL, _FLOAT, _INT, _NULL, _TIMESTAMP

_WIDTH, _INDENT = 80, 2
_BREAKS = "\n\x85\u2028\u2029"
_SPACE_OR_BREAK = "\0 \t\r\n\x85\u2028\u2029"
# plain scalars that PyYAML's resolver reads as another type than str (yaml/resolver.py)
_OTHER_TYPES = (_BOOL, _FLOAT, _INT, _NULL, _TIMESTAMP, re.compile(r"^(?:<<)$"), re.compile(r"^(?:=)$"),
                re.compile(r"^(?:!|&|\*)$"))
_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0a": "n", "\x0b": "v", "\x0c": "f",
            "\x0d": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N", "\xa0": "_", "\u2028": "L",
            "\u2029": "P"}


def _represent(value: Any) -> tuple:
    """(text, True where the text may be written plain because it reads back as this value's type)."""
    if value is None:
        return "null", True
    if isinstance(value, bool):
        return ("true" if value else "false"), True
    if isinstance(value, int):
        return str(value), True
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan", True
        if math.isinf(value):
            return (".inf" if value > 0 else "-.inf"), True
        text = repr(value).lower()
        return (text.replace("e", ".0e", 1) if "." not in text and "e" in text else text), True
    if isinstance(value, str):
        return value, not any(p.match(value) for p in _OTHER_TYPES)
    raise ValueError(f"cannot represent an object of type {type(value).__name__} in a config: {value!r}")


class _Analysis:
    """What PyYAML's ``analyze_scalar`` finds of a scalar's text: the styles it allows."""

    def __init__(self, text: str) -> None:
        self.empty = not text
        self.multiline = False
        if not text:
            self.block_plain, self.single_quoted = True, True
            return
        block = text.startswith("---") or text.startswith("...")
        leading_space = leading_break = trailing_space = trailing_break = False
        break_space = space_break = special = False
        preceded_by_space = True
        followed_by_space = len(text) == 1 or text[1] in _SPACE_OR_BREAK
        previous_space = previous_break = False
        for index, ch in enumerate(text):
            if index == 0:
                if ch in "#,[]{}&*!|>'\"%@`":
                    block = True
                if ch in "?:" and followed_by_space:
                    block = True
                if ch == "-" and followed_by_space:
                    block = True
            else:
                if ch == ":" and followed_by_space:
                    block = True
                if ch == "#" and preceded_by_space:
                    block = True
            if ch in _BREAKS:
                self.multiline = True
            if not (ch == "\n" or "\x20" <= ch <= "\x7e"):
                special = True  # safe_dump writes no unicode: such a character needs double quotes
            if ch == " ":
                leading_space |= index == 0
                trailing_space |= index == len(text) - 1
                break_space |= previous_break
                previous_space, previous_break = True, False
            elif ch in _BREAKS:
                leading_break |= index == 0
                trailing_break |= index == len(text) - 1
                space_break |= previous_space
                previous_space, previous_break = False, True
            else:
                previous_space = previous_break = False
            preceded_by_space = ch in _SPACE_OR_BREAK
            followed_by_space = index + 2 >= len(text) or text[index + 2] in _SPACE_OR_BREAK
        self.block_plain = not (leading_space or leading_break or trailing_space or trailing_break or break_space
                                or space_break or special or self.multiline or block)
        self.single_quoted = not (break_space or space_break or special)


class _Emitter:
    """The block emitter's state (column, whitespace, indention, indent) and its writers."""

    def __init__(self) -> None:
        self.out: List[str] = []
        self.column = 0
        self.whitespace = self.indention = True
        self.indent: Optional[int] = None
        self.indents: List[Optional[int]] = []

    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def increase_indent(self, flow: bool = False, indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = _INDENT if flow else 0
        elif not indentless:
            self.indent += _INDENT

    def indicator(self, text: str, need_whitespace: bool, whitespace: bool = False, indention: bool = False) -> None:
        self.write(text if self.whitespace or not need_whitespace else " " + text)
        self.whitespace = whitespace
        self.indention = self.indention and indention

    def line_break(self, data: str = "\n") -> None:
        self.out.append(data)
        self.whitespace = self.indention = True
        self.column = 0

    def write_indent(self) -> None:
        indent = self.indent or 0
        if not self.indention or self.column > indent or (self.column == indent and not self.whitespace):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    # nodes

    def node(self, value: Any, mapping: bool = False, simple_key: bool = False) -> None:
        if isinstance(value, dict):
            self.flow("{", "}") if not value else self.block_mapping(value)
        elif isinstance(value, (list, tuple)):
            self.flow("[", "]") if not value else self.block_sequence(value, mapping)
        else:
            self.increase_indent(flow=True)
            self.scalar(*_represent(value), simple_key)
            self.indent = self.indents.pop()

    def flow(self, start: str, end: str) -> None:
        self.indicator(start, True, whitespace=True)
        self.increase_indent(flow=True)
        self.indent = self.indents.pop()
        self.indicator(end, False)

    def block_sequence(self, items: list, mapping: bool) -> None:
        self.increase_indent(indentless=mapping and not self.indention)
        for item in items:
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.node(item)
        self.indent = self.indents.pop()

    def block_mapping(self, mapping: dict) -> None:
        self.increase_indent()
        for key, value in mapping.items():
            self.write_indent()
            text, _ = _represent(key)
            analysis = _Analysis(text)
            if len(text) >= 128 or analysis.empty or analysis.multiline:
                raise ValueError(f"the key {text[:40]!r} would be a complex key ('? '), which a config does not use")
            self.node(key, mapping=True, simple_key=True)
            self.indicator(":", False)
            self.node(value, mapping=True)
        self.indent = self.indents.pop()

    # scalars

    def scalar(self, text: str, plain_resolves: bool, simple_key: bool) -> None:
        analysis = _Analysis(text)
        split = not simple_key
        if plain_resolves and analysis.block_plain and not (simple_key and (analysis.empty or analysis.multiline)):
            self.plain(text, split)
        elif analysis.single_quoted and not (simple_key and analysis.multiline):
            self.single_quoted(text, split)
        else:
            self.double_quoted(text, split)

    def plain(self, text: str, split: bool) -> None:
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces, start = False, 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > _WIDTH and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.write(text[start:end])
                start = end
            spaces = ch == " "

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces = breaks = False
        start = 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if start + 1 == end and self.column > _WIDTH and split and start != 0 and end != len(text):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    if text[start] == "\n":
                        self.line_break()
                    for br in text[start:end]:
                        self.line_break(br)
                    self.write_indent()
                    start = end
            elif (ch is None or ch in " " + _BREAKS or ch == "'") and start < end:
                self.write(text[start:end])
                start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS
        self.indicator("'", False)

    def double_quoted(self, text: str, split: bool) -> None:
        self.indicator('"', True)
        start = 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' or not "\x20" <= ch <= "\x7e":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _ESCAPES:
                        self.write("\\" + _ESCAPES[ch])
                    elif ch <= "\xff":
                        self.write("\\x%02X" % ord(ch))
                    elif ch <= "\uffff":
                        self.write("\\u%04X" % ord(ch))
                    else:
                        self.write("\\U%08X" % ord(ch))
                    start = end + 1
            if 0 < end < len(text) - 1 and (ch == " " or start >= end) and self.column + (end - start) > _WIDTH \
                    and split:
                self.write(text[start:end] + "\\")
                start = max(start, end)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
        self.indicator('"', False)


def dumps(mapping: dict) -> str:
    """``yaml.safe_dump(mapping, sort_keys=False)`` of a config's mapping."""
    if not isinstance(mapping, dict):
        raise ValueError(f"a config is a mapping, not {type(mapping).__name__}")
    emitter = _Emitter()
    emitter.node(mapping)
    emitter.write_indent()  # the document's end
    return "".join(emitter.out)


def dump(mapping: dict, path: Union[str, Path]) -> None:
    """Write :func:`dumps` of ``mapping`` to ``path``."""
    Path(path).write_text(dumps(mapping))
