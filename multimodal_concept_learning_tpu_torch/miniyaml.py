"""A YAML reader for the subset the repo's configs use (no PyYAML needed).

``safe_load`` returns what ``yaml.safe_load`` returns for: block mappings
and sequences (nested, including ``- - x`` and ``- key: value`` items, and
a sequence indented level with its parent key), flow ``{...}`` / ``[...]``
collections on one line, single- and double-quoted strings, comments, and
plain scalars resolved as PyYAML's YAML 1.1 resolver does (null, bool, int,
float; ``5e-4`` without a dot stays a string).  Anything else (anchors,
tags, block scalars, several documents, sexagesimal numbers, multi-line
flow collections) raises ``ValueError``.

``dump(mapping, stream)`` writes what ``yaml.dump(mapping, stream,
default_flow_style=False, sort_keys=False)`` writes for a mapping of str,
int, bool, None and lists of str (a dataset config): plain scalars where
PyYAML writes them plain, single quotes where a plain string would read
back as another type or holds an indicator; a string PyYAML would fold or
escape raises ``ValueError``.
"""

from __future__ import annotations

import re
from typing import List, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                               "OFF")}}
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")


def _resolve(text: str):
    """A plain scalar as YAML 1.1 (PyYAML's implicit resolvers) reads it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _SEXAGESIMAL.match(text):
        raise ValueError(f"sexagesimal number {text!r} is outside the supported YAML subset")
    if _INT.match(text):
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if len(s) > 1 and s[0] == "0":
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.match(text):
        s = text.replace("_", "").lower()
        if s.endswith(".inf"):
            return float("-inf") if s[0] == "-" else float("inf")
        if s.endswith(".nan"):
            return float("nan")
        return float(s)
    if text[0] in "&*!|>%@`":
        raise ValueError(f"{text!r}: YAML feature outside the supported subset")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted string starting at s[i]; returns (value, index after it)."""
    q = s[i]
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(e)
            if width is None:
                raise ValueError(f"unsupported escape \\{e} in {s!r}")
            out.append(chr(int(s[i + 2:i + 2 + width], 16)))
            i += 2 + width
            continue
        out.append(c)
        i += 1
    raise ValueError(f"unterminated quoted string in {s!r}")


class _Flow:
    """Recursive-descent reader of one line's flow collection."""

    def __init__(self, s: str):
        self.s, self.i = s, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self):
        self._ws()
        c = self.s[self.i]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in "\"'":
            v, self.i = _quoted(self.s, self.i)
            return v
        j = self.i
        while self.i < len(self.s) and self.s[self.i] not in ",]}" and \
                not (self.s[self.i] == ":" and self.s[self.i + 1:self.i + 2] in (" ", "")):
            self.i += 1
        return _resolve(self.s[j:self.i].strip())

    def _items(self, close: str, item):
        self.i += 1
        out = []
        while True:
            self._ws()
            if self.s[self.i] == close:
                self.i += 1
                return out
            out.append(item())
            self._ws()
            if self.s[self.i] == ",":
                self.i += 1
            elif self.s[self.i] != close:
                raise ValueError(f"malformed flow collection: {self.s!r}")

    def _seq(self):
        return self._items("]", self.value)

    def _pair(self):
        key = self.value()
        self._ws()
        if self.s[self.i] != ":":
            raise ValueError(f"flow mapping entry without ':' in {self.s!r}")
        self.i += 1
        return key, self.value()

    def _map(self):
        return dict(self._items("}", self._pair))


def _inline(text: str):
    """A value written on one line: flow collection, quoted or plain scalar."""
    if text[0] in "[{\"'":
        f = _Flow(text)
        try:
            v = f.value()
        except IndexError:
            raise ValueError(f"unterminated flow value {text!r}") from None
        if text[f.i:].strip():
            raise ValueError(f"trailing text after {text!r}")
        return v
    return _resolve(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_key(text: str):
    """(key, rest) of a mapping line ``key: rest``, or None."""
    if text[0] in "\"'":
        key, i = _quoted(text, 0)
    else:
        m = re.match(r"^([^:#\[\]{},]+?):(?:\s|$)", text)
        if m is None:
            return None
        key, i = _resolve(m.group(1).strip()), m.end(1)
    if text[i:i + 1] != ":" or text[i + 1:i + 2] not in ("", " ", "\t"):
        return None
    return key, text[i + 1:].strip()


class _Block:
    def __init__(self, text: str):
        self.lines: List[List] = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError("tab indentation is outside the supported YAML subset")
            line = _strip_comment(raw).rstrip()
            if not line.strip():
                continue
            if line.startswith(("---", "...", "%")):
                raise ValueError("document markers and directives are outside the subset")
            col = len(line) - len(line.lstrip(" "))
            self.lines.append([col, line.strip()])

    def node(self, i: int):
        col, text = self.lines[i]
        if text == "-" or text.startswith("- "):
            return self.seq(i, col)
        if _split_key(text) is not None:
            return self.map(i, col)
        return _inline(text), i + 1

    def seq(self, i: int, col: int):
        out = []
        while i < len(self.lines) and self.lines[i][0] == col and (
                self.lines[i][1] == "-" or self.lines[i][1].startswith("- ")):
            text = self.lines[i][1]
            rest = text[1:].lstrip()
            if not rest:
                if i + 1 < len(self.lines) and self.lines[i + 1][0] > col:
                    v, i = self.node(i + 1)
                else:
                    v, i = None, i + 1
            else:
                self.lines[i] = [col + len(text) - len(rest), rest]
                v, i = self.node(i)
            out.append(v)
        return out, i

    def map(self, i: int, col: int):
        out = {}
        while i < len(self.lines) and self.lines[i][0] == col:
            split = _split_key(self.lines[i][1])
            if split is None:
                break
            key, rest = split
            if key in out:
                raise ValueError(f"duplicate key {key!r}")
            if rest:
                out[key] = _inline(rest)
                i += 1
                continue
            i += 1
            nxt = self.lines[i] if i < len(self.lines) else None
            if nxt is not None and (nxt[0] > col or (nxt[0] == col and (
                    nxt[1] == "-" or nxt[1].startswith("- ")))):
                out[key], i = self.node(i)
            else:
                out[key] = None
        return out, i


def safe_load(stream):
    """Parse a YAML document of the supported subset (a str or a text file)."""
    text = stream if isinstance(stream, str) else stream.read()
    block = _Block(text)
    if not block.lines:
        return None
    value, i = block.node(0)
    if i != len(block.lines):
        raise ValueError(f"unparsed YAML from line {block.lines[i][1]!r}")
    return value


_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_DUMP_WIDTH = 80  # PyYAML's best_width


def _plain_ok(text: str) -> bool:
    """Whether PyYAML's emitter writes ``text`` as a plain scalar."""
    if not text or text[0] in " #,[]{}&*!|>'\"%@`" or text[-1] == " ":
        return False
    if text[0] in "-?:" and (len(text) == 1 or text[1] == " "):
        return False
    if ": " in text or " #" in text or text.endswith(":") or "\t" in text:
        return False
    if text in ("<<", "=") or _TIMESTAMP.match(text):
        return False
    try:
        return _resolve(text) == text
    except ValueError:
        return False


def _dump_scalar(value, column: int) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if not isinstance(value, str):
        raise ValueError(f"dump writes str, int, bool and None scalars, not {type(value)}")
    if not all(" " <= c <= "~" for c in value):
        raise ValueError(f"{value!r}: PyYAML would escape it; dump writes printable ASCII only")
    text = value if _plain_ok(value) else "'" + value.replace("'", "''") + "'"
    if " " in value and column + len(text) > _DUMP_WIDTH:
        raise ValueError(f"{value!r}: PyYAML would fold this string across lines")
    return text


def dump(data: dict, stream=None):
    """``yaml.dump(data, stream, default_flow_style=False, sort_keys=False)``
    for a mapping of scalars and lists of scalars; the text when ``stream``
    is None."""
    lines = []
    for key, value in data.items():
        if not isinstance(key, str) or not _plain_ok(key):
            raise ValueError(f"dump writes plain string keys, not {key!r}")
        if isinstance(value, (list, tuple)):
            if not value:
                lines.append(f"{key}: []")
                continue
            lines.append(f"{key}:")
            lines.extend(f"- {_dump_scalar(item, 2)}" for item in value)
        else:
            lines.append(f"{key}: {_dump_scalar(value, len(key) + 2)}")
    text = "".join(line + "\n" for line in lines) if lines else "{}\n"
    if stream is None:
        return text
    stream.write(text)
    return None


__all__ = ["dump", "safe_load"]
