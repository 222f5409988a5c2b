"""A reader and writer for the YAML subset of the parameter and calibration
files, with no YAML library.

The subset (every file under ``examples/param`` and the reference's
calibration schema, whose test writer puts ``parameters: {cols: 1, rows: 1,
data: [0.0]}`` on one line): block mappings and sequences (``key: value``,
``- item``, a sequence at its parent key's indentation, ``- key: v``
items), flow lists ``[a, b]`` and flow mappings ``{k: v}`` that may span
lines, ``#`` comments, and scalars: int, float (``1.5``, ``12.0e-4``,
``1e-3``), bool (``true``, ``True``, ``false``, ``False``), null (``null``,
``~``, empty), plain strings and quoted strings without escapes. Scalars
resolve as PyYAML's ``safe_load`` resolves them (YAML 1.1), with one
exception: a number with an exponent and no dot (``1e-3``) is a float
here, as in YAML 1.2, where PyYAML keeps it a string. Anything else raises
``ValueError`` with its line number: anchors, tags, block scalars, tabs,
multiple documents, backslash escapes, and the YAML 1.1 scalars PyYAML
would not read as strings (``yes``/``no``/``on``/``off``, ``.inf``,
``.nan``, ``1_000``).

``dump`` writes mappings, lists and scalars in block style; what it writes
reads back equal through ``yaml.safe_load``, and through ``load`` where
every float is finite (a non-finite one is written ``.nan`` / ``.inf``, as
PyYAML writes it).
"""

from __future__ import annotations

import math
import re
from typing import Any

_BOOL = {"true": True, "True": True, "false": False, "False": False}
_NULL = ("", "~", "null")
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?([0-9]*\.[0-9]*([eE][-+]?[0-9]+)?"
                    r"|[0-9]+[eE][-+]?[0-9]+)$")
# YAML 1.1 scalars outside the subset that PyYAML reads as no string
_OUTSIDE = re.compile(r"(yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF|TRUE"
                      r"|FALSE|Null|NULL|[-+]?\.(inf|Inf|INF)|\.(nan|NaN|NAN)"
                      r"|[-+]?[0-9][0-9.eE+-]*_[0-9_.eE+-]*)$")


def _error(line: int, msg: str) -> ValueError:
    return ValueError(f"yaml_lite: line {line}: {msg}")


def scalar(text: str, line: int = 0) -> Any:
    """The value of one plain or quoted scalar."""
    s = text.strip()
    if s[:1] in ("'", '"'):
        return _quoted(s, line)
    if s[:1] in ("&", "*", "!", "|", ">", "%", "@", "`") or _OUTSIDE.match(s):
        raise _error(line, f"unsupported YAML construct {s!r}")
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s) and any(c.isdigit() for c in s):
        return float(s)
    return s


def _quoted(s: str, line: int) -> str:
    q = s[0]
    if len(s) < 2 or s[-1] != q:
        raise _error(line, f"unterminated quoted scalar {s!r}")
    if q == "'":
        return s[1:-1].replace("''", "'")
    if "\\" in s:
        raise _error(line, f"unsupported escape in {s!r}")
    return s[1:-1]


def _strip_comment(text: str) -> str:
    """``text`` without a trailing ``# comment`` (a ``#`` at the start or
    after a blank, outside quotes)."""
    quote, i = None, 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == quote and quote == "'" and text[i + 1:i + 2] == "'":
                i += 1                                  # '' inside '...'
            elif c == quote:
                quote = None
        elif c in ("'", '"') and (i == 0 or text[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _depth(text: str) -> int:
    """Open flow brackets left at the end of ``text`` (quotes skipped)."""
    d, quote = 0, None
    for c in text:
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"'):
            quote = c
        elif c in "[{":
            d += 1
        elif c in "]}":
            d -= 1
    return d


class _Flow:
    """Recursive-descent reader of one flow collection or scalar."""

    def __init__(self, text: str, line: int):
        self.s, self.i, self.line = text, 0, line

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self):
        self._ws()
        c = self.s[self.i:self.i + 1]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        return self._scalar(",]}")

    def _scalar(self, stops: str):
        self._ws()
        start = self.i
        if self.s[self.i:self.i + 1] in ("'", '"'):
            q = self.s[self.i]
            self.i += 1
            while self.i < len(self.s):
                if self.s[self.i] == q:
                    if q == "'" and self.s[self.i + 1:self.i + 2] == "'":
                        self.i += 2
                        continue
                    break
                self.i += 1
            self.i += 1
            return scalar(self.s[start:self.i], self.line)
        while self.i < len(self.s) and self.s[self.i] not in stops:
            if (self.s[self.i] == ":" and ":" in stops
                    and self.s[self.i + 1:self.i + 2] in (" ", "")):
                break
            self.i += 1
        return scalar(self.s[start:self.i], self.line)

    def _expect(self, c: str):
        self._ws()
        if self.s[self.i:self.i + 1] != c:
            raise _error(self.line, f"expected {c!r} in {self.s!r}")
        self.i += 1

    def _items(self, close: str, item) -> None:
        """``item()`` for each entry up to ``close`` (a trailing comma
        allowed)."""
        self._ws()
        while self.s[self.i:self.i + 1] != close:
            item()
            self._ws()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
                self._ws()
            elif c != close:
                raise _error(self.line, f"bad flow collection {self.s!r}")
        self.i += 1

    def _seq(self) -> list:
        self._expect("[")
        out: list = []
        self._items("]", lambda: out.append(self.value()))
        return out

    def _map(self) -> dict:
        self._expect("{")
        out: dict = {}

        def entry():
            key = self._scalar(",:}")
            self._expect(":")
            out[key] = self.value()
        self._items("}", entry)
        return out

    def whole(self):
        v = self.value()
        self._ws()
        if self.i != len(self.s):
            raise _error(self.line, f"trailing text in {self.s!r}")
        return v


def _inline(text: str, line: int):
    """A value written on its key's or item's line."""
    if text[:1] in ("[", "{"):
        return _Flow(text, line).whole()
    return scalar(text, line)


def _split_key(text: str, line: int):
    """(key, rest) of ``key: rest`` / ``key:``, or None if ``text`` is no
    mapping entry."""
    quote = None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
            continue
        if c in ("'", '"') and i == 0:
            quote = c
        elif c in "[{" and i == 0:
            return None
        elif c == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            key = scalar(text[:i], line)
            return key, text[i + 1:].strip()
    return None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Lines:
    """The document as (line number, indentation, text) without comments
    and blank lines, a multi-line flow collection joined into one."""

    def __init__(self, src: str):
        self.items: list[tuple[int, int, str]] = []
        pending = None
        for n, raw in enumerate(src.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise _error(n, "tab in indentation")
            text = _strip_comment(raw)
            if pending is not None:
                no, ind, acc = pending
                acc = acc + " " + text.strip()
                if _depth(acc) <= 0:
                    self.items.append((no, ind, acc))
                    pending = None
                else:
                    pending = (no, ind, acc)
                continue
            if not text.strip():
                continue
            if text.strip() in ("---", "..."):
                if self.items:
                    raise _error(n, "more than one document")
                continue
            ind = len(text) - len(text.lstrip(" "))
            if _depth(text) > 0:
                pending = (n, ind, text.strip())
            else:
                self.items.append((n, ind, text.strip()))
        if pending is not None:
            raise _error(pending[0], "unclosed flow collection")


def _block(lines: list, i: int, indent: int):
    """Parse the block node whose lines start at ``i`` with ``indent``.
    Returns (value, next index)."""
    n, ind, text = lines[i]
    if _is_item(text):
        return _sequence(lines, i, indent)
    if _split_key(text, n) is not None:
        return _mapping(lines, i, indent)
    if i + 1 < len(lines) and lines[i + 1][1] > indent:
        raise _error(lines[i + 1][0], "unexpected indentation")
    return _inline(text, n), i + 1


def _child(lines: list, i: int, indent: int, seq_ok: bool):
    """The nested value after ``key:`` / ``-`` at ``indent``: a deeper
    block, a sequence at the same indentation (for a key), or null."""
    if i < len(lines):
        _, ind, text = lines[i]
        if ind > indent:
            return _block(lines, i, ind)
        if seq_ok and ind == indent and _is_item(text):
            return _sequence(lines, i, indent)
    return None, i


def _mapping(lines: list, i: int, indent: int):
    out: dict = {}
    while i < len(lines):
        n, ind, text = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise _error(n, "unexpected indentation")
        kv = _split_key(text, n)
        if kv is None:
            if _is_item(text):
                break
            raise _error(n, f"expected 'key: value', got {text!r}")
        key, rest = kv
        if isinstance(key, (list, dict)):
            raise _error(n, "complex mapping key")
        if rest:
            out[key] = _inline(rest, n)
            i += 1
            if i < len(lines) and lines[i][1] > indent:
                raise _error(lines[i][0], "unexpected indentation")
        else:
            out[key], i = _child(lines, i + 1, indent, True)
    return out, i


def _sequence(lines: list, i: int, indent: int):
    out: list = []
    while i < len(lines):
        n, ind, text = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise _error(n, "unexpected indentation")
        if not _is_item(text):
            break
        rest = text[1:].strip()
        if not rest:
            val, i = _child(lines, i + 1, indent, False)
            out.append(val)
            continue
        # the item's text starts a node at its own column
        col = indent + (len(text) - len(rest))
        lines[i] = (n, col, rest)
        val, i = _block(lines, i, col)
        out.append(val)
    return out, i


def load(src: str) -> Any:
    """Parse a document of the subset (a string)."""
    lines = _Lines(src).items
    if not lines:
        return None
    val, i = _block(lines, 0, lines[0][1])
    if i != len(lines):
        raise _error(lines[i][0], "text after the document's top node")
    return val


def load_file(path) -> Any:
    with open(path) as f:
        return load(f.read())


# ---------------------------------------------------------------------------
# the emitter
# ---------------------------------------------------------------------------

def _plain_ok(s: str) -> bool:
    """``s`` reads back as itself when written unquoted."""
    if (not s or s != s.strip() or s == "-" or s.startswith("- ")
            or any(c in s for c in ":#[]{},&*!|>'\"%@`\\")):
        return False
    try:
        return scalar(s) == s
    except ValueError:
        return False


def _emit_scalar(v) -> str:
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
        # PyYAML reads a float only with a dot: 1e-05 → 1.0e-05
        return r if "." in r else r.replace("e", ".0e", 1)
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        return _emit_scalar(v.item())
    s = str(v)
    if "\n" in s:
        raise ValueError(f"yaml_lite: cannot write a multi-line string {s!r}")
    return s if _plain_ok(s) else "'" + s.replace("'", "''") + "'"


def _is_scalar(v) -> bool:
    return not isinstance(v, (dict, list, tuple))


def _emit(v, indent: int, out: list) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = _emit_scalar(k)
            if _is_scalar(x) or (isinstance(x, (list, tuple))
                                 and all(map(_is_scalar, x))) or not x:
                out.append(f"{pad}{key}: {_flow(x)}")
            else:
                out.append(f"{pad}{key}:")
                _emit(x, indent + 2, out)
    elif isinstance(v, (list, tuple)):
        for x in v:
            if _is_scalar(x) or not x or (isinstance(x, (list, tuple))
                                          and all(map(_is_scalar, x))):
                out.append(f"{pad}- {_flow(x)}")
            else:
                sub: list = []
                _emit(x, indent + 2, sub)
                sub[0] = pad + "- " + sub[0][indent + 2:]
                out.extend(sub)
    else:
        out.append(pad + _emit_scalar(v))


def _flow(v) -> str:
    """A scalar, an empty collection, or a list of scalars on one line."""
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _emit_scalar(v)


def dump(obj) -> str:
    """``obj`` (dicts, lists and tuples of scalars) as a block-style
    document."""
    out: list = []
    _emit(obj, 0, out)
    return "\n".join(out) + "\n"


def dump_file(path, obj) -> None:
    with open(path, "w") as f:
        f.write(dump(obj))
