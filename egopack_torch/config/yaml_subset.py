"""A reader for the subset of YAML that ``configs/`` uses, typed as
``yaml.safe_load`` types it (YAML 1.1 resolution).

The subset: block maps by indentation; ``- item`` and ``- key: value``
block lists (also at the parent key's indentation); flow lists of scalars
(``[ar, lta]``); ``#`` comments; plain, single-quoted and double-quoted
scalars. Plain scalars resolve as PyYAML's ``SafeLoader`` resolves them:
``1e-5`` stays the string ``'1e-5'`` (YAML 1.1 floats need a dot),
``1.0e-5`` is a float, ``yes``/``True``/``on`` are booleans, ``~`` and
``null`` are None, ``0x10`` and ``017`` are ints in base 16 and 8.

Anything outside the subset (flow maps, anchors, tags, block scalars,
multi-line plain scalars, dates, several documents, non-string keys)
raises :class:`YamlSubsetError`; nothing is guessed.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

__all__ = ["YamlSubsetError", "load", "load_file", "parse_scalar"]


class YamlSubsetError(ValueError):
    """The text is not in the YAML subset this reader covers."""


# PyYAML's implicit resolvers (yaml/resolver.py), the SafeLoader's types
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+"
                  r"|[-+]?0[0-7_]+"
                  r"|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}
# first characters that start a construct outside the subset
_BAD_START = set("{&*!|>%@`")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value: str) -> float:
    digits = [float(part) for part in value.split(":")]
    out, base = 0.0, 1
    for digit in reversed(digits):
        out += digit * base
        base *= 60
    return out


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * int(_sexagesimal(value))
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value)
    return sign * float(value)


def _plain(text: str, where: str) -> Any:
    """Type a plain (unquoted) scalar as the SafeLoader does."""
    if text and (text[0] in _BAD_START or text.startswith(("? ", "- "))
                 or text in ("-", "?") or ": " in text or text.endswith(":")
                 or text in ("<<", "=") or "\t" in text):
        raise YamlSubsetError(f"{where}: {text!r} is outside the YAML subset")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if _INT.match(text):
        return _construct_int(text)
    if _FLOAT.match(text):
        return _construct_float(text)
    if _TIMESTAMP.match(text):
        raise YamlSubsetError(f"{where}: timestamp {text!r} is outside the "
                              "YAML subset")
    return text


def _quoted_end(text: str, start: int, where: str) -> int:
    """Index just past the quoted scalar that opens at ``text[start]``."""
    quote = text[start]
    i = start + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if i + 1 < len(text) and text[i + 1] == "'":
                i += 2
                continue
            return i + 1
        if quote == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                return i + 1
        i += 1
    raise YamlSubsetError(f"{where}: unterminated quoted scalar")


def _unquote(text: str, where: str) -> str:
    if text[0] == "'":
        return text[1:-1].replace("''", "'")
    body, out, i = text[1:-1], [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        esc = body[i + 1] if i + 1 < len(body) else ""
        if esc in _ESCAPES:
            out.append(_ESCAPES[esc])
            i += 2
        elif esc in _HEX_ESCAPES:
            n = _HEX_ESCAPES[esc]
            code = body[i + 2:i + 2 + n]
            if len(code) != n or not re.fullmatch(r"[0-9a-fA-F]+", code):
                raise YamlSubsetError(f"{where}: bad escape \\{esc}{code}")
            out.append(chr(int(code, 16)))
            i += 2 + n
        else:
            raise YamlSubsetError(f"{where}: escape \\{esc} is outside the "
                                  "YAML subset")
    return "".join(out)


def _strip_comment(line: str, where: str) -> str:
    """The line without its ``#`` comment (a ``#`` at the start or after
    white space, outside quotes), right-stripped."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[,-:"):
            i = _quoted_end(line, i, where)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _flow_list(text: str, where: str) -> List[Any]:
    if not text.endswith("]"):
        raise YamlSubsetError(f"{where}: {text!r} is outside the YAML subset")
    body = text[1:-1].strip()
    items: List[Any] = []
    i = 0
    while body and i <= len(body):
        while i < len(body) and body[i] == " ":
            i += 1
        if i < len(body) and body[i] in "'\"":
            end = _quoted_end(body, i, where)
            items.append(_unquote(body[i:end], where))
            rest = body[end:].lstrip()
            if rest and not rest.startswith(","):
                raise YamlSubsetError(f"{where}: text after a quoted item")
            i = len(body) - len(rest) + 1
            continue
        end = body.find(",", i)
        end = len(body) if end < 0 else end
        item = body[i:end].strip()
        if any(c in item for c in "[]{}") or (not item and end < len(body)):
            raise YamlSubsetError(f"{where}: {text!r} is outside the YAML "
                                  "subset")
        if item or end < len(body):
            items.append(_plain(item, where))
        i = end + 1
    return items


def parse_scalar(text: str, where: str = "<value>") -> Any:
    """One value on one line: a flow list, a quoted scalar or a plain
    scalar, typed as ``yaml.safe_load`` types it."""
    text = text.strip()
    if text.startswith("["):
        return _flow_list(text, where)
    if text[:1] in ("'", '"'):
        end = _quoted_end(text, 0, where)
        if text[end:].strip():
            raise YamlSubsetError(f"{where}: text after a quoted scalar")
        return _unquote(text, where)
    return _plain(text, where)


class _Lines:
    """Non-blank, comment-free lines as (indent, text, line number)."""

    def __init__(self, text: str, name: str):
        self.name = name
        self.items: List[Tuple[int, str, int]] = []
        for no, raw in enumerate(text.splitlines(), 1):
            where = f"{name}:{no}"
            line = _strip_comment(raw, where)
            if not line.strip():
                continue
            body = line.lstrip(" ")
            if body.startswith("\t"):
                raise YamlSubsetError(f"{where}: tab in indentation")
            if body in ("---", "...") or body.startswith(("--- ", "%")):
                raise YamlSubsetError(f"{where}: document markers and "
                                      "directives are outside the YAML subset")
            self.items.append((len(line) - len(body), body, no))

    def where(self, i: int) -> str:
        return f"{self.name}:{self.items[i][2]}"


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _split_key(text: str, where: str):
    """``key: value`` -> (key, value text) or None when ``text`` is no
    map entry."""
    if text[:1] in ("'", '"'):
        end = _quoted_end(text, 0, where)
        key, rest = _unquote(text[:end], where), text[end:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    m = re.search(r":( |$)", text)
    if m is None:
        return None
    key = _plain(text[:m.start()].strip(), where)
    if not isinstance(key, str):
        raise YamlSubsetError(f"{where}: non-string key {key!r} is outside "
                              "the YAML subset")
    return key, text[m.end():].strip()


def _block(lines: _Lines, i: int, indent: int) -> Tuple[Any, int]:
    """Parse the block whose first line is ``lines.items[i]`` at
    ``indent``; returns (value, index of the next line)."""
    if _is_item(lines.items[i][1]):
        return _list(lines, i, indent)
    return _map(lines, i, indent)


def _value(lines: _Lines, i: int, indent: int, text: str,
           where: str) -> Tuple[Any, int]:
    """The value of a map entry or list item whose inline text is
    ``text``, at line ``i`` and column ``indent``; returns (value, next)."""
    if text:
        return parse_scalar(text, where), i + 1
    nxt = i + 1
    if nxt < len(lines.items):
        n_indent, n_text, _ = lines.items[nxt]
        if n_indent > indent or (n_indent == indent and _is_item(n_text)):
            return _block(lines, nxt, n_indent)
    return None, nxt


def _map(lines: _Lines, i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(lines.items):
        ind, text, _ = lines.items[i]
        if ind < indent:
            break
        where = lines.where(i)
        if ind > indent or _is_item(text):
            raise YamlSubsetError(f"{where}: unexpected indentation")
        entry = _split_key(text, where)
        if entry is None:
            raise YamlSubsetError(f"{where}: {text!r} is not a map entry "
                                  "(multi-line scalars are outside the "
                                  "YAML subset)")
        key, rest = entry
        out[key], i = _value(lines, i, indent, rest, where)
    return out, i


def _list(lines: _Lines, i: int, indent: int) -> Tuple[list, int]:
    out: list = []
    while i < len(lines.items):
        ind, text, no = lines.items[i]
        if ind < indent or (ind == indent and not _is_item(text)):
            break
        where = lines.where(i)
        if ind > indent:
            raise YamlSubsetError(f"{where}: unexpected indentation")
        rest = text[1:].lstrip(" ")
        col = ind + len(text) - len(rest)
        if _is_item(rest):
            raise YamlSubsetError(f"{where}: nested inline lists are outside "
                                  "the YAML subset")
        if rest[:1] not in ("", "[") and _split_key(rest, where):
            # "- key: value": a map whose first entry sits on this line
            lines.items[i] = (col, rest, no)
            value, i = _map(lines, i, col)
        else:
            value, i = _value(lines, i, ind, rest, where)
        out.append(value)
    return out, i


def load(text: str, name: str = "<string>") -> Any:
    """Parse ``text``; an empty document is None, as for ``safe_load``."""
    lines = _Lines(text, name)
    if not lines.items:
        return None
    indent, body, _ = lines.items[0]
    if len(lines.items) == 1 and not _is_item(body) \
            and _split_key(body, lines.where(0)) is None:
        return parse_scalar(body, lines.where(0))
    value, i = _block(lines, 0, indent)
    if i != len(lines.items):
        raise YamlSubsetError(f"{lines.where(i)}: unexpected indentation")
    return value


def load_file(path: str) -> Any:
    with open(path, "r") as f:
        return load(f.read(), path)
