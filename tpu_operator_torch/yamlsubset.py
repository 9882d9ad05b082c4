"""A small subset of YAML, read and written without PyYAML.

The reference reads its ConfigMaps and rendered manifests with
``yaml.safe_load``; the card's machine need not have PyYAML, so the port
reads YAML itself, the part its configs and manifests use: block mappings,
block lists (an item may itself be a block, as in ``- name: x``), one-line
flow sequences of scalars (``args: [-c, driver]``), and one-line scalars
(plain, single- or double-quoted) resolved as PyYAML's YAML 1.1 resolver
resolves them: ``null``/``~``, ``yes``/``no``/``true``/``false``/``on``/``off``,
decimal ints, floats with a dot; ``[]`` and ``{}`` for empty collections;
``#`` comments and a leading ``---``. :func:`parse` reads one document (a
ConfigMap's text, JSON first), :func:`parse_all` the documents of a
rendered manifest split by ``---``.

Everything else raises :class:`SubsetError` instead of being guessed at:
flow mappings, nested flow collections, anchors and aliases, tags, block
scalars (``|``, ``>``), multi-line scalars, tabs, directives, and plain
scalars PyYAML would read as something this reader does not (octal, hex,
``1_000``, ``1:30``, ``.inf``, dates, merge keys). A ConfigMap's caller
logs the error and uses its defaults, as the reference does for text
PyYAML cannot parse.

:func:`dump` writes a value in the subset (block style, strings
double-quoted), which is what the manifest renderer's ``toyaml`` filter
emits.
"""

from __future__ import annotations

import json
import re
from typing import List, NamedTuple, Tuple

_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?|\.[0-9]+(?:[eE][-+][0-9]+)?")
#: PyYAML's other implicit resolvers (YAML 1.1): a plain scalar they match
#: is not a string there, and not one this reader resolves
_OTHER = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
    r"|[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|<<|=|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*")
#: characters a plain scalar may not start with
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/"}


class SubsetError(ValueError):
    """The text is outside the YAML subset this module reads."""


class _Line(NamedTuple):
    number: int
    indent: int
    text: str


def parse(text: str):
    """The value of ``text``: JSON if it parses as JSON, else one document
    of the YAML subset. Raises :class:`SubsetError` for text outside both."""
    try:
        return json.loads(text)
    except ValueError:
        pass
    return _document(list(enumerate(text.splitlines(), 1)))


def parse_all(text: str) -> list:
    """The documents of ``text`` split at ``---`` lines, each one document
    of the subset; documents that hold only comments are left out
    (``yaml.safe_load_all`` gives them as None)."""
    docs: list = []
    current: list = []
    for number, raw in enumerate(text.splitlines(), 1):
        if raw.rstrip() == "---":
            docs.append(current)
            current = []
        else:
            current.append((number, raw))
    docs.append(current)
    values = (_document(lines) for lines in docs)
    return [value for value in values if value is not None]


def _document(numbered):
    lines: List[_Line] = []
    for number, raw in numbered:
        body = raw.rstrip()
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if "\t" in body[: len(body) - len(stripped) + 1]:
            raise SubsetError(f"line {number}: a tab in the indentation")
        if stripped == "---" and not lines and body == stripped:
            continue
        if stripped.startswith(("%", "---", "...")) and body == stripped:
            raise SubsetError(f"line {number}: directives and document markers")
        lines.append(_Line(number, len(body) - len(stripped), stripped))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0].indent)
    if i != len(lines):
        raise SubsetError(f"line {lines[i].number}: indentation does not match a parent")
    return value


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: List[_Line], i: int, indent: int) -> Tuple[object, int]:
    text = lines[i].text
    if _is_item(text):
        return _sequence(lines, i, indent)
    if _split_key(text, lines[i].number) is not None:
        return _mapping(lines, i, indent)
    value = _scalar(text, lines[i].number)
    if i + 1 < len(lines) and lines[i + 1].indent > indent:
        raise SubsetError(f"line {lines[i + 1].number}: a scalar spanning lines")
    return value, i + 1


def _mapping(lines: List[_Line], i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i].indent == indent:
        number = lines[i].number
        split = None if _is_item(lines[i].text) else _split_key(lines[i].text, number)
        if split is None:
            raise SubsetError(f"line {number}: expected 'key: value'")
        key, rest = split
        i += 1
        if rest:
            out[key] = _scalar(rest, number)
            if i < len(lines) and lines[i].indent > indent:
                raise SubsetError(f"line {lines[i].number}: a scalar spanning lines")
        elif i < len(lines) and lines[i].indent > indent:
            out[key], i = _block(lines, i, lines[i].indent)
        elif i < len(lines) and lines[i].indent == indent and _is_item(lines[i].text):
            out[key], i = _sequence(lines, i, indent)  # an indentless list
        else:
            out[key] = None
    if i < len(lines) and lines[i].indent > indent:
        raise SubsetError(f"line {lines[i].number}: unexpected indentation")
    return out, i


def _sequence(lines: List[_Line], i: int, indent: int) -> Tuple[list, int]:
    out: list = []
    lines = list(lines)  # an item's first line is rewritten in place
    while i < len(lines) and lines[i].indent == indent and _is_item(lines[i].text):
        number, text = lines[i].number, lines[i].text
        rest = text[1:].lstrip(" ")
        if not rest or rest.startswith("#"):
            i += 1
            if i < len(lines) and lines[i].indent > indent:
                value, i = _block(lines, i, lines[i].indent)
            else:
                value = None
        else:
            # the item's content is a block starting at its own column
            column = indent + len(text) - len(rest)
            lines[i] = _Line(number, column, rest)
            value, i = _block(lines, i, column)
        out.append(value)
    if i < len(lines) and lines[i].indent > indent:
        raise SubsetError(f"line {lines[i].number}: unexpected indentation")
    return out, i


def _quoted(text: str, number: int) -> Tuple[str, int]:
    """A quoted scalar at the start of ``text``: (value, index past it)."""
    quote, out, i = text[0], [], 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and ch == '"':
            return "".join(out), i + 1
        if quote == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise SubsetError(f"line {number}: escape \\{esc}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise SubsetError(f"line {number}: a quoted scalar spanning lines")


def _after_scalar(rest: str, number: int) -> None:
    if rest.strip() and not re.match(r"\s+#", rest):
        raise SubsetError(f"line {number}: text after a quoted scalar")


def _split_key(text: str, number: int):
    """``(key, rest)`` for a ``key: value`` line, else None."""
    if text[0] in "'\"":
        key, end = _quoted(text, number)
        if not (text[end:end + 1] == ":" and text[end + 1:end + 2] in ("", " ")):
            return None
        return key, _strip_comment(text[end + 1:].strip())
    if text[0] == "[":
        return None  # a flow sequence, whose items may hold ': '
    cut = len(text)
    comment = re.search(r"\s#", text)
    if comment:
        cut = comment.start()
    match = re.search(r":( |$)", text[:cut])
    if match is None:
        return None
    key = _plain(text[:match.start()].rstrip(), number)
    return key, _strip_comment(text[match.end():].strip())


def _strip_comment(text: str) -> str:
    if text.startswith("#"):
        return ""
    if text[:1] in ("'", '"'):
        return text
    comment = re.search(r"\s#", text)
    return text[:comment.start()].rstrip() if comment else text


def _scalar(text: str, number: int):
    if text[0] in "'\"":
        value, end = _quoted(text, number)
        _after_scalar(text[end:], number)
        return value
    if text[0] == "[" and _strip_comment(text) != "[]":
        return _flow_sequence(text, number)
    text = _strip_comment(text)
    if text in ("[]", "{}"):
        return [] if text == "[]" else {}
    return _plain(text, number)


def _flow_sequence(text: str, number: int) -> list:
    """A one-line flow sequence of scalars, ``[a, "b", 3]``."""
    out: list = []
    i = 1
    while True:
        while text[i:i + 1] == " ":
            i += 1
        if text[i:i + 1] in ("'", '"'):
            value, end = _quoted(text[i:], number)
            out.append(value)
            i += end
        else:
            end = i
            while end < len(text) and text[end] not in ",]":
                if text[end] in "[{}#" or text[end:end + 2] == ": ":
                    raise SubsetError(f"line {number}: {text!r} nests a flow collection")
                end += 1
            item = text[i:end].strip()
            if not item:
                raise SubsetError(f"line {number}: an empty flow item")
            out.append(_plain(item, number))
            i = end
        while text[i:i + 1] == " ":
            i += 1
        ch = text[i:i + 1]
        if ch == ",":
            i += 1
            continue
        if ch == "]":
            _after_scalar(text[i + 1:], number)
            return out
        raise SubsetError(f"line {number}: {text!r} is not a one-line flow sequence")


def _plain(text: str, number: int):
    if text[:1] in _INDICATORS and not (text[:1] == "-" and text[1:2] not in ("", " ")):
        raise SubsetError(f"line {number}: {text!r} starts with an indicator")
    if ": " in text or text.endswith(":") or any(ord(c) < 0x20 for c in text):
        raise SubsetError(f"line {number}: {text!r} is not a plain scalar")
    if text in _NULLS:
        return None
    if text in _TRUE or text in _FALSE:
        return text in _TRUE
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _OTHER.fullmatch(text):
        raise SubsetError(f"line {number}: {text!r} resolves outside the subset")
    return text


# -- writing ----------------------------------------------------------------------

_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_./-]*")
_ESCAPED = re.compile(r'"(?:[^\\]|\\[\\"nt/])*"')


def dump(value, indent: int = 0) -> str:
    """``value`` as block YAML in the subset, every line indented by
    ``indent`` spaces, with no trailing newline: mappings and lists in block
    style, strings double-quoted, empty collections as ``{}`` and ``[]``.
    Raises :class:`SubsetError` for what the subset cannot hold (a
    non-finite float, a string with a control character it cannot
    escape, a key that is not a string)."""
    pad = " " * indent
    return "\n".join(pad + line for line in _dump_lines(value))


def _dump_lines(value) -> List[str]:
    if isinstance(value, dict) and value:
        lines = []
        for key, item in value.items():
            head = f"{_key(key)}:"
            if isinstance(item, (dict, list)) and item:
                lines.append(head)
                lines += ["  " + line for line in _dump_lines(item)]
            else:
                lines.append(f"{head} {_scalar_text(item)}")
        return lines
    if isinstance(value, list) and value:
        lines = []
        for item in value:
            inner = _dump_lines(item)
            lines.append("- " + inner[0])
            lines += ["  " + line for line in inner[1:]]
        return lines
    return [_scalar_text(value)]


def _key(key) -> str:
    if not isinstance(key, str):
        raise SubsetError(f"a mapping key that is not a string: {key!r}")
    if _PLAIN_KEY.fullmatch(key) and _plain(key, 0) == key:
        return key
    return _scalar_text(key)


def _scalar_text(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value or value in (float("inf"), float("-inf")):
            raise SubsetError(f"{value!r} has no form in the subset")
        text = repr(value)
        if "." not in text:  # 1e+20: YAML 1.1 reads a float only with a dot
            mantissa, _, exponent = text.partition("e")
            text = f"{mantissa}.0" + (f"e{exponent}" if exponent else "")
        return text
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    text = json.dumps(str(value), ensure_ascii=False)
    # every escape must be one the reader reads back: an escaped backslash
    # or quote, \n, \t and \/ are; \u0001, \r, \b and \f are not
    if not _ESCAPED.fullmatch(text):
        raise SubsetError(f"{value!r} holds a character the subset cannot escape")
    return text
