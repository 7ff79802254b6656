"""YAML configuration files without a YAML package (port of
``rot_mvgaze_tpu/utils/config.py``).

:func:`load_yaml` reads the subset of YAML that the repository's files use
(``configs/subject/*.yaml``, the user's ``data_path.yaml``, model configs):

- comments (a line of its own, or `` #`` after a value) and blank lines;
- nested block mappings, ``key: value`` or ``key:`` and an indented block;
- block lists of scalars, ``- value``, indented under their key or not;
- scalars: int, float, bool, null (YAML 1.1's plain forms, as
  ``yaml.safe_load`` resolves them) and plain, single- or double-quoted
  strings on one line.

It returns what ``yaml.safe_load`` returns for such a file. Anything else
(flow collections, anchors and aliases, tags, block scalars, multi-line
strings, backslash escapes, quoted or complex keys, directives and document
markers, duplicate keys, the YAML 1.1 forms of numbers and dates that are
easy to misread: octal, binary, sexagesimal, underscores, timestamps) raises
``ValueError`` naming the line.

:func:`build_model_from_cfg` builds a model from such a file::

    type: rot_mvgaze_tpu_torch.models.FeatRotationSymm
    params:
      backbone_depth: 18
      num_iter: 2

A ``type`` under the JAX package (``rot_mvgaze_tpu.``) names the same path
in the port, so a configuration written for either package builds the port's
model.
"""

from __future__ import annotations

import importlib
import re
from typing import Any, List, Optional, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?|\.[0-9]+(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
# YAML 1.1 forms that yaml.safe_load turns into numbers or dates, outside
# the subset: octal, binary, hex, sexagesimal and underscored numbers,
# timestamps, the merge key and the value key
_REFUSED = re.compile(
    r"""^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
    |[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:(?:[Tt]|[ \t]+).*)?
    |<<|=)$""",
    re.X,
)
# a plain scalar may not start with these (YAML's indicators)
_INDICATORS = set("[]{},#&*!|>'\"%@`")


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str) -> None:
        self.no, self.indent, self.text = no, indent, text


def _error(line: Any, msg: str) -> ValueError:
    no = line.no if isinstance(line, _Line) else line
    return ValueError(f"line {no}: {msg} (outside the YAML subset load_yaml reads)")


def _resolve(text: str, no: int) -> Any:
    """A plain scalar as ``yaml.safe_load`` resolves it."""
    if _NULL.match(text):
        return None
    if _TRUE.match(text):
        return True
    if _FALSE.match(text):
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    m = _INF.match(text)
    if m:
        return float(m.group(1) + "inf")
    if _NAN.match(text):
        return float("nan")
    if _REFUSED.match(text):
        raise _error(no, f"the scalar {text!r} is a YAML 1.1 number or date form")
    return text


def _quoted(text: str, no: int) -> Tuple[str, str]:
    """``(value, rest)`` of a quoted scalar at the start of ``text``: ``''``
    is a quote inside single quotes; a backslash inside double quotes is
    refused (no escape is decoded)."""
    quote = text[0]
    out: List[str] = []
    i = 1
    while i < len(text):
        c = text[i]
        if c == quote:
            if quote == "'" and text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1 :]
        if c == "\\" and quote == '"':
            raise _error(no, "a backslash escape in a double-quoted string")
        out.append(c)
        i += 1
    raise _error(no, "a quoted string continues on the next line")


def _only_comment(rest: str, no: int) -> None:
    rest = rest.strip(" \t")
    if rest and not rest.startswith("#"):
        raise _error(no, f"unexpected {rest!r} after a quoted string")


def _scalar(text: str, no: int) -> Any:
    """The scalar ``text`` (a value, after ``key:`` or ``- ``), with any
    trailing comment."""
    text = text.strip(" \t")
    if not text or text.startswith("#"):
        return None
    if text[0] in "'\"":
        value, rest = _quoted(text, no)
        _only_comment(rest, no)
        return value
    if text[0] in _INDICATORS or (text[0] in "-?:" and text[1:2] in ("", " ", "\t")):
        raise _error(no, f"the value {text!r} starts with an indicator (flow collection, "
                         "anchor, alias, tag, block scalar or nested item)")
    m = re.search(r"[ \t]#", text)
    if m:
        text = text[: m.start()].rstrip(" \t")
    if re.search(r":(?:[ \t]|$)", text):
        raise _error(no, f"a mapping inside the value {text!r}")
    return _resolve(text, no)


def _key(text: str, no: int) -> Tuple[Any, str]:
    """``(key, rest after the colon)`` of a ``key: value`` line."""
    if text[0] in _INDICATORS or text[0] in "?:":  # quoted and complex keys among them
        raise _error(no, f"the line {text!r} starts with an indicator")
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        raise _error(no, f"expected 'key: value', got {text!r}")
    key = text[: m.start()].rstrip(" \t")
    if re.search(r"[ \t]#", key):
        raise _error(no, f"expected 'key: value', got {text!r}")
    return _resolve(key, no), text[m.end() :]


def _is_item(line: _Line) -> bool:
    return line.text == "-" or line.text.startswith(("- ", "-\t"))


class _Parser:
    def __init__(self, lines: List[_Line]) -> None:
        self.lines = lines
        self.i = 0

    def peek(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        line = self.peek()
        return self.sequence(indent) if _is_item(line) else self.mapping(indent)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _error(line, "a nested block under a list item (only lists of scalars)")
            if not _is_item(line):
                return out
            self.i += 1
            out.append(_scalar(line.text[1:], line.no))
            nxt = self.peek()
            if nxt is not None and nxt.indent > indent:
                raise _error(nxt, "a nested block or multi-line value under a list item")

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _error(line, "unexpected indentation")
            if _is_item(line):
                raise _error(line, "a list item inside a mapping")
            self.i += 1
            key, rest = _key(line.text, line.no)
            if key in out:
                raise _error(line, f"duplicate key {key!r}")
            value = _scalar(rest, line.no)
            nxt = self.peek()
            if rest.strip(" \t") and not rest.strip(" \t").startswith("#"):
                if nxt is not None and nxt.indent > indent:
                    raise _error(nxt, "a multi-line value")
            elif nxt is not None and nxt.indent > indent:
                value = self.block(nxt.indent)
            elif nxt is not None and nxt.indent == indent and _is_item(nxt):
                value = self.sequence(indent)  # a list not indented under its key
            out[key] = value


def load_yaml(path: str) -> Any:
    """The contents of the YAML file at ``path`` (the subset in the module's
    docstring), as ``yaml.safe_load`` returns them; None for an empty file."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    lines = []
    for no, raw in enumerate(source.lstrip("\ufeff").splitlines(), start=1):
        body = raw.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        if body[0] == "\t":
            raise _error(no, "a tab in the indentation")
        lines.append(_Line(no, len(raw) - len(body), body.rstrip(" \t")))
    if not lines:
        return None
    parser = _Parser(lines)
    if lines[0].indent:
        raise _error(lines[0], "the document starts indented")
    result = parser.block(0)
    if parser.peek() is not None:
        raise _error(parser.peek(), "unexpected line")
    return result


def build_model_from_cfg(cfg_path: str) -> Any:
    """Import ``type`` from the config at ``cfg_path`` and call it with
    ``params`` (an empty ``params:`` means no arguments)."""
    cfg = load_yaml(cfg_path)
    path = cfg["type"]
    if path.startswith("rot_mvgaze_tpu."):
        path = "rot_mvgaze_tpu_torch." + path[len("rot_mvgaze_tpu."):]
    module, cls = path.rsplit(".", 1)
    ctor = getattr(importlib.import_module(module), cls)
    return ctor(**(cfg.get("params") or {}))
