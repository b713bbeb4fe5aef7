"""A reader and emitter for the YAML subset of the repo's configs.

The port does not depend on PyYAML (the GPU machines it runs on need not
have it).  The subset is what `conf/base9.yaml` and the settings files
use:

- block mappings, each level indented further than its parent (two
  spaces by convention), keys plain words;
- values: plain or quoted scalars, resolved as PyYAML's `safe_load`
  resolves them (int, float, bool, null, str), or flow lists of such
  scalars (`[U, B, V]`, `[12.0, 13.0]`, `[]`);
- `#` comments, on a line of their own or after a value;
- empty values (`key:` with nothing under it is null).

Anything else raises ValueError rather than being guessed at: anchors and
aliases, tags, block sequences, block and multi-line scalars, flow
mappings, nested lists, document markers, tabs, duplicate keys, and the
scalar forms PyYAML reads in ways a config never means (octal, hex,
sexagesimal, underscores, dates).
"""
from __future__ import annotations

import math
import re

# PyYAML's implicit resolvers (YAML 1.1), restricted to the forms allowed.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = ("yes", "true", "on")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9]*\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9]+(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
# Forms PyYAML resolves to something a config never means, or refuses.
_REFUSED = re.compile(
    r"^(?:[-+]?0b[01_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"   # int bases
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"      # sexagesimal
    r"|[-+]?[0-9][0-9_]*(?:\.[0-9_]*)?(?:[eE][-+][0-9]+)?"    # underscores
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*"                      # timestamps
    r"|=|<<)$"
)
_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_INDICATORS = "&*!|>%@`{}[]"


def _fail(lineno: int, msg: str):
    raise ValueError(f"YAML line {lineno}: {msg} (outside the subset the "
                     f"settings reader accepts)")


def _plain(text: str, lineno: int):
    """Resolve a plain scalar as PyYAML's safe_load does."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _INF.match(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.match(text):
        return math.nan
    if _REFUSED.match(text):
        _fail(lineno, f"ambiguous scalar {text!r}")
    if text[0] in _INDICATORS + ",#'\"" or (
            text[0] in "-?:" and (len(text) == 1 or text[1] == " ")):
        _fail(lineno, f"scalar {text!r} starts with an indicator")
    if ": " in text or text.endswith(":"):
        _fail(lineno, f"scalar {text!r} holds a mapping")
    return text


def _quoted(text: str, lineno: int) -> tuple[str, str]:
    """(value, rest of the line) of a quoted scalar at the start of text."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            _fail(lineno, "escape sequence in a double-quoted scalar")
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        out.append(c)
        i += 1
    _fail(lineno, "quoted scalar not closed on its line (multi-line string)")


def _strip_comment(rest: str, lineno: int) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        _fail(lineno, f"text {rest!r} after a quoted scalar")


def _value(text: str, lineno: int):
    """Resolve the value text of a `key: value` line (comment included)."""
    text = text.strip()
    if not text or text.startswith("#"):
        return None
    if text[0] in "'\"":
        value, rest = _quoted(text, lineno)
        _strip_comment(rest, lineno)
        return value
    if text[0] == "[":
        return _flow_list(text, lineno)
    cut = re.search(r"\s#", text)
    if cut:
        text = text[:cut.start()].rstrip()
    return _plain(text, lineno)


def _flow_list(text: str, lineno: int) -> list:
    items = []
    body = text[1:]
    if body.lstrip().startswith("]"):
        _strip_comment(body.lstrip()[1:], lineno)
        return []
    while True:
        body = body.lstrip()
        if not body:
            _fail(lineno, "flow list not closed on its line")
        if body[0] in "'\"":
            item, body = _quoted(body, lineno)
        else:
            m = re.match(r"[^,\[\]{}#]*", body)
            raw = m.group(0).strip()
            body = body[m.end():]
            if not raw:
                _fail(lineno, "empty or nested item in a flow list")
            item = _plain(raw, lineno)
        items.append(item)
        body = body.lstrip()
        if body.startswith(","):
            body = body[1:]
            if body.lstrip().startswith("]"):
                _fail(lineno, "trailing comma in a flow list")
            continue
        if body.startswith("]"):
            _strip_comment(body[1:], lineno)
            return items
        _fail(lineno, f"unexpected {body[:1]!r} in a flow list")


def safe_load(text: str):
    """Parse the subset: a dict of the document's mappings (None for an
    empty document), equal to what `yaml.safe_load` returns for it."""
    root: dict = {}
    # Open mappings: (indent, dict).  The root sits at indent -1.
    stack: list[tuple[int, dict]] = [(-1, root)]
    pending = None   # (indent, dict, key) of a `key:` with an empty value
    seen = False
    for lineno, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            _fail(lineno, "tab in indentation")
        body = raw.strip()
        if not body or body.startswith("#"):
            continue
        if raw.startswith(("---", "...")):
            _fail(lineno, "document marker")
        indent = len(raw) - len(raw.lstrip(" "))
        if body.startswith(("- ", "? ")) or body in ("-", "?"):
            _fail(lineno, "block sequence or complex key")
        m = re.match(r"^([^\s:#'\"][^:#]*?)\s*:(?:\s+(.*))?$", body)
        if not m:
            _fail(lineno, f"expected `key: value`, got {body!r}")
        key, rest = m.group(1), m.group(2) or ""
        if not _KEY.match(key) or _NULL.match(key) or _BOOL.match(key):
            _fail(lineno, f"key {key!r} is not a plain word")
        if pending is not None:
            p_indent, p_map, p_key = pending
            if indent > p_indent:
                p_map[p_key] = {}
                stack.append((indent, p_map[p_key]))
            pending = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            if stack[-1][0] == -1 and not seen:
                stack[-1] = (indent, root)
            else:
                _fail(lineno, "indentation does not match an open mapping "
                              "(a multi-line scalar?)")
        seen = True
        current = stack[-1][1]
        if key in current:
            _fail(lineno, f"duplicate key {key!r}")
        value = _value(rest, lineno)
        current[key] = value
        if value is None:
            pending = (indent, current, key)
    return root if seen else None


# ---- emitter ----------------------------------------------------------------


def _scalar(v) -> str:
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
        # PyYAML's representer: a float always carries a dot.
        r = repr(v).lower()
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        try:
            plain = bool(v) and _plain(v, 0) == v
        except ValueError:
            plain = False
        if plain and v == v.strip() and not any(c in v for c in "#:,"):
            return v
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(f"cannot emit {type(v).__name__} {v!r} in the subset")


def safe_dump(doc: dict) -> str:
    """Emit a dict of mappings, scalars and flat lists in the subset (flow
    lists, two-space indents, keys in the dict's order)."""
    lines: list[str] = []

    def emit(d: dict, indent: int):
        for k, v in d.items():
            if not isinstance(k, str) or not _KEY.match(k):
                raise ValueError(f"cannot emit key {k!r} in the subset")
            pad = " " * indent
            if isinstance(v, dict):
                lines.append(f"{pad}{k}:")
                emit(v, indent + 2)
            elif isinstance(v, (list, tuple)):
                lines.append(f"{pad}{k}: [" + ", ".join(
                    _scalar(x) for x in v) + "]")
            else:
                lines.append(f"{pad}{k}: {_scalar(v)}")

    emit(doc, 0)
    return "\n".join(lines) + "\n"
