"""A reader and writer for the flat ``model_parameters.yml`` files:
``key: scalar`` lines and block lists (``key:`` followed by ``- item``
lines; an empty one ``key: []``).  Scalars resolve as YAML 1.1's safe loader resolves them (null,
bools, ints, floats, plain or quoted strings), so the result equals
``yaml.safe_load`` on these files without needing PyYAML, and what
:func:`dumps` writes, both read back unchanged."""

from __future__ import annotations

import re
from typing import Any, Dict

_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9][0-9_]*(\.[0-9_]*)?)([eE][-+][0-9]+)?$")
_BOOLS = {"true": True, "True": True, "TRUE": True, "yes": True, "Yes": True, "YES": True,
          "on": True, "On": True, "ON": True,
          "false": False, "False": False, "FALSE": False, "no": False, "No": False,
          "NO": False, "off": False, "Off": False, "OFF": False}
#: plain text that YAML 1.1 would read as another type (octal, hex, binary
#: or sexagesimal numbers, dates, the value and merge keys) or as syntax (a
#: leading indicator, "- " or "? ", ": " or " #" inside, a trailing colon)
_NOT_PLAIN = re.compile(r"^([-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+|[-+]?0b[01_]+"
                        r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*"
                        r"|[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?|=|<<"
                        r"|[\[\]{}*&!|>%@`'\"#,].*|[-?:]( .*)?|.*(: | #).*|.*:)$", re.S)


def scalar(text: str) -> Any:
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1].replace("''", "'") if s[0] == "'" else s[1:-1]
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s in _BOOLS:
        return _BOOLS[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if s.lower() in (".inf", "+.inf"):
        return float("inf")
    if s.lower() == "-.inf":
        return float("-inf")
    if s.lower() == ".nan":
        return float("nan")
    # YAML 1.1 floats need a dot ("1e-3" stays a string)
    if _FLOAT.match(s) and "." in s:
        return float(s.replace("_", ""))
    return s


def loads(text: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    current = None
    for raw in text.splitlines():
        line = raw.split(" #")[0].rstrip()
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if line.lstrip().startswith("- "):
            if current is None:
                raise ValueError(f"list item outside a key: {raw!r}")
            if out[current] is None:
                out[current] = []
            out[current].append(scalar(line.lstrip()[2:]))
            continue
        if line[0].isspace() or ":" not in line:
            raise ValueError(f"unsupported YAML line: {raw!r}")
        key, _, value = line.partition(":")
        if value.strip() == "[]":
            out[key.strip()] = []
            current = None
        elif value.strip():
            out[key.strip()] = scalar(value)
            current = None
        else:
            current = key.strip()
            out[current] = None  # a bare key is null until list items follow
    return out


def load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return loads(f.read())


def _format(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "e" in text and "." not in text:       # 1e-05 -> 1.0e-05 (YAML 1.1 float)
            mantissa, _, exponent = text.partition("e")
            text = f"{mantissa}.0e{exponent}"
        return text
    text = str(value)
    if scalar(text) != text or text != text.strip() or _NOT_PLAIN.match(text):
        return "'" + text.replace("'", "''") + "'"
    return text


def dumps(data) -> str:
    """Flat mapping of scalars and lists of scalars, or a list of scalars,
    -> YAML, keys sorted: the text of ``yaml.safe_dump(data, sort_keys=True)``."""
    if isinstance(data, (list, tuple)):
        return "\n".join(f"- {_format(v)}" for v in data) + "\n" if data else "[]\n"
    if not data:
        return "{}\n"
    lines = []
    for key in sorted(data):
        value = data[key]
        if not isinstance(value, (list, tuple)):
            lines.append(f"{key}: {_format(value)}")
        elif value:
            lines.append(f"{key}:")
            lines.extend(f"- {_format(v)}" for v in value)
        else:
            lines.append(f"{key}: []")
    return "\n".join(lines) + "\n"
