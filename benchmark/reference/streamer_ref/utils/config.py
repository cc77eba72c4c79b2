"""Typed key-value configuration store.

Re-implements the semantics of the reference's vendored config_fortran
(``src/config_fortran/m_config.f90``):

* one or more ``.cfg`` files with ``key = value`` lines and ``[section]``
  headers that prefix following keys as ``section%key``
  (``m_config.f90:145-186``);
* command-line overrides ``-key=value``;
* values are parsed according to the *registered* default's type
  (``add_get`` registers default + docstring and reads back any override);
* variable-size arrays (space-separated values);
* the fully resolved configuration can be written back out
  (self-documenting dump, ``m_config.f90:131-132``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence


def _parse_bool(s: str) -> bool:
    t = s.strip().lower()
    if t in ("t", "true", ".true.", "1"):
        return True
    if t in ("f", "false", ".false.", "0"):
        return False
    raise ValueError(f"cannot parse logical value {s!r}")


class CFG:
    """Configuration store: raw strings from files/CLI, typed on registration."""

    def __init__(self) -> None:
        self._raw: Dict[str, str] = {}  # unparsed values from files / CLI
        self._values: Dict[str, Any] = {}  # typed values after registration
        self._docs: Dict[str, str] = {}
        self._dynamic: Dict[str, bool] = {}
        self._order: List[str] = []

    # ------------------------------------------------------------------ input
    @staticmethod
    def _trim_comment(line: str) -> str:
        """Remove '#' / ';' comments, respecting quotes (trim_comment)."""
        out = []
        quote = None
        for ch in line:
            if quote:
                out.append(ch)
                if ch == quote:
                    quote = None
            elif ch in "'\"":
                quote = ch
                out.append(ch)
            elif ch in "#;":
                break
            else:
                out.append(ch)
        return "".join(out)

    def read_file(self, fname: str) -> None:
        """Parse a .cfg file. Exact semantics of the reference's parse_line
        (``m_config.f90:288-354``): a ``[section]`` header sets the category,
        which applies only to keys indented by at least two spaces or a tab;
        unindented keys are global."""
        section = ""
        with open(fname) as f:
            for raw_line in f:
                line = self._trim_comment(raw_line.rstrip("\n"))
                if line.strip() == "":
                    continue
                if "=" not in line:
                    m = re.match(r"^\s*\[(.+)\]\s*$", line)
                    if m:
                        section = m.group(1).strip()
                        continue
                    raise ValueError(f"cannot parse config line: {raw_line!r}")
                key_part, _, val = line.partition("=")
                append = key_part.endswith("+")
                if append:
                    key_part = key_part[:-1]
                indented = key_part.startswith("  ") or key_part.startswith("\t")
                key = key_part.strip()
                if section and indented:
                    key = f"{section}%{key}"
                if append:
                    key += "+"
                self._store_raw(key, val.strip())

    def update_from_arguments(self, argv: Sequence[str]) -> None:
        """Handle ``file.cfg`` and ``-key=value`` arguments
        (``m_config.f90`` CFG_update_from_arguments)."""
        for arg in argv:
            if arg.startswith("-") and "=" in arg:
                key, _, val = arg[1:].partition("=")
                self._store_raw(key.strip(), val.strip())
            elif arg.endswith(".cfg"):
                self.read_file(arg)
            else:
                raise ValueError(f"unrecognized argument: {arg}")

    def _store_raw(self, key: str, val: str) -> None:
        if key.endswith("+"):  # appending syntax "key+= value"
            key = key[:-1].strip()
            if key in self._raw:
                self._raw[key] = self._raw[key] + " " + val
                if key in self._values:  # re-parse if already typed
                    self._reparse(key)
                return
        self._raw[key] = val
        if key in self._values:
            self._reparse(key)

    def _reparse(self, key: str) -> None:
        old = self._values[key]
        self._values[key] = self._parse(key, self._raw[key], old)

    # ------------------------------------------------------------- typed API
    def _parse(self, key: str, raw: str, default: Any) -> Any:
        try:
            if isinstance(default, (list, tuple)) and len(default) > 0 or (
                isinstance(default, (list, tuple)) and self._dynamic.get(key)
            ):
                elem = default[0] if len(default) > 0 else ""
                parts = raw.split()
                if isinstance(elem, bool):
                    out = [_parse_bool(p) for p in parts]
                elif isinstance(elem, int):
                    out = [int(p) for p in parts]
                elif isinstance(elem, float):
                    out = [float(p) for p in parts]
                else:
                    out = [p.strip("'\"") for p in parts]
                if not self._dynamic.get(key, False) and len(out) != len(default):
                    raise ValueError(
                        f"array size mismatch for {key}: expected "
                        f"{len(default)}, got {len(out)}"
                    )
                return out
            if isinstance(default, (list, tuple)):
                # empty dynamic array
                return raw.split() if raw else []
            if isinstance(default, bool):
                return _parse_bool(raw)
            if isinstance(default, int):
                return int(raw)
            if isinstance(default, float):
                return float(raw)
            return raw.strip("'\"")
        except (ValueError, IndexError) as exc:
            raise ValueError(f"cannot parse config key {key!r} = {raw!r}") from exc

    def add(self, key: str, default: Any, doc: str = "", dynamic: bool = False) -> None:
        """Register a key with its default (CFG_add)."""
        if isinstance(default, tuple):
            default = list(default)
        if key not in self._order:
            self._order.append(key)
        self._docs[key] = doc
        self._dynamic[key] = dynamic or (
            isinstance(default, list) and len(default) == 0
        )
        if key in self._raw:
            self._values[key] = self._parse(key, self._raw[key], default)
        elif key not in self._values:
            self._values[key] = default

    def get(self, key: str) -> Any:
        if key not in self._values:
            raise KeyError(f"config key {key!r} not registered")
        return self._values[key]

    def add_get(self, key: str, default: Any, doc: str = "",
                dynamic: bool = False) -> Any:
        """Register default + doc and return the (possibly overridden) value
        (CFG_add_get, ``m_config.f90:124-136``)."""
        self.add(key, default, doc, dynamic)
        return self.get(key)

    def set(self, key: str, value: Any) -> None:
        self._values[key] = value
        if key not in self._order:
            self._order.append(key)

    def __contains__(self, key: str) -> bool:
        return key in self._values or key in self._raw

    # ------------------------------------------------------------------ dump
    def _format_value(self, v: Any) -> str:
        if isinstance(v, bool):
            return "T" if v else "F"
        if isinstance(v, list):
            return " ".join(self._format_value(x) for x in v)
        return str(v)

    def write(self, fname: str) -> None:
        """Dump the resolved configuration (CFG_write)."""
        # group keys by section
        by_section: Dict[str, List[str]] = {}
        for key in self._order:
            sec, _, _ = key.rpartition("%")
            by_section.setdefault(sec, []).append(key)
        lines = ["# Resolved configuration\n"]
        for sec in sorted(by_section, key=lambda s: (s != "", s)):
            if sec:
                lines.append(f"[{sec}]\n")
            for key in by_section[sec]:
                doc = self._docs.get(key, "")
                short = key.rpartition("%")[2] if sec else key
                if doc:
                    lines.append(f"    # {doc}:\n")
                lines.append(f"    {short} = {self._format_value(self._values[key])}\n")
            lines.append("\n")
        with open(fname, "w") as f:
            f.writelines(lines)
