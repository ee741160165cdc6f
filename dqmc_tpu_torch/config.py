"""INI-style parameter files (``parameters.in``).

Behavior-compatible with the reference parser (include/utility.h:50-276):

- ``[section]`` headers; keys before any header land in section ``"global"``.
- ``key = value`` pairs; later duplicates overwrite earlier ones.
- ``#`` and ``;`` start a comment anywhere in a line.
- Values may be single- or double-quoted; quotes are stripped.
- Numeric literals may contain ``_`` separators (``10_000``).
- Typed getters raise ``KeyError`` when the key is missing and no default is
  given; with a default they swallow *any* lookup/convert failure, matching
  the reference's ``try { ... } catch (...) { return default; }``.
- ``get_float_list`` parses comma-separated doubles (utility.h:241-261).

The port keeps its own copy of ``dqmc_tpu/config.py`` so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Optional, Union


def _strip_comment(line: str) -> str:
    # Everything after the first '#' or ';' is a comment (utility.h:68-74).
    for pos, ch in enumerate(line):
        if ch in "#;":
            return line[:pos]
    return line


def _unquote(value: str) -> str:
    if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
        return value[1:-1]
    return value


class Parameters:
    """Parsed parameter file: ``sections[section][key] -> raw string``."""

    def __init__(self, source: Union[str, os.PathLike, io.TextIOBase, None] = None):
        self.sections: Dict[str, Dict[str, str]] = {}
        if source is None:
            return
        if isinstance(source, io.TextIOBase):
            self._parse(source.read())
        else:
            with open(source, "r") as fh:
                self._parse(fh.read())

    @classmethod
    def from_string(cls, text: str) -> "Parameters":
        p = cls()
        p._parse(text)
        return p

    def _parse(self, text: str) -> None:
        current = "global"
        for raw in text.splitlines():
            line = _strip_comment(raw).strip()
            if not line:
                continue
            if line[0] == "[" and line[-1] == "]":
                current = line[1:-1].strip()
                continue
            eq = line.find("=")
            if eq < 0:
                continue  # silently ignored, as in the reference
            key = line[:eq].strip()
            value = _unquote(line[eq + 1:].strip())
            self.sections.setdefault(current, {})[key] = value

    # ------------------------------------------------------------------
    # typed getters
    # ------------------------------------------------------------------

    _MISSING = object()

    def get_str(self, section: str, key: str, default=_MISSING) -> str:
        try:
            return self.sections[section][key]
        except KeyError:
            if default is not Parameters._MISSING:
                return default
            raise KeyError(f"key '{key}' not found in section '{section}'")

    def get_int(self, section: str, key: str, default=_MISSING) -> int:
        try:
            raw = self.sections[section][key].replace("_", "")
            # std::stoi parses a leading integer and tolerates trailing junk;
            # int(float(...)) additionally accepts "40.0" (the reference reads
            # nt with getDouble in one place and getInt in another).
            try:
                return int(raw)
            except ValueError:
                return int(float(raw))
        except (KeyError, ValueError):
            if default is not Parameters._MISSING:
                return default
            raise KeyError(f"int key '{key}' not found/invalid in section '{section}'")

    def get_float(self, section: str, key: str, default=_MISSING) -> float:
        try:
            return float(self.sections[section][key].replace("_", ""))
        except (KeyError, ValueError):
            if default is not Parameters._MISSING:
                return default
            raise KeyError(f"float key '{key}' not found/invalid in section '{section}'")

    def get_bool(self, section: str, key: str, default=_MISSING) -> bool:
        try:
            raw = self.sections[section][key].lower()
        except KeyError:
            raw = None
        if raw in ("true", "1", "yes", "on"):
            return True
        if raw in ("false", "0", "no", "off"):
            return False
        if default is not Parameters._MISSING:
            return default
        raise KeyError(f"bool key '{key}' not found/invalid in section '{section}'")

    def get_float_list(self, section: str, key: str, default=_MISSING) -> List[float]:
        try:
            raw = self.sections[section][key]
            out = []
            for item in raw.split(","):
                item = item.strip().replace("_", "")
                if not item:
                    continue
                out.append(float(item))
            return out
        except (KeyError, ValueError):
            if default is not Parameters._MISSING:
                return default
            raise KeyError(f"float list '{key}' not found/invalid in section '{section}'")

    def has_section(self, section: str) -> bool:
        return section in self.sections

    def has_key(self, section: str, key: str) -> bool:
        return key in self.sections.get(section, {})

    def set(self, section: str, key: str, value) -> None:
        self.sections.setdefault(section, {})[key] = str(value)

    def dumps(self) -> str:
        chunks = []
        for section, kv in self.sections.items():
            chunks.append(f"[{section}]")
            for k, v in kv.items():
                chunks.append(f"{k} = {v}")
            chunks.append("")
        return "\n".join(chunks)
