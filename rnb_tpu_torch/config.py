"""HOCON-subset config system (the port's own copy of ``rnb_tpu/config.py``,
so that a conf drives the port without importing the JAX package).

The reference RNb-NeuS runner drives experiments with pyhocon HOCON files
(`confs/*.conf`). Rather than depend on pyhocon, this module implements a
small parser covering the subset the reference confs actually use:

  * nested ``section { ... }`` blocks
  * ``key = value`` with optional trailing commas
  * ``#`` and ``//`` comments (inline comments only when preceded by
    whitespace or a comma — HOCON treats ``foo#bar`` inside an unquoted
    value as part of the value, which the reference confs rely on for
    their commented-out path suffixes, e.g. ``data_dir = /a/b/#./c/#``)
  * lists ``[a, b]`` (incl. multi-line)
  * bools / ints / floats / bare or quoted strings

plus the reference's ``CASE_NAME`` substitution (`exp_runner.py:30,36`).

Access API mirrors pyhocon enough for the runner: ``get_string``,
``get_int``, ``get_float``, ``get_bool``, ``get_list``, ``get_config``,
``__getitem__`` with dotted paths.
"""

from __future__ import annotations

import re
from typing import Any


class Config:
    """A nested dict with pyhocon-flavoured typed accessors."""

    def __init__(self, data: dict):
        self._data = data

    # -- dotted-path primitive ------------------------------------------------
    def _resolve(self, path: str):
        node: Any = self._data
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(path)
            node = node[part]
        return node

    def __getitem__(self, path: str):
        v = self._resolve(path)
        return Config(v) if isinstance(v, dict) else v

    def __setitem__(self, path: str, value):
        parts = path.split(".")
        node = self._data
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def __contains__(self, path: str) -> bool:
        try:
            self._resolve(path)
            return True
        except KeyError:
            return False

    def get(self, path: str, default=None):
        try:
            return self[path]
        except KeyError:
            return default

    # -- typed accessors (pyhocon-compatible names) ---------------------------
    def get_string(self, path: str, default: str | None = None) -> str:
        try:
            return str(self._resolve(path))
        except KeyError:
            if default is None:
                raise
            return default

    def get_int(self, path: str, default: int | None = None) -> int:
        try:
            return int(self._resolve(path))
        except KeyError:
            if default is None:
                raise
            return default

    def get_float(self, path: str, default: float | None = None) -> float:
        try:
            return float(self._resolve(path))
        except KeyError:
            if default is None:
                raise
            return default

    def get_bool(self, path: str, default: bool | None = None) -> bool:
        try:
            v = self._resolve(path)
        except KeyError:
            if default is None:
                raise
            return default
        if isinstance(v, bool):
            return v
        return str(v).lower() in ("true", "yes", "on", "1")

    def get_list(self, path: str, default=None) -> list:
        try:
            v = self._resolve(path)
        except KeyError:
            if default is None:
                raise
            return default
        if not isinstance(v, list):
            raise TypeError(f"{path} is not a list")
        return v

    def get_config(self, path: str) -> "Config":
        v = self._resolve(path)
        if not isinstance(v, dict):
            raise TypeError(f"{path} is not a config section")
        return Config(v)

    def as_dict(self) -> dict:
        return self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        for k, v in self._data.items():
            yield k, (Config(v) if isinstance(v, dict) else v)

    def __repr__(self):
        return f"Config({self._data!r})"


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_BOOL = {"true": True, "false": False, "yes": True, "no": False, "on": True, "off": False}


def _strip_comments(text: str) -> str:
    """Remove ``#``/``//`` comments.

    A ``#`` starts a comment at line start or when preceded by whitespace,
    ``,``, ``[``, ``{`` or ``=``. Otherwise (``/a/b#c``) it is value text —
    matching how the reference confs embed commented path alternates inside
    unquoted values (`confs/wmask_rnb.conf:2,10`).
    """
    out_lines = []
    for line in text.splitlines():
        in_str = False
        cut = len(line)
        for i, ch in enumerate(line):
            if ch == '"':
                in_str = not in_str
            if in_str:
                continue
            if ch == "#":
                if i == 0 or line[i - 1] in " \t,=[{":
                    cut = i
                    break
            if ch == "/" and i + 1 < len(line) and line[i + 1] == "/":
                if i == 0 or line[i - 1] in " \t,=[{":
                    cut = i
                    break
        out_lines.append(line[:cut])
    return "\n".join(out_lines)


def _coerce(token: str):
    token = token.strip()
    if token.startswith('"') and token.endswith('"') and len(token) >= 2:
        return token[1:-1]
    low = token.lower()
    if low in _BOOL:
        return _BOOL[low]
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        pass
    # bare string; drop a stray trailing '#...#' alternate (already comment-stripped
    # only when preceded by whitespace). Keep as-is.
    return token


class _Parser:
    def __init__(self, text: str):
        self.text = _strip_comments(text)
        self.pos = 0
        self.n = len(self.text)

    def _skip_ws(self, include_newline=True):
        chars = " \t\r\n" if include_newline else " \t\r"
        while self.pos < self.n and self.text[self.pos] in chars:
            self.pos += 1

    def _skip_separators(self):
        while self.pos < self.n and self.text[self.pos] in " \t\r\n,":
            self.pos += 1

    def parse_object(self, top_level=False) -> dict:
        obj: dict = {}
        if not top_level:
            assert self.text[self.pos] == "{"
            self.pos += 1
        while True:
            self._skip_separators()
            if self.pos >= self.n:
                if top_level:
                    return obj
                raise ValueError("unexpected EOF inside object")
            if self.text[self.pos] == "}":
                self.pos += 1
                return obj
            key = self._parse_key()
            self._skip_ws()
            ch = self.text[self.pos] if self.pos < self.n else ""
            if ch == "{":
                val = self.parse_object()
            elif ch in "=:":
                self.pos += 1
                self._skip_ws()
                val = self._parse_value()
            else:
                raise ValueError(f"expected '=' or '{{' after key {key!r} at {self.pos}")
            # HOCON merges duplicate object keys
            if key in obj and isinstance(obj[key], dict) and isinstance(val, dict):
                obj[key].update(val)
            else:
                obj[key] = val

    def _parse_key(self) -> str:
        m = re.match(r'[A-Za-z0-9_.\-"]+', self.text[self.pos:])
        if not m:
            raise ValueError(f"bad key at {self.pos}: {self.text[self.pos:self.pos+20]!r}")
        self.pos += m.end()
        return m.group(0).strip('"')

    def _parse_value(self):
        ch = self.text[self.pos]
        if ch == "{":
            return self.parse_object()
        if ch == "[":
            return self._parse_list()
        if ch == '"':
            end = self.text.index('"', self.pos + 1)
            val = self.text[self.pos + 1:end]
            self.pos = end + 1
            return val
        # unquoted scalar: up to newline / ',' / '}' / ']'
        m = re.match(r"[^\n,}\]]*", self.text[self.pos:])
        raw = m.group(0)
        self.pos += m.end()
        return _coerce(raw)

    def _parse_list(self) -> list:
        assert self.text[self.pos] == "["
        self.pos += 1
        items = []
        while True:
            self._skip_separators()
            if self.pos >= self.n:
                raise ValueError("unexpected EOF inside list")
            if self.text[self.pos] == "]":
                self.pos += 1
                return items
            ch = self.text[self.pos]
            if ch == "{":
                items.append(self.parse_object())
            elif ch == "[":
                items.append(self._parse_list())
            elif ch == '"':
                end = self.text.index('"', self.pos + 1)
                items.append(self.text[self.pos + 1:end])
                self.pos = end + 1
            else:
                m = re.match(r"[^\n,}\]]*", self.text[self.pos:])
                items.append(_coerce(m.group(0)))
                self.pos += m.end()


def parse_string(text: str) -> Config:
    return Config(_Parser(text).parse_object(top_level=True))


def apply_override(conf: Config, override: str) -> None:
    """Apply one ``dotted.path=value`` override in place, with the same value
    coercion the parser uses (in place of the reference job scripts'
    heredoc-templated per-case confs)."""
    if "=" not in override:
        raise ValueError(f"override must be 'dotted.path=value', got {override!r}")
    path, _, raw = override.partition("=")
    path = path.strip()
    if path not in conf:
        # loud, not fatal: new keys are legitimate (runtime knobs absent
        # from older confs), but a typo'd override would otherwise silently
        # train with defaults
        import logging
        logging.getLogger(__name__).warning(
            "--set %s creates a NEW conf key (not present in the conf file) "
            "— check for typos if an existing value was meant", path)
    conf[path] = _coerce(raw)


def load_conf(path: str, case: str = "") -> Config:
    """Load a conf file, substituting CASE_NAME like the reference runner
    (`exp_runner.py:28-36`)."""
    with open(path) as f:
        text = f.read()
    if case:
        text = text.replace("CASE_NAME", case)
    conf = parse_string(text)
    if case and "dataset.data_dir" in conf:
        conf["dataset.data_dir"] = str(conf["dataset.data_dir"]).replace("CASE_NAME", case)
    return conf
