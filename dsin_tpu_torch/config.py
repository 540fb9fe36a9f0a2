"""Config DSL: attribute-style configs parsed from simple text files.

Provides the capability the reference gets from `fjcommon.config_parser`
(reference main.py:13,184-185): files of ``key = <python literal>`` lines,
optional ``constrain key :: A, B, ...`` enum-validation lines, ``#`` comments,
and a text snapshot (str(config)) persisted beside checkpoints
(reference main.py:159-163).

Grammar (one statement per line):
    # comment                      -- ignored (also inline after values)
    key = <python literal>         -- evaluated with ast.literal_eval; a bare
                                      identifier on the RHS is kept as a string
                                      (the reference DSL allows e.g. `arch = CVPR`)
    constrain key :: A, B, C       -- when `key` is later assigned, its value
                                      must be one of the listed tokens
"""

from __future__ import annotations

import ast
import re
from typing import Any, Dict, Iterable, Optional, Tuple


class ConfigError(ValueError):
    pass


class Config:
    """Attribute-style config holding parsed key/value pairs.

    str(config) produces a canonical snapshot that `parse_config` can re-read.
    """

    def __init__(self, values: Optional[Dict[str, Any]] = None,
                 constraints: Optional[Dict[str, Tuple[str, ...]]] = None,
                 name: str = "config"):
        object.__setattr__(self, "_values", dict(values or {}))
        object.__setattr__(self, "_constraints", dict(constraints or {}))
        object.__setattr__(self, "_name", name)

    # -- attribute protocol ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return object.__getattribute__(self, "_values")[key]
        except KeyError:
            raise AttributeError(
                f"config {self._name!r} has no key {key!r}; "
                f"known keys: {sorted(self._values)}") from None

    def __setattr__(self, key: str, value: Any) -> None:
        self.set(key, value)

    def set(self, key: str, value: Any) -> None:
        allowed = self._constraints.get(key)
        if allowed is not None and value not in allowed:
            raise ConfigError(
                f"config {self._name!r}: {key} = {value!r} violates "
                f"constraint :: {', '.join(map(str, allowed))}")
        self._values[key] = value

    # -- dict-ish helpers -----------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def keys(self) -> Iterable[str]:
        return self._values.keys()

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def replace(self, **updates: Any) -> "Config":
        """Return a copy with `updates` applied (constraints enforced)."""
        out = Config(self._values, self._constraints, self._name)
        for k, v in updates.items():
            out.set(k, v)
        return out

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Config) and other._values == self._values

    def __repr__(self) -> str:
        return f"Config({self._name!r}, {len(self._values)} keys)"

    def __str__(self) -> str:
        """Canonical re-parseable snapshot."""
        lines = []
        for key, allowed in sorted(self._constraints.items()):
            lines.append(f"constrain {key} :: {', '.join(map(str, allowed))}")
        for key, value in self._values.items():
            lines.append(f"{key} = {value!r}")
        return "\n".join(lines) + "\n"


_CONSTRAIN_RE = re.compile(r"^constrain\s+(\w+)\s*::\s*(.*)$")
_ASSIGN_RE = re.compile(r"^(\w+)\s*=\s*(.*)$")
_IDENT_RE = re.compile(r"^[A-Za-z_]\w*$")


def _strip_comment(line: str) -> str:
    """Remove a trailing ``#`` comment that is not inside a string literal."""
    out = []
    quote = None
    escaped = False
    for ch in line:
        if quote:
            out.append(ch)
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join(out)


def _eval_rhs(rhs: str, key: str, lineno: int) -> Any:
    rhs = rhs.strip()
    if not rhs:
        raise ConfigError(f"line {lineno}: empty value for {key!r}")
    # trailing comma tuples like `A, B,` -> try literal_eval as-is first
    try:
        return ast.literal_eval(rhs)
    except (ValueError, SyntaxError):
        pass
    # arithmetic on literals (the reference writes `H_target = 2*0.02`)
    try:
        node = ast.parse(rhs, mode="eval")
        if _is_const_expr(node.body):
            return eval(compile(node, "<config>", "eval"), {"__builtins__": {}}, {})
    except SyntaxError:
        pass
    # non-finite floats (so snapshots of inf/nan reload with their type intact)
    low = rhs.lower()
    if low in ("inf", "-inf", "nan"):
        return float(low)
    # bare identifier -> string enum token
    if _IDENT_RE.match(rhs):
        return rhs
    raise ConfigError(f"line {lineno}: cannot parse value for {key!r}: {rhs!r}")


def _is_const_expr(node: ast.AST) -> bool:
    """True when the expression is built only from literals and arithmetic."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv,
                      ast.Pow, ast.Mod)):
        return _is_const_expr(node.left) and _is_const_expr(node.right)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        return _is_const_expr(node.operand)
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_const_expr(e) for e in node.elts)
    return False


def parse_config(text: str, name: str = "config") -> Config:
    values: Dict[str, Any] = {}
    constraints: Dict[str, Tuple[str, ...]] = {}
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw).strip()
        if not line:
            continue
        m = _CONSTRAIN_RE.match(line)
        if m:
            key, tokens = m.group(1), m.group(2)
            # each token is parsed like a value, so numeric enums
            # (`constrain n :: 4, 6`) compare against parsed assignments
            allowed = tuple(_eval_rhs(t.strip(), key, lineno)
                            for t in tokens.split(",") if t.strip())
            if not allowed:
                raise ConfigError(f"line {lineno}: empty constraint for {key!r}")
            constraints[key] = allowed
            if key in values and values[key] not in allowed:
                raise ConfigError(
                    f"line {lineno}: existing value {values[key]!r} for {key!r} "
                    f"violates new constraint")
            continue
        m = _ASSIGN_RE.match(line)
        if m:
            key, rhs = m.group(1), m.group(2)
            value = _eval_rhs(rhs, key, lineno)
            allowed = constraints.get(key)
            if allowed is not None and value not in allowed:
                raise ConfigError(
                    f"line {lineno}: {key} = {value!r} violates constraint "
                    f":: {', '.join(map(str, allowed))}")
            values[key] = value
            continue
        raise ConfigError(f"line {lineno}: cannot parse: {raw!r}")
    return Config(values, constraints, name)


def parse_config_file(path: str) -> Config:
    with open(path) as f:
        return parse_config(f.read(), name=path)
