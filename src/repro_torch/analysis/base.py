"""Shared analysis infrastructure: findings, parsed modules, AST helpers.

A :class:`Finding` is one rule violation at one source location. Its
``symbol`` is a stable handle (an enum member, a dotted call name, an
attribute) that suppressions in ``analysis.toml`` can match on, so a
suppression survives unrelated line churn in the file it targets.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

#: rule id -> one-line description (the ``--list-rules`` catalog; docs in
#: ROADMAP must stay in sync — test_analysis has a drift check)
RULES: Dict[str, str] = {
    "RPL001": "wall-clock read (time.time/datetime.now/...) on a decision path",
    "RPL002": "unseeded random / numpy.random use on a decision path",
    "RPL003": "builtin hash() on a decision path (PYTHONHASHSEED-dependent)",
    "RPL004": "order-sensitive iteration over an unordered set on a decision path",
    "RPL005": "wall-clock/RNG-derived value reaches a decision log, event ordinal, or ordering key",
    "RPL010": "non-exhaustive dispatch over a tracked enum without an explicit default",
    "RPL011": "ctl lifecycle transition table inconsistent (coverage/terminal/requeue/projection)",
    "RPL020": "engine-parity violation: event kind referenced by one engine of a pair only",
    "RPL021": "Engine implementation missing part of the protocol surface",
    "RPL030": "JobStore write outside a crash-atomic transaction block",
    "RPL031": "shared daemon state mutated outside the server lock",
    "RPL040": "lock-order cycle across with/acquire sites (potential deadlock)",
    "RPL041": "field access inconsistent with its inferred guarding lock",
    "RPL042": "blocking call (sleep / socket I/O / sqlite txn control) while holding a lock",
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # posix path relative to the config root
    line: int
    col: int
    message: str
    symbol: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "symbol": self.symbol,
        }


@dataclass
class Module:
    """One parsed source file."""

    path: Path  # absolute
    rel: str  # posix, relative to the config root
    tree: ast.Module
    source: str

    @classmethod
    def parse(cls, path: Path, rel: str) -> "Module":
        source = path.read_text(encoding="utf-8")
        return cls(path=path, rel=rel, tree=ast.parse(source, filename=rel), source=source)


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def enum_member(
    node: ast.AST, enums: Dict[str, FrozenSet[str]]
) -> Optional[Tuple[str, str]]:
    """``(enum_name, member)`` if ``node`` is ``<KnownEnum>.<attr>``.

    The member itself is *not* validated here — dispatch checkers report
    unknown members as findings rather than silently skipping typos.
    """
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id in enums
    ):
        return node.value.id, node.attr
    return None


def iter_enum_refs(scope: ast.AST, enum_name: str) -> Iterator[Tuple[str, ast.Attribute]]:
    """Yield ``(member, node)`` for every ``<enum_name>.<member>`` in scope."""
    for node in ast.walk(scope):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == enum_name
        ):
            yield node.attr, node


ENUM_BASES = {"Enum", "IntEnum", "StrEnum", "Flag", "IntFlag"}


def is_enum_classdef(node: ast.ClassDef) -> bool:
    for base in node.bases:
        name = dotted(base)
        if name is not None and name.split(".")[-1] in ENUM_BASES:
            return True
    return False


def enum_members_of(node: ast.ClassDef) -> FrozenSet[str]:
    """Member names of an enum ClassDef (uppercase-style assignments)."""
    members: List[str] = []
    for stmt in node.body:
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name) and not tgt.id.startswith("_"):
                    members.append(tgt.id)
        elif isinstance(stmt, ast.AnnAssign):
            if isinstance(stmt.target, ast.Name) and not stmt.target.id.startswith("_"):
                members.append(stmt.target.id)
    return frozenset(members)


@dataclass
class TreeIndex:
    """Cross-file facts collected in a first pass over every scanned module.

    ``enums``     tracked enum name -> member set (from its ClassDef).
    ``set_attrs`` attribute names that *some* scanned class assigns or
                  annotates as a set/frozenset. Attribute typing is
                  name-based (we cannot resolve receiver types statically)
                  — distinctive names like ``paged`` / ``_active`` make
                  this precise enough in practice.
    ``classes``   class name -> (base names, method names) for protocol
                  checks with single-level-name inheritance resolution.
    """

    enums: Dict[str, FrozenSet[str]] = field(default_factory=dict)
    set_attrs: Dict[str, str] = field(default_factory=dict)  # attr -> "cls.attr"
    classes: Dict[str, Tuple[Tuple[str, ...], FrozenSet[str]]] = field(
        default_factory=dict
    )

    def class_methods(
        self, name: str, _seen: Optional[FrozenSet[str]] = None
    ) -> FrozenSet[str]:
        """Methods of ``name`` including bases resolvable by name."""
        seen = _seen or frozenset()
        if name in seen or name not in self.classes:
            return frozenset()
        bases, methods = self.classes[name]
        out = set(methods)
        for base in bases:
            out |= self.class_methods(base, seen | {name})
        return frozenset(out)


SET_TYPE_NAMES = {"set", "frozenset", "Set", "FrozenSet", "MutableSet", "AbstractSet"}


def is_set_annotation(node: ast.AST) -> bool:
    """Does this annotation expression denote a set type?"""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        head = node.value.split("[", 1)[0].strip()
        return head.split(".")[-1] in SET_TYPE_NAMES
    name = dotted(node)
    return name is not None and name.split(".")[-1] in SET_TYPE_NAMES


def is_set_expr_literal(node: ast.AST) -> bool:
    """Set literal, set comprehension, or a set()/frozenset() call."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        return name in ("set", "frozenset")
    return False


def build_index(modules: List[Module], tracked_enums: FrozenSet[str]) -> TreeIndex:
    index = TreeIndex()
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            bases = tuple(
                b for b in (dotted(base) for base in node.bases) if b is not None
            )
            methods = frozenset(
                stmt.name
                for stmt in node.body
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
            )
            index.classes[node.name] = (
                tuple(b.split(".")[-1] for b in bases),
                methods,
            )
            if node.name in tracked_enums and is_enum_classdef(node):
                index.enums[node.name] = enum_members_of(node)
            # set-typed attribute names: `self.x = set()` in methods,
            # `x: Set[int]` / `x: Set[int] = ...` in the class body
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Assign) and stmt.value is not None:
                    if is_set_expr_literal(stmt.value):
                        for tgt in stmt.targets:
                            if isinstance(tgt, ast.Attribute):
                                index.set_attrs.setdefault(
                                    tgt.attr, f"{node.name}.{tgt.attr}"
                                )
                elif isinstance(stmt, ast.AnnAssign) and is_set_annotation(
                    stmt.annotation
                ):
                    tgt = stmt.target
                    if isinstance(tgt, ast.Attribute):
                        index.set_attrs.setdefault(tgt.attr, f"{node.name}.{tgt.attr}")
                    elif isinstance(tgt, ast.Name) and stmt.value is None:
                        # class-body annotation declares an instance attr
                        index.set_attrs.setdefault(tgt.id, f"{node.name}.{tgt.id}")
    return index
