"""RPL03x — store/lock discipline for the control-plane daemon.

The daemon's crash-safety argument (see ``ctl/daemon.py`` docstring)
rests on two mechanical disciplines that are easy to erode in review:

RPL030  **crash-atomic store writes.** The store only moves forward in
        whole steps: the epoch commit is *one* SQLite transaction, and
        any function that issues several :class:`JobStore` writes (or
        one write per loop iteration) must wrap them in
        ``with <store>.transaction():`` so a crash cannot land between
        them. Flagged: a store write lexically outside a transaction
        block in a function that opens one, and multi-write / write-in-
        loop functions with no transaction at all. A single standalone
        write is fine — every ``JobStore`` write method is internally
        transactional.

RPL031  **server-lock mutations.** The daemon's shared mutable state
        (``_active``, ``_pending_cancel``, ``_pending_pause``,
        ``_terminal_committed``) is read by socket-handler threads under
        ``_ctl_lock``; every mutation outside ``__init__`` must hold the
        lock. Flagged: assignment/augmented assignment to a listed
        ``self.<attr>``, or a mutating method call on one
        (``add``/``discard``/``update``/...), not lexically inside
        ``with self._ctl_lock:``.

Both rules are lexical (a ``with`` block in the same function), which
matches how the daemon is written: helpers that *require* the caller to
hold the lock would need a suppression with a reason — deliberately, so
the locking protocol stays visible in ``analysis.toml``.
"""
from __future__ import annotations

import ast
from typing import Callable, List, Set

from repro_torch.analysis.base import Finding, Module, dotted
from repro_torch.analysis.config import AnalysisConfig

_MUTATORS = {
    "add", "append", "clear", "difference_update", "discard", "extend",
    "insert", "intersection_update", "pop", "popitem", "remove",
    "setdefault", "symmetric_difference_update", "update",
}


def check_discipline(mod: Module, cfg: AnalysisConfig) -> List[Finding]:
    if not cfg.is_discipline_path(mod.rel):
        return []
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            findings.extend(_check_function(node, mod, cfg))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def _with_guards(fn: ast.AST, predicate: Callable[[ast.AST], bool]) -> Set[int]:
    """ids of every AST node lexically inside a matching ``with`` block."""
    guarded: Set[int] = set()

    def visit(node: ast.AST, inside: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
            return  # nested defs run later, outside this block's dynamic extent
        here = inside
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
            predicate(item.context_expr) for item in node.items
        ):
            here = True
        if inside:
            guarded.add(id(node))
        for child in ast.iter_child_nodes(node):
            visit(child, here)

    visit(fn, False)
    return guarded


def _is_store_txn(expr: ast.AST) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    name = dotted(expr.func)
    return name is not None and (
        name.endswith("store.transaction") or name == "transaction"
    )


def _is_store_write(node: ast.AST, cfg: AnalysisConfig) -> bool:
    if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr not in cfg.store_write_methods:
        return False
    receiver = dotted(node.func.value)
    return receiver is not None and (receiver == "store" or receiver.endswith(".store"))


def _check_function(
    fn: ast.AST, mod: Module, cfg: AnalysisConfig
) -> List[Finding]:
    findings: List[Finding] = []
    name = getattr(fn, "name", "")

    # ---- RPL030 ------------------------------------------------------
    txn_guarded = _with_guards(fn, _is_store_txn)
    has_txn = False
    writes: List[ast.Call] = []
    loop_writes: Set[int] = set()

    def scan(node: ast.AST, in_loop: bool) -> None:
        nonlocal has_txn
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
            return
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
            _is_store_txn(item.context_expr) for item in node.items
        ):
            has_txn = True
        if _is_store_write(node, cfg):
            writes.append(node)  # type: ignore[arg-type]
            if in_loop:
                loop_writes.add(id(node))
        here = in_loop or isinstance(node, (ast.For, ast.AsyncFor, ast.While))
        for child in ast.iter_child_nodes(node):
            scan(child, here)

    scan(fn, False)
    if has_txn:
        for w in writes:
            if id(w) not in txn_guarded:
                findings.append(
                    Finding(
                        rule="RPL030",
                        path=mod.rel,
                        line=w.lineno,
                        col=w.col_offset,
                        message=(
                            f"{name}() opens a store transaction but calls "
                            f"{w.func.attr}() outside it; a crash between the "  # type: ignore[attr-defined]
                            "two leaves a torn commit"
                        ),
                        symbol=w.func.attr,  # type: ignore[attr-defined]
                    )
                )
    elif len(writes) > 1 or any(id(w) in loop_writes for w in writes):
        for w in writes:
            findings.append(
                Finding(
                    rule="RPL030",
                    path=mod.rel,
                    line=w.lineno,
                    col=w.col_offset,
                    message=(
                        f"{name}() issues multiple store writes "
                        f"({w.func.attr}()) with no wrapping "  # type: ignore[attr-defined]
                        "`with <store>.transaction():`; the group is not "
                        "crash-atomic"
                    ),
                    symbol=w.func.attr,  # type: ignore[attr-defined]
                )
            )

    # ---- RPL031 ------------------------------------------------------
    if name == "__init__":
        return findings  # construction precedes every other thread

    def _is_lock(expr: ast.AST) -> bool:
        n = dotted(expr)
        return n is not None and n.split(".")[-1] == cfg.lock_attr

    lock_guarded = _with_guards(fn, _is_lock)

    def _flag_mut(node: ast.AST, attr: str) -> None:
        findings.append(
            Finding(
                rule="RPL031",
                path=mod.rel,
                line=getattr(node, "lineno", 1),
                col=getattr(node, "col_offset", 0),
                message=(
                    f"{name}() mutates shared state self.{attr} outside "
                    f"`with self.{cfg.lock_attr}:`; socket-handler threads "
                    "read it under the lock"
                ),
                symbol=attr,
            )
        )

    def _self_locked_attr(node: ast.AST) -> str:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in cfg.locked_attrs
        ):
            return node.attr
        return ""

    for node in ast.walk(fn):
        if id(node) in lock_guarded:
            continue
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                attr = _self_locked_attr(tgt)
                if attr:
                    _flag_mut(node, attr)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATORS:
                attr = _self_locked_attr(node.func.value)
                if attr:
                    _flag_mut(node, attr)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                attr = _self_locked_attr(tgt)
                if attr:
                    _flag_mut(node, attr)
    return findings
