"""Cross-file call-graph / alias / lock index (pass 1.5).

The first-generation checkers were lexical: one function, one file. The
concurrency family (RPL040-042) and the interprocedural determinism
taint pass (RPL005) both need the same three cross-file facts, collected
here once per run and shared:

* a **function registry** (every def/async def, keyed by a stable id
  ``<rel>::<Class.name>`` or ``<rel>::<name>``) with call-site
  resolution — ``self.m()`` through the class/base table,
  ``self.attr.m()`` through the inferred attribute types, bare names
  through the module's own defs and its imports;
* an **alias index**: the concrete class behind ``self.<attr>``,
  inferred from constructor calls (``self.store = JobStore(path)``,
  including inside ternaries), from annotated assignments, and from
  parameters whose annotation names exactly one scanned class
  (``store: "JobStore | str"``);
* a **lock index**: every attribute (or module global) assigned from a
  ``threading.Lock/RLock/Condition/Semaphore`` factory, identified as
  ``Class.attr`` (or ``<rel>:NAME``) so a lock has one name everywhere
  it is acquired.

Resolution is deliberately conservative: a call that cannot be resolved
by these rules is simply absent from the graph (no edge), so the
downstream passes under-approximate rather than hallucinate. Class and
method tables are name-keyed (like :class:`~repro_torch.analysis.base.
TreeIndex`) — receiver *types* cannot be recovered statically in
general, but in this tree class names are unique where it matters.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import PurePosixPath
from typing import Collection, Dict, FrozenSet, List, Optional, Tuple, Union

from repro_torch.analysis.base import Module, TreeIndex, dotted

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]

#: callables whose result is a lock-like synchronization primitive
#: (matched on the dotted tail, so both ``threading.RLock()`` and a bare
#: ``RLock()`` import hit)
DEFAULT_LOCK_FACTORIES = (
    "Lock",
    "RLock",
    "Condition",
    "Semaphore",
    "BoundedSemaphore",
)


def module_name(rel: str) -> str:
    """Dotted import name for a scanned file: ``src/repro_torch/ctl/store.py``
    -> ``repro_torch.ctl.store``; ``RPL040/bad.py`` -> ``RPL040.bad``."""
    parts: Tuple[str, ...] = PurePosixPath(rel).with_suffix("").parts
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@dataclass(frozen=True)
class FuncInfo:
    """One function/method definition in the scanned tree."""

    fid: str
    rel: str
    cls: Optional[str]
    name: str
    node: FunctionNode

    @property
    def qualname(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name


@dataclass
class CallGraph:
    """Registry + resolution tables. Built by :func:`build_callgraph`."""

    index: TreeIndex
    functions: Dict[str, FuncInfo] = field(default_factory=dict)
    #: (class name, method name) -> fid (first definition wins, in
    #: sorted-module order, so resolution is deterministic)
    by_class_method: Dict[Tuple[str, str], str] = field(default_factory=dict)
    #: (dotted module name, function name) -> fid
    by_module_func: Dict[Tuple[str, str], str] = field(default_factory=dict)
    #: (class name, attr name) -> class name of the attribute's value
    attr_types: Dict[Tuple[str, str], str] = field(default_factory=dict)
    #: (class name, attr name) -> lock id "Class.attr"
    lock_attrs: Dict[Tuple[str, str], str] = field(default_factory=dict)
    #: (dotted module name, global name) -> lock id "<rel>:NAME"
    module_locks: Dict[Tuple[str, str], str] = field(default_factory=dict)
    #: rel -> alias -> (dotted module, name-or-None for module imports)
    imports: Dict[str, Dict[str, Tuple[str, Optional[str]]]] = field(
        default_factory=dict
    )
    #: rel -> dotted module name
    modnames: Dict[str, str] = field(default_factory=dict)

    # -- resolution ------------------------------------------------------

    def class_chain(self, cls: str) -> List[str]:
        """``cls`` and its name-resolvable bases, nearest first."""
        out: List[str] = []
        frontier = [cls]
        while frontier:
            cur = frontier.pop(0)
            if cur in out:
                continue
            out.append(cur)
            bases = self.index.classes.get(cur, ((), frozenset()))[0]
            frontier.extend(bases)
        return out

    def resolve_method(self, cls: str, method: str) -> Optional[str]:
        for c in self.class_chain(cls):
            fid = self.by_class_method.get((c, method))
            if fid is not None:
                return fid
        return None

    def attr_type(self, cls: Optional[str], attr: str) -> Optional[str]:
        if cls is None:
            return None
        for c in self.class_chain(cls):
            t = self.attr_types.get((c, attr))
            if t is not None:
                return t
        return None

    def lock_of_attr(self, cls: Optional[str], attr: str) -> Optional[str]:
        if cls is None:
            return None
        for c in self.class_chain(cls):
            lock = self.lock_attrs.get((c, attr))
            if lock is not None:
                return lock
        return None

    def resolve_call(self, call: ast.Call, ctx: FuncInfo) -> Optional[str]:
        """fid of the function a call lands on, or None if unresolvable."""
        func = call.func
        modname = self.modnames.get(ctx.rel, "")
        if isinstance(func, ast.Name):
            name = func.id
            fid = self.by_module_func.get((modname, name))
            if fid is not None:
                return fid
            imp = self.imports.get(ctx.rel, {}).get(name)
            if imp is not None and imp[1] is not None:
                return self.by_module_func.get(imp)
            if name in self.index.classes:
                return self.resolve_method(name, "__init__")
            return None
        if not isinstance(func, ast.Attribute):
            return None
        recv = func.value
        method = func.attr
        if isinstance(recv, ast.Name):
            if recv.id == "self" and ctx.cls is not None:
                return self.resolve_method(ctx.cls, method)
            imp = self.imports.get(ctx.rel, {}).get(recv.id)
            if imp is not None and imp[1] is None:
                return self.by_module_func.get((imp[0], method))
            if recv.id in self.index.classes:
                return self.resolve_method(recv.id, method)
            return None
        if (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
        ):
            t = self.attr_type(ctx.cls, recv.attr)
            if t is not None:
                return self.resolve_method(t, method)
        return None

    def lock_of_expr(self, expr: ast.AST, ctx: FuncInfo) -> Optional[str]:
        """Lock id for a ``with <expr>`` / ``<expr>.acquire()`` operand."""
        if isinstance(expr, ast.Attribute):
            recv = expr.value
            if isinstance(recv, ast.Name):
                if recv.id == "self":
                    return self.lock_of_attr(ctx.cls, expr.attr)
                imp = self.imports.get(ctx.rel, {}).get(recv.id)
                if imp is not None and imp[1] is None:
                    return self.module_locks.get((imp[0], expr.attr))
                return None
            if (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
            ):
                t = self.attr_type(ctx.cls, recv.attr)
                if t is not None:
                    return self.lock_of_attr(t, expr.attr)
            return None
        if isinstance(expr, ast.Name):
            return self.module_locks.get((self.modnames.get(ctx.rel, ""), expr.id))
        return None

    def all_locks(self) -> FrozenSet[str]:
        return frozenset(self.lock_attrs.values()) | frozenset(
            self.module_locks.values()
        )


# ----------------------------------------------------------------------
# construction
# ----------------------------------------------------------------------


def _is_lock_factory(expr: ast.AST, factories: Tuple[str, ...]) -> bool:
    """Does this expression (or a ternary arm of it) call a lock factory?"""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name is not None and name.split(".")[-1] in factories:
                return True
    return False


def _class_in_annotation(ann: ast.AST, classes: Collection[str]) -> Optional[str]:
    """The single scanned-class name an annotation mentions, if exactly one.

    Handles plain names, ``Optional[T]``-style subscripts, and string
    annotations like ``"JobStore | str"``.
    """
    names: List[str] = []
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        for token in (
            ann.value.replace("|", " ").replace("[", " ").replace("]", " ")
            .replace(",", " ").split()
        ):
            tail = token.split(".")[-1]
            if tail in classes:
                names.append(tail)
    else:
        for node in ast.walk(ann):
            if isinstance(node, ast.Name) and node.id in classes:
                names.append(node.id)
            elif (
                isinstance(node, ast.Attribute)
                and node.attr in classes
            ):
                names.append(node.attr)
    uniq = sorted(set(names))
    return uniq[0] if len(uniq) == 1 else None


def _constructed_class(expr: ast.AST, classes: Collection[str]) -> Optional[str]:
    """Class name constructed anywhere inside ``expr`` (ternaries
    included): ``store if ... else JobStore(store)`` -> ``JobStore``."""
    found: List[str] = []
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name is not None and name.split(".")[-1] in classes:
                found.append(name.split(".")[-1])
    uniq = sorted(set(found))
    return uniq[0] if len(uniq) == 1 else None


def _collect_imports(mod: Module, modname: str) -> Dict[str, Tuple[str, Optional[str]]]:
    out: Dict[str, Tuple[str, Optional[str]]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.setdefault(alias.asname or alias.name.split(".")[0], (alias.name, None))
        elif isinstance(node, ast.ImportFrom):
            parts = modname.split(".") if modname else []
            if node.level > 0:
                base_parts = parts[: max(len(parts) - node.level, 0)]
            else:
                base_parts = []
            if node.module:
                base_parts = base_parts + node.module.split(".")
            base = ".".join(base_parts)
            for alias in node.names:
                if alias.name == "*":
                    continue
                out.setdefault(alias.asname or alias.name, (base, alias.name))
    return out


def _scan_class(
    cg: CallGraph, mod: Module, cls: ast.ClassDef, factories: Tuple[str, ...]
) -> None:
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fid = f"{mod.rel}::{cls.name}.{stmt.name}"
            info = FuncInfo(fid=fid, rel=mod.rel, cls=cls.name, name=stmt.name, node=stmt)
            cg.functions[fid] = info
            cg.by_class_method.setdefault((cls.name, stmt.name), fid)
            _infer_attrs(cg, cls.name, stmt, factories)
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            t = _class_in_annotation(stmt.annotation, cg.index.classes)
            if t is not None:
                cg.attr_types.setdefault((cls.name, stmt.target.id), t)


def _infer_attrs(
    cg: CallGraph, cls: str, fn: FunctionNode, factories: Tuple[str, ...]
) -> None:
    """Attribute types + lock attrs from one method's ``self.x = ...``."""
    param_types: Dict[str, str] = {}
    args = fn.args
    for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
        if a.annotation is not None:
            t = _class_in_annotation(a.annotation, cg.index.classes)
            if t is not None:
                param_types[a.arg] = t
    for node in ast.walk(fn):
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = list(node.targets), node.value
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
            value = node.value
            for tgt in targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    t = _class_in_annotation(node.annotation, cg.index.classes)
                    if t is not None:
                        cg.attr_types.setdefault((cls, tgt.attr), t)
        if value is None:
            continue
        for tgt in targets:
            if not (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                continue
            if _is_lock_factory(value, factories):
                cg.lock_attrs.setdefault((cls, tgt.attr), f"{cls}.{tgt.attr}")
                continue
            t = _constructed_class(value, cg.index.classes)
            if t is None and isinstance(value, ast.Name):
                t = param_types.get(value.id)
            if t is not None:
                cg.attr_types.setdefault((cls, tgt.attr), t)


def build_callgraph(
    modules: List[Module],
    index: TreeIndex,
    lock_factories: Tuple[str, ...] = DEFAULT_LOCK_FACTORIES,
) -> CallGraph:
    cg = CallGraph(index=index)
    for mod in sorted(modules, key=lambda m: m.rel):
        modname = module_name(mod.rel)
        cg.modnames[mod.rel] = modname
        cg.imports[mod.rel] = _collect_imports(mod, modname)
        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fid = f"{mod.rel}::{stmt.name}"
                cg.functions[fid] = FuncInfo(
                    fid=fid, rel=mod.rel, cls=None, name=stmt.name, node=stmt
                )
                cg.by_module_func.setdefault((modname, stmt.name), fid)
            elif isinstance(stmt, ast.Assign):
                if _is_lock_factory(stmt.value, lock_factories):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            cg.module_locks.setdefault(
                                (modname, tgt.id), f"{mod.rel}:{tgt.id}"
                            )
        # classes at any nesting level (e.g. a Handler inside serve())
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                _scan_class(cg, mod, node, lock_factories)
    return cg
