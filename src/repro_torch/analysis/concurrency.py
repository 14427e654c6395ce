"""RPL04x — cross-file concurrency analysis over the shared call graph.

Second-generation siblings of the lexical RPL03x rules. All three run on
events collected by one walker that tracks the set of locks *held* at
every point in a function, where "held" means:

* lexically inside ``with <lock>:`` for a lock the
  :class:`~repro_torch.analysis.callgraph.CallGraph` lock index resolves, or
* lexically inside ``with <call>():`` for a call whose resolved callee
  *may acquire* locks (transitively) — this is what makes
  ``with self.store.transaction():`` count as holding ``JobStore._lock``
  without modelling ``@contextmanager`` semantics, and
* for RPL041 only, additionally the locks *every* resolved caller holds
  at *every* call site (must-hold-at-entry inference), so a helper that
  is only ever invoked under the lock is not a false positive.

RPL040  **lock-order cycles.** Acquiring lock B (directly, or by calling
        a function that may acquire it) while holding lock A adds the
        edge A→B to a global lock-order graph; any strongly-connected
        component with two or more locks is a potential deadlock. This
        is the machine-checked version of the ctl→store ordering rule
        the control plane keeps by hand.

RPL041  **guarded-field inference.** Per class attribute accessed by
        2+ sites outside ``__init__``, infer the dominating guard: the
        lock held on most accesses, if it covers at least half of them
        (two thirds for never-mutated attributes, which must also be
        read from 2+ functions — read-only config attributes produce no
        inference). Every access not holding the inferred guard is
        flagged. Unlike RPL031 this needs no configured attr list: the
        evidence is the code's own locking pattern.

RPL042  **blocking under a lock.** ``time.sleep``, ``serve_forever``,
        socket I/O methods, and SQLite transaction control
        (``commit()`` / ``execute("BEGIN ..."/"COMMIT"/"ROLLBACK")``)
        while lexically holding any lock: every other thread contending
        for that lock now waits on the clock, the peer, or the disk.
        Sanctioned cases (a store whose entire point is serializing
        sqlite under its lock) get a reasoned suppression.

``.acquire()`` calls are recorded as acquisition *events* (they feed the
RPL040 edge set) but do not extend the held region — prefer ``with``;
CONTRIBUTING documents the conventions this analysis relies on.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional, Set, Tuple

from repro_torch.analysis.base import Finding, Module, dotted
from repro_torch.analysis.callgraph import CallGraph, FuncInfo
from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.discipline import _MUTATORS

_EMPTY: FrozenSet[str] = frozenset()
_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)

#: words opening/closing a SQLite transaction when passed to .execute()
_SQL_TXN_WORDS = ("BEGIN", "COMMIT", "ROLLBACK")


@dataclass(frozen=True)
class _Acquire:
    lock: str
    held: FrozenSet[str]  # locks already held when acquiring
    line: int
    col: int


@dataclass(frozen=True)
class _CallSite:
    callee: str  # fid
    held: FrozenSet[str]
    line: int
    col: int


@dataclass(frozen=True)
class _Access:
    cls: str
    attr: str
    kind: str  # "read" | "write"
    held: FrozenSet[str]
    line: int
    col: int


@dataclass(frozen=True)
class _Blocking:
    desc: str
    symbol: str
    held: FrozenSet[str]
    line: int
    col: int


@dataclass
class _Events:
    acquires: List[_Acquire] = field(default_factory=list)
    calls: List[_CallSite] = field(default_factory=list)
    accesses: List[_Access] = field(default_factory=list)
    blocking: List[_Blocking] = field(default_factory=list)


def _blocking_match(call: ast.Call, cfg: AnalysisConfig) -> Optional[Tuple[str, str]]:
    """(description, symbol) when ``call`` is a known blocking operation."""
    name = dotted(call.func)
    if name is not None:
        for b in cfg.blocking_calls:
            if name == b or name.endswith("." + b):
                return f"{name}()", b
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in cfg.blocking_attrs:
            return f".{attr}()", attr
        if attr == "execute" and call.args:
            first = call.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                word = first.value.strip().split(" ", 1)[0].upper()
                if word in _SQL_TXN_WORDS:
                    return f'.execute("{word} ...")', f"sqlite:{word}"
    return None


class _FuncWalker:
    """Collect lock/call/access/blocking events for one function.

    ``ctx_locks`` maps a resolved with-item call to the locks its callee
    may acquire (empty on the bootstrap pass that computes exactly that).
    """

    def __init__(
        self,
        info: FuncInfo,
        cg: CallGraph,
        cfg: AnalysisConfig,
        ctx_locks: Callable[[str], FrozenSet[str]],
    ):
        self.info = info
        self.cg = cg
        self.cfg = cfg
        self.ctx_locks = ctx_locks
        self.events = _Events()
        self._consumed: Set[int] = set()  # Attribute nodes already classified

    def run(self) -> _Events:
        for stmt in self.info.node.body:
            self._stmt(stmt, _EMPTY)
        return self.events

    # -- helpers ---------------------------------------------------------

    def _self_attr(self, node: ast.AST) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        return None

    def _record_access(self, node: ast.Attribute, kind: str, held: FrozenSet[str]) -> None:
        cls = self.info.cls
        attr = node.attr
        if cls is None:
            return
        if self.cg.lock_of_attr(cls, attr) is not None:
            return  # the lock itself, not data it guards
        if self.cg.resolve_method(cls, attr) is not None:
            return  # bound-method reference, not shared data
        self.events.accesses.append(
            _Access(cls=cls, attr=attr, kind=kind, held=held,
                    line=node.lineno, col=node.col_offset)
        )
        self._consumed.add(id(node))

    def _locks_of_with_item(
        self, expr: ast.expr, held: FrozenSet[str]
    ) -> FrozenSet[str]:
        lock = self.cg.lock_of_expr(expr, self.info)
        if lock is not None:
            self.events.acquires.append(
                _Acquire(lock=lock, held=held, line=expr.lineno, col=expr.col_offset)
            )
            return frozenset((lock,))
        if isinstance(expr, ast.Call):
            fid = self.cg.resolve_call(expr, self.info)
            if fid is not None:
                return self.ctx_locks(fid)
        return _EMPTY

    # -- statement / expression walk -------------------------------------

    def _stmt(self, node: ast.stmt, held: FrozenSet[str]) -> None:
        if isinstance(node, _SCOPE_NODES):
            return  # nested scopes run later, outside this dynamic extent
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                self._expr(item.context_expr, inner)
                inner = inner | self._locks_of_with_item(item.context_expr, inner)
            for stmt in node.body:
                self._stmt(stmt, inner)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                self._classify_target(tgt, held)
            if node.value is not None:
                self._expr(node.value, held)
            for tgt in targets:
                self._expr(tgt, held)
            return
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                self._classify_target(tgt, held)
                self._expr(tgt, held)
            return
        # generic statement: walk expression children, recurse into bodies
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child, held)
            elif isinstance(child, ast.expr):
                self._expr(child, held)
            elif isinstance(child, (ast.excepthandler, ast.match_case)):
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, ast.stmt):
                        self._stmt(sub, held)
                    elif isinstance(sub, ast.expr):
                        self._expr(sub, held)

    def _classify_target(self, tgt: ast.expr, held: FrozenSet[str]) -> None:
        """Mark writes: ``self.x = / del self.x / self.x[k] =``."""
        if isinstance(tgt, ast.Tuple):
            for elt in tgt.elts:
                self._classify_target(elt, held)
            return
        node = tgt
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute) and self._self_attr(node) is not None:
            self._record_access(node, "write", held)

    def _expr(self, node: ast.expr, held: FrozenSet[str]) -> None:
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.Call):
            self._call(node, held)
            return
        if isinstance(node, ast.Attribute):
            if id(node) not in self._consumed and self._self_attr(node) is not None:
                if isinstance(node.ctx, ast.Load):
                    self._record_access(node, "read", held)
            self._expr(node.value, held)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, held)

    def _call(self, call: ast.Call, held: FrozenSet[str]) -> None:
        # <lock>.acquire(): an acquisition event (feeds the order graph);
        # the held region is not extended — with-blocks are the convention
        if isinstance(call.func, ast.Attribute) and call.func.attr in ("acquire", "release"):
            lock = self.cg.lock_of_expr(call.func.value, self.info)
            if lock is not None:
                if call.func.attr == "acquire":
                    self.events.acquires.append(
                        _Acquire(lock=lock, held=held,
                                 line=call.lineno, col=call.col_offset)
                    )
                for arg in call.args:
                    self._expr(arg, held)
                return
        # a mutating method call on self.<attr> is a write to it
        if isinstance(call.func, ast.Attribute) and call.func.attr in _MUTATORS:
            recv = call.func.value
            if isinstance(recv, ast.Attribute) and self._self_attr(recv) is not None:
                self._record_access(recv, "write", held)
        if held:
            hit = _blocking_match(call, self.cfg)
            if hit is not None:
                self.events.blocking.append(
                    _Blocking(desc=hit[0], symbol=hit[1], held=held,
                              line=call.lineno, col=call.col_offset)
                )
        fid = self.cg.resolve_call(call, self.info)
        if fid is not None:
            self.events.calls.append(
                _CallSite(callee=fid, held=held, line=call.lineno, col=call.col_offset)
            )
        if isinstance(call.func, ast.Attribute):
            # receiver attribute chain is still a read (`self._conn.execute`)
            self._expr(call.func, held)
        for arg in call.args:
            self._expr(arg, held)
        for kw in call.keywords:
            self._expr(kw.value, held)


# ----------------------------------------------------------------------
# the pass
# ----------------------------------------------------------------------


def _sorted_fids(cg: CallGraph) -> List[str]:
    return sorted(cg.functions, key=lambda fid: (cg.functions[fid].rel,
                                                 cg.functions[fid].node.lineno, fid))


def _may_acquire(
    cg: CallGraph, events: Dict[str, _Events]
) -> Dict[str, FrozenSet[str]]:
    """Transitive closure: locks a call to ``fid`` may take."""
    may: Dict[str, Set[str]] = {
        fid: {a.lock for a in ev.acquires} for fid, ev in events.items()
    }
    changed = True
    while changed:
        changed = False
        for fid, ev in events.items():
            cur = may[fid]
            before = len(cur)
            for site in ev.calls:
                cur |= may.get(site.callee, set())
            if len(cur) != before:
                changed = True
    return {fid: frozenset(locks) for fid, locks in may.items()}


def _entry_held(
    cg: CallGraph, events: Dict[str, _Events], all_locks: FrozenSet[str]
) -> Dict[str, FrozenSet[str]]:
    """Must-analysis: locks held at *every* resolved call of each function."""
    callers: Dict[str, List[Tuple[str, FrozenSet[str]]]] = {}
    for fid, ev in events.items():
        for site in ev.calls:
            callers.setdefault(site.callee, []).append((fid, site.held))
    entry: Dict[str, FrozenSet[str]] = {
        fid: (all_locks if fid in callers else _EMPTY) for fid in events
    }
    for _ in range(20):
        changed = False
        for fid in events:
            sites = callers.get(fid)
            if not sites:
                continue
            new = all_locks
            for caller, held in sites:
                new = new & (held | entry.get(caller, _EMPTY))
            if new != entry[fid]:
                entry[fid] = new
                changed = True
        if not changed:
            break
    return entry


def _lock_order_findings(
    cg: CallGraph,
    events: Dict[str, _Events],
    may: Dict[str, FrozenSet[str]],
    cfg: AnalysisConfig,
) -> List[Finding]:
    # edge (A, B) -> first witnessing site (rel, line, description)
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for fid in _sorted_fids(cg):
        info = cg.functions[fid]
        ev = events[fid]
        for acq in ev.acquires:
            for a in acq.held:
                if a != acq.lock:
                    edges.setdefault(
                        (a, acq.lock),
                        (info.rel, acq.line, f"{info.qualname}() acquires {acq.lock}"),
                    )
        for site in ev.calls:
            for b in may.get(site.callee, _EMPTY) - site.held:
                callee = cg.functions[site.callee]
                for a in site.held:
                    if a != b:
                        edges.setdefault(
                            (a, b),
                            (
                                info.rel,
                                site.line,
                                f"{info.qualname}() calls {callee.qualname}() "
                                f"which may acquire {b}",
                            ),
                        )
    # SCCs of the lock-order graph (small: iterative Tarjan is overkill,
    # but keeps us safe from pathological configs)
    adj: Dict[str, List[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    for succ in adj.values():
        succ.sort()
    sccs = _tarjan(adj)
    findings: List[Finding] = []
    for scc in sccs:
        if len(scc) < 2:
            continue
        members = sorted(scc)
        cycle_edges = sorted(
            (site[0], site[1], a, b, site[2])
            for (a, b), site in edges.items()
            if a in scc and b in scc
        )
        in_path = [e for e in cycle_edges if cfg.is_concurrency_path(e[0])]
        if not in_path:
            continue
        rel, line, _, _, _ = in_path[0]
        chain = "; ".join(f"{a} -> {b} ({r}:{ln}: {d})" for r, ln, a, b, d in cycle_edges)
        findings.append(
            Finding(
                rule="RPL040",
                path=rel,
                line=line,
                col=0,
                message=(
                    f"lock-order cycle between {' and '.join(members)}: {chain} "
                    "— threads taking these locks in different orders can "
                    "deadlock; pick one global order"
                ),
                symbol=",".join(members),
            )
        )
    return findings


def _tarjan(adj: Dict[str, List[str]]) -> List[FrozenSet[str]]:
    """Iterative Tarjan SCC over a small graph; deterministic output."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[FrozenSet[str]] = []
    counter = 0

    for root in sorted(adj):
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter
                counter += 1
                stack.append(node)
                on_stack.add(node)
            advanced = False
            succs = adj[node]
            while pi < len(succs):
                succ = succs[pi]
                pi += 1
                if succ not in index:
                    work[-1] = (node, pi)
                    work.append((succ, 0))
                    advanced = True
                    break
                if succ in on_stack:
                    low[node] = min(low[node], index[succ])
            if advanced:
                continue
            work.pop()
            if low[node] == index[node]:
                comp: Set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                sccs.append(frozenset(comp))
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return sccs


#: inference thresholds — an attribute needs this much evidence before
#: RPL041 believes a lock is its guard
_MIN_GUARDED = 2


def _guarded_field_findings(
    cg: CallGraph,
    events: Dict[str, _Events],
    entry: Dict[str, FrozenSet[str]],
    cfg: AnalysisConfig,
) -> List[Finding]:
    # (class, attr) -> [(access, effective_held, rel, fid)]
    by_attr: Dict[Tuple[str, str], List[Tuple[_Access, FrozenSet[str], str, str]]] = {}
    for fid in _sorted_fids(cg):
        info = cg.functions[fid]
        if info.name == "__init__":
            continue  # construction precedes every other thread
        for acc in events[fid].accesses:
            eff = acc.held | entry.get(fid, _EMPTY)
            by_attr.setdefault((acc.cls, acc.attr), []).append(
                (acc, eff, info.rel, fid)
            )
    findings: List[Finding] = []
    for (cls, attr), rows in sorted(by_attr.items()):
        total = len(rows)
        if total < 2:
            continue
        mutated = any(acc.kind == "write" for acc, _, _, _ in rows)
        counts: Dict[str, int] = {}
        for _, eff, _, _ in rows:
            for lock in eff:
                counts[lock] = counts.get(lock, 0) + 1
        if not counts:
            continue
        best = max(sorted(counts), key=lambda k: counts[k])
        best_n = counts[best]
        if best_n < _MIN_GUARDED:
            continue
        if mutated:
            if best_n * 2 < total:
                continue
        else:
            if best_n * 3 < total * 2:
                continue
            if len({fid for _, _, _, fid in rows}) < 2:
                continue
        for acc, eff, rel, _ in rows:
            if best in eff or not cfg.is_concurrency_path(rel):
                continue
            findings.append(
                Finding(
                    rule="RPL041",
                    path=rel,
                    line=acc.line,
                    col=acc.col,
                    message=(
                        f"{acc.kind} of {cls}.{attr} without {best} "
                        f"(inferred guard: held on {best_n}/{total} accesses"
                        f"{'' if mutated else ', attribute never mutated'}); "
                        "take the lock or suppress with a reason"
                    ),
                    symbol=f"{cls}.{attr}",
                )
            )
    return findings


def _blocking_findings(
    cg: CallGraph, events: Dict[str, _Events], cfg: AnalysisConfig
) -> List[Finding]:
    findings: List[Finding] = []
    for fid in _sorted_fids(cg):
        info = cg.functions[fid]
        if not cfg.is_concurrency_path(info.rel):
            continue
        for blk in events[fid].blocking:
            held = ", ".join(sorted(blk.held))
            findings.append(
                Finding(
                    rule="RPL042",
                    path=info.rel,
                    line=blk.line,
                    col=blk.col,
                    message=(
                        f"blocking call {blk.desc} while holding {held}: every "
                        "thread contending for the lock now waits on the "
                        "clock/peer/disk; move the call outside the critical "
                        "section or suppress with a reason"
                    ),
                    symbol=blk.symbol,
                )
            )
    return findings


def check_concurrency(cg: CallGraph, cfg: AnalysisConfig) -> List[Finding]:
    """Run RPL040/041/042 over a prebuilt call graph."""
    fids = _sorted_fids(cg)
    # bootstrap pass: direct acquisitions + call sites, no context locks
    boot: Dict[str, _Events] = {
        fid: _FuncWalker(cg.functions[fid], cg, cfg, lambda _fid: _EMPTY).run()
        for fid in fids
    }
    may = _may_acquire(cg, boot)
    # full pass: with-item calls contribute their callee's may-acquire set
    events: Dict[str, _Events] = {
        fid: _FuncWalker(
            cg.functions[fid], cg, cfg, lambda f: may.get(f, _EMPTY)
        ).run()
        for fid in fids
    }
    entry = _entry_held(cg, events, cg.all_locks())
    findings = _lock_order_findings(cg, events, may, cfg)
    findings.extend(_guarded_field_findings(cg, events, entry, cfg))
    findings.extend(_blocking_findings(cg, events, cfg))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
