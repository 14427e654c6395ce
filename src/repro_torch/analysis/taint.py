"""RPL005 — interprocedural wall-clock/RNG taint on decision paths.

RPL001–003 flag nondeterministic *call sites*. This pass flags where the
nondeterminism *lands*: a wall-clock or RNG-derived value tracked through
assignments, returns, attribute fields, and resolved calls (on the
shared :class:`~repro_torch.analysis.callgraph.CallGraph`) until it reaches

* an **ordering key** — a tainted argument (or ``key=`` callable) to
  ``sorted``/``min``/``max``/``.sort()``,
* a **decision log** — ``.append()``/``.extend()``/etc. of a tainted
  value onto a recognized log attribute (``decision_log``, ``events``,
  ...) or a call to a configured log-writing method, or
* an **event ordinal** — assignment of a tainted value to a name that
  looks like a sequence counter (``*ordinal*``, ``*seq_no*``, ...).

Mechanics: per function, a flow-insensitive environment (two passes over
the body, no kills — loops converge) maps names to taint labels; a label
is either a concrete source (``"time.time@src/x.py:12"``) or a parameter
index. A global fixpoint (bounded, ≤5 rounds) derives per-function
summaries — which sources and which parameters flow to the return value
— and per-``(class, attr)`` field taint from ``self.x = <tainted>``
writes, so a helper like ``def stamp(): return time.time()`` in another
module taints ``t = stamp()`` at every resolved call site.

Conservative choices: unresolved calls pass their argument taint through
(so ``f"{t}"`` or ``round(t)`` stay tainted); lambdas are opaque except
as ``key=`` at an ordering sink, where the body is evaluated in the
enclosing environment. Only concrete source labels trigger a sink —
a parameter reaching a sink is reported at whichever caller binds a
tainted value to it via a summary, not speculatively. Findings are only
emitted for decision-path modules (same gate as RPL001–004), and the
symbol is the source call name (``time.time``, ``random.random``) so
suppressions read like the RPL001 ones.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.analysis.base import Finding, Module, dotted
from repro_torch.analysis.callgraph import CallGraph, FuncInfo, FunctionNode
from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.determinism import _rng_violation

#: a taint label: concrete source "name@rel:line", or a parameter index
_Label = Union[str, int]
_Taint = Set[_Label]

_ORDER_SINKS = {"sorted", "min", "max"}
_LOG_APPENDERS = {"append", "extend", "insert", "add", "appendleft"}
_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


@dataclass(frozen=True)
class _Summary:
    ret_sources: FrozenSet[str]
    ret_params: FrozenSet[int]


_EMPTY_SUMMARY = _Summary(ret_sources=frozenset(), ret_params=frozenset())


def _source_of_call(call: ast.Call, cfg: AnalysisConfig, rel: str) -> Optional[str]:
    name = dotted(call.func)
    if name is None:
        return None
    for suffix in cfg.wall_clock_calls:
        if name == suffix or name.endswith("." + suffix):
            return f"{suffix}@{rel}:{call.lineno}"
    if name == "hash":
        return f"hash@{rel}:{call.lineno}"
    if _rng_violation(name, call) is not None:
        return f"{name}@{rel}:{call.lineno}"
    return None


def _param_names(fn: FunctionNode) -> List[str]:
    args = fn.args
    return [a.arg for a in list(args.posonlyargs) + list(args.args)]


def _src_only(taint: _Taint) -> FrozenSet[str]:
    return frozenset(lbl for lbl in taint if isinstance(lbl, str))


class _FuncTaint:
    """Intraprocedural environment + summary for one function."""

    def __init__(
        self,
        info: FuncInfo,
        cg: CallGraph,
        cfg: AnalysisConfig,
        summaries: Dict[str, _Summary],
        fields: Dict[Tuple[str, str], FrozenSet[str]],
    ):
        self.info = info
        self.cg = cg
        self.cfg = cfg
        self.summaries = summaries
        self.fields = fields
        self.env: Dict[str, _Taint] = {
            name: {i} for i, name in enumerate(_param_names(info.node))
        }
        self.ret: _Taint = set()
        self.field_writes: Dict[Tuple[str, str], Set[str]] = {}

    def run(self) -> None:
        for _ in range(2):  # second pass fixes use-before-def in loops
            for stmt in self.info.node.body:
                self._stmt(stmt)

    # -- expression taint -------------------------------------------------

    def taint_of(self, node: ast.expr) -> _Taint:
        if isinstance(node, ast.Name):
            return set(self.env.get(node.id, set()))
        if isinstance(node, ast.Constant):
            return set()
        if isinstance(node, ast.Lambda):
            return set()  # opaque until applied (see ordering-key sinks)
        if isinstance(node, ast.Call):
            return self._call_taint(node)
        if isinstance(node, ast.Attribute):
            attr_self = (
                isinstance(node.value, ast.Name) and node.value.id == "self"
            )
            if attr_self and self.info.cls is not None:
                out: _Taint = set()
                for cls in self.cg.class_chain(self.info.cls):
                    out |= self.fields.get((cls, node.attr), frozenset())
                return out
            return self.taint_of(node.value)  # obj.t carries obj's taint
        out = set()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr) and not isinstance(child, ast.Lambda):
                out |= self.taint_of(child)
        return out

    def _call_taint(self, call: ast.Call) -> _Taint:
        src = _source_of_call(call, self.cfg, self.info.rel)
        if src is not None:
            return {src}
        arg_taints = [self.taint_of(a) for a in call.args]
        kw_taints = {
            kw.arg: self.taint_of(kw.value) for kw in call.keywords if kw.arg
        }
        fid = self.cg.resolve_call(call, self.info)
        if fid is None:
            # conservative pass-through: str(t), round(t), f-string pieces
            out: _Taint = set()
            for t in arg_taints:
                out |= t
            for t in kw_taints.values():
                out |= t
            if isinstance(call.func, ast.Attribute):
                out |= self.taint_of(call.func.value)
            return out
        callee = self.cg.functions[fid]
        summary = self.summaries.get(fid, _EMPTY_SUMMARY)
        out = set(summary.ret_sources)
        if not summary.ret_params:
            return out
        offset = 1 if callee.cls is not None else 0
        params = _param_names(callee.node)
        for p in summary.ret_params:
            if p == 0 and offset == 1:
                if isinstance(call.func, ast.Attribute):
                    out |= self.taint_of(call.func.value)
                continue
            j = p - offset
            if 0 <= j < len(arg_taints):
                out |= arg_taints[j]
            elif p < len(params) and params[p] in kw_taints:
                out |= kw_taints[params[p]]
        return out

    # -- statement walk ---------------------------------------------------

    def _bind(self, tgt: ast.expr, taint: _Taint) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._bind(elt, taint)
            return
        if isinstance(tgt, ast.Starred):
            self._bind(tgt.value, taint)
            return
        node = tgt
        if isinstance(node, ast.Subscript):
            node = node.value  # container taint: self.x[k] = t taints self.x
        if isinstance(node, ast.Name):
            self.env.setdefault(node.id, set()).update(taint)
            return
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and self.info.cls is not None
        ):
            srcs = _src_only(taint)
            if srcs:
                self.field_writes.setdefault(
                    (self.info.cls, node.attr), set()
                ).update(srcs)

    def _stmt(self, node: ast.stmt) -> None:
        if isinstance(node, _SCOPE_NODES):
            return
        if isinstance(node, ast.Return):
            if node.value is not None:
                self.ret |= self.taint_of(node.value)
            return
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            if node.value is None:
                return
            taint = self.taint_of(node.value)
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
                taint |= self.env.get(node.target.id, set())
            for tgt in targets:
                self._bind(tgt, taint)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._bind(node.target, self.taint_of(node.iter))
            for stmt in node.body + node.orelse:
                self._stmt(stmt)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, self.taint_of(item.context_expr))
            for stmt in node.body:
                self._stmt(stmt)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            elif isinstance(child, (ast.excepthandler, ast.match_case)):
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, ast.stmt):
                        self._stmt(sub)

    def summary(self) -> _Summary:
        return _Summary(
            ret_sources=_src_only(self.ret),
            ret_params=frozenset(lbl for lbl in self.ret if isinstance(lbl, int)),
        )


# ----------------------------------------------------------------------
# sinks
# ----------------------------------------------------------------------


def _fmt_sources(srcs: FrozenSet[str]) -> Tuple[str, str]:
    """(human list, suppression symbol) for a set of source labels."""
    pretty = sorted(f"{lbl.split('@')[0]} ({lbl.split('@')[1]})" for lbl in srcs)
    symbol = sorted(lbl.split("@")[0] for lbl in srcs)[0]
    return ", ".join(pretty), symbol


class _SinkCollector:
    def __init__(self, ft: _FuncTaint):
        self.ft = ft
        self.cfg = ft.cfg
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        stack: List[ast.AST] = list(self.ft.info.node.body)
        while stack:
            node = stack.pop()
            if isinstance(node, _SCOPE_NODES):
                continue
            if isinstance(node, ast.Call):
                self._check_call(node)
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                self._check_ordinal(node)
            stack.extend(ast.iter_child_nodes(node))
        return self.findings

    def _lambda_aware_taint(self, node: ast.expr) -> _Taint:
        """Taint of a ``key=`` argument: a lambda's body is evaluated in
        the enclosing environment (minus its own parameters)."""
        if isinstance(node, ast.Lambda):
            shadowed = {
                a.arg for a in list(node.args.posonlyargs) + list(node.args.args)
            }
            saved = {k: self.ft.env.pop(k) for k in shadowed if k in self.ft.env}
            try:
                return self.ft.taint_of(node.body)
            finally:
                self.ft.env.update(saved)
        return self.ft.taint_of(node)

    def _flag(self, node: ast.AST, what: str, srcs: FrozenSet[str]) -> None:
        pretty, symbol = _fmt_sources(srcs)
        self.findings.append(
            Finding(
                rule="RPL005",
                path=self.ft.info.rel,
                line=getattr(node, "lineno", 1),
                col=getattr(node, "col_offset", 0),
                message=(
                    f"wall-clock/RNG-derived value reaches {what}; "
                    f"sources: {pretty} — decisions must be a pure function "
                    "of the trace, even through helpers"
                ),
                symbol=symbol,
            )
        )

    def _check_call(self, call: ast.Call) -> None:
        name = dotted(call.func)
        base = name.split(".")[-1] if name else None
        is_sort_method = isinstance(call.func, ast.Attribute) and call.func.attr == "sort"
        if base in _ORDER_SINKS or is_sort_method:
            srcs: Set[str] = set()
            for arg in call.args:
                srcs |= _src_only(self.ft.taint_of(arg))
            for kw in call.keywords:
                if kw.arg == "key":
                    srcs |= _src_only(self._lambda_aware_taint(kw.value))
            if srcs:
                desc = f".sort()" if is_sort_method else f"{base}() ordering"
                self._flag(call, f"an ordering key ({desc})", frozenset(srcs))
            return
        if not isinstance(call.func, ast.Attribute):
            return
        attr = call.func.attr
        recv = dotted(call.func.value)
        recv_tail = recv.split(".")[-1] if recv else None
        if attr in _LOG_APPENDERS and recv_tail in self.cfg.taint_log_names:
            srcs = set()
            for arg in call.args:
                srcs |= _src_only(self.ft.taint_of(arg))
            if srcs:
                self._flag(call, f"the decision log ({recv_tail}.{attr})", frozenset(srcs))
        elif attr in self.cfg.taint_sink_calls:
            srcs = set()
            for arg in call.args:
                srcs |= _src_only(self.ft.taint_of(arg))
            for kw in call.keywords:
                srcs |= _src_only(self.ft.taint_of(kw.value))
            if srcs:
                self._flag(call, f"a decision-log write ({attr}())", frozenset(srcs))

    def _check_ordinal(self, node: ast.stmt) -> None:
        assert isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign))
        if node.value is None:
            return
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        names: List[str] = []
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                names.append(tgt.id)
            elif isinstance(tgt, ast.Attribute):
                names.append(tgt.attr)
        hit = next(
            (
                n
                for n in names
                if any(marker in n.lower() for marker in self.cfg.taint_ordinal_markers)
            ),
            None,
        )
        if hit is None:
            return
        srcs = _src_only(self.ft.taint_of(node.value))
        if srcs:
            self._flag(node, f"an event ordinal ({hit})", frozenset(srcs))


# ----------------------------------------------------------------------
# the pass
# ----------------------------------------------------------------------


def check_taint(cg: CallGraph, cfg: AnalysisConfig) -> List[Finding]:
    fids = sorted(
        cg.functions, key=lambda fid: (cg.functions[fid].rel,
                                       cg.functions[fid].node.lineno, fid)
    )
    summaries: Dict[str, _Summary] = {}
    fields: Dict[Tuple[str, str], FrozenSet[str]] = {}
    for _ in range(5):  # bounded global fixpoint
        changed = False
        for fid in fids:
            ft = _FuncTaint(cg.functions[fid], cg, cfg, summaries, fields)
            ft.run()
            summary = ft.summary()
            if summaries.get(fid) != summary:
                summaries[fid] = summary
                changed = True
            for key, srcs in ft.field_writes.items():
                merged = fields.get(key, frozenset()) | srcs
                if merged != fields.get(key):
                    fields[key] = merged
                    changed = True
        if not changed:
            break

    findings: List[Finding] = []
    seen: Set[Tuple[str, int, int, str]] = set()
    for fid in fids:
        info = cg.functions[fid]
        if not cfg.is_decision_path(info.rel):
            continue
        ft = _FuncTaint(info, cg, cfg, summaries, fields)
        ft.run()
        for f in _SinkCollector(ft).run():
            key = (f.path, f.line, f.col, f.symbol)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.symbol))
    return findings
