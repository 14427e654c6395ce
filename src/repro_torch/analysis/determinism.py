"""RPL00x — determinism lint for decision-path modules.

The scheduler contract (differential suite, ROADMAP "dual-engine
determinism") requires every scheduling decision to be a pure function of
the trace: same jobs in, same decision log out, across processes and
engines. Four things silently break that in Python:

RPL001  wall-clock reads (``time.time``/``datetime.now``/monotonic/
        perf_counter): a decision derived from the host clock differs
        run-to-run. Timestamps written purely as record metadata are
        suppressed per-file in ``analysis.toml`` with a reason.
RPL002  global/unseeded RNGs (``random.random``, legacy
        ``numpy.random.*`` module API, seedless ``Random()`` /
        ``default_rng()``). Seeded generator *instances* are fine.
RPL003  builtin ``hash()``: salted per-process for str/bytes via
        PYTHONHASHSEED, so anything it feeds (ordering, seeding, lane
        choice) forks between runs. Use an explicit key or crc32.
RPL004  order-sensitive consumption of an unordered ``set`` — a bare
        ``for`` over a set, or ``min``/``max``/``list``/``next``/... of
        one — where iteration order leaks into a scheduling choice.
        ``sorted(s)`` (explicit total order) and order-free folds
        (``sum``/``len``/``any``/``all``/membership) are fine. Dict
        iteration is insertion-ordered in Python and exempt; sets are
        where nondeterminism actually enters. ``min``/``max`` over a set
        *are* flagged: ties under the key are broken by iteration order.

Set-typedness is inferred statically: set literals/comprehensions,
``set()``/``frozenset()`` calls, annotations, local assignment from
those, attribute names any scanned class assigns as a set, and unions /
intersections / differences thereof. Name-based attribute matching can
overreach in principle; in this tree attribute names like ``paged`` or
``_active`` are distinctive, and false positives are suppressable.
"""
from __future__ import annotations

import ast
from typing import FrozenSet, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.base import (
    Finding,
    Module,
    TreeIndex,
    dotted,
    is_set_annotation,
    is_set_expr_literal,
)
from repro_torch.analysis.config import AnalysisConfig

# random-module functions that consume the hidden global RNG state
_RANDOM_GLOBAL_FNS = {
    "betavariate", "choice", "choices", "expovariate", "gammavariate",
    "gauss", "getrandbits", "lognormvariate", "normalvariate",
    "paretovariate", "randbytes", "randint", "random", "randrange",
    "sample", "shuffle", "triangular", "uniform", "vonmisesvariate",
    "weibullvariate",
}

# numpy.random names that construct explicit generators (seedlessness is
# checked separately); everything else on numpy.random is the legacy
# global-state API
_NP_RANDOM_CONSTRUCTORS = {"default_rng", "Generator", "RandomState", "SeedSequence"}

# order-sensitive single-iterable consumers of a set
_ORDER_SENSITIVE_CALLS = {"min", "max", "next", "iter", "list", "tuple", "enumerate"}

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def check_determinism(
    mod: Module, cfg: AnalysisConfig, index: TreeIndex
) -> List[Finding]:
    if not cfg.is_decision_path(mod.rel):
        return []
    findings = _check_clock_and_rng(mod, cfg)
    findings.extend(_SetIterationChecker(mod, index).run())
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def _check_clock_and_rng(mod: Module, cfg: AnalysisConfig) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name is None:
            continue
        # RPL001 — suffix match so `datetime.datetime.now` hits "datetime.now"
        for suffix in cfg.wall_clock_calls:
            if name == suffix or name.endswith("." + suffix):
                findings.append(
                    Finding(
                        rule="RPL001",
                        path=mod.rel,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"wall-clock read {name}() on a decision path; "
                            "decisions must be a pure function of the trace "
                            "(suppress in analysis.toml if this only stamps "
                            "record metadata)"
                        ),
                        symbol=suffix,
                    )
                )
                break
        # RPL003
        if name == "hash":
            findings.append(
                Finding(
                    rule="RPL003",
                    path=mod.rel,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        "builtin hash() is salted per-process (PYTHONHASHSEED); "
                        "use an explicit key or zlib.crc32 for anything feeding "
                        "ordering or seeding"
                    ),
                    symbol="hash",
                )
            )
        # RPL002
        msg = _rng_violation(name, node)
        if msg is not None:
            findings.append(
                Finding(
                    rule="RPL002",
                    path=mod.rel,
                    line=node.lineno,
                    col=node.col_offset,
                    message=msg,
                    symbol=name,
                )
            )
    return findings


def _rng_violation(name: str, node: ast.Call) -> Optional[str]:
    parts = name.split(".")
    if parts[0] == "random" and len(parts) == 2:
        if parts[1] in _RANDOM_GLOBAL_FNS:
            return (
                f"{name}() draws from the hidden module-global RNG; "
                "use an explicitly seeded random.Random(seed) instance"
            )
        if parts[1] == "Random" and not node.args and not node.keywords:
            return "random.Random() without a seed is OS-entropy seeded"
        return None
    if parts[0] in ("np", "numpy") and len(parts) == 3 and parts[1] == "random":
        tail = parts[2]
        if tail in _NP_RANDOM_CONSTRUCTORS:
            if tail in ("default_rng", "RandomState") and not node.args and not node.keywords:
                return f"{name}() without a seed is OS-entropy seeded"
            return None
        return (
            f"{name}() uses numpy's legacy global RNG state; "
            "use an explicitly seeded np.random.default_rng(seed)"
        )
    return None


def _shallow(body: Iterable[ast.stmt]) -> Tuple[List[ast.AST], List[ast.AST]]:
    """All AST nodes under ``body`` without descending into nested
    function/class scopes. Returns ``(nodes, nested_scopes)``."""
    nodes: List[ast.AST] = []
    scopes: List[ast.AST] = []
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, _SCOPE_NODES):
            scopes.append(node)
            continue
        nodes.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return nodes, scopes


class _SetIterationChecker:
    """RPL004 — flag order-sensitive consumption of set-typed expressions."""

    def __init__(self, mod: Module, index: TreeIndex):
        self.mod = mod
        self.index = index
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        self._scan(self.mod.tree.body, frozenset())
        return self.findings

    def _scan(self, body: List[ast.stmt], inherited: FrozenSet[str]) -> None:
        nodes, scopes = _shallow(body)
        local = set(inherited) | self._assigned_sets(nodes)
        for node in nodes:
            self._check_node(node, local)
        for scope in scopes:
            if isinstance(scope, ast.ClassDef):
                # methods don't see class-body names; pass the enclosure
                self._scan(scope.body, inherited)
            else:
                inner = frozenset(local) | self._annotated_set_args(scope)
                self._scan(scope.body, inner)

    def _assigned_sets(self, nodes: List[ast.AST]) -> Set[str]:
        names: Set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Assign) and self._is_set_valued(node.value, names):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
            elif isinstance(node, ast.AnnAssign):
                if isinstance(node.target, ast.Name) and is_set_annotation(
                    node.annotation
                ):
                    names.add(node.target.id)
        return names

    @staticmethod
    def _annotated_set_args(fn: ast.AST) -> Set[str]:
        names: Set[str] = set()
        args = getattr(fn, "args", None)
        if args is None:
            return names
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            if a.annotation is not None and is_set_annotation(a.annotation):
                names.add(a.arg)
        return names

    def _is_set_valued(self, node: ast.AST, local_sets: Set[str]) -> bool:
        if is_set_expr_literal(node):
            return True
        if isinstance(node, ast.Name):
            return node.id in local_sets
        if isinstance(node, ast.Attribute):
            return node.attr in self.index.set_attrs
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
        ):
            return self._is_set_valued(node.left, local_sets) or self._is_set_valued(
                node.right, local_sets
            )
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in (
                "union", "intersection", "difference", "symmetric_difference", "copy",
            ):
                return self._is_set_valued(node.func.value, local_sets)
        return False

    def _check_node(self, node: ast.AST, local_sets: Set[str]) -> None:
        if isinstance(node, (ast.For, ast.AsyncFor)) and self._is_set_valued(
            node.iter, local_sets
        ):
            self._flag(node.iter, "for-loop over")
        elif isinstance(node, ast.Call):
            fname = dotted(node.func)
            if (
                fname in _ORDER_SENSITIVE_CALLS
                and len(node.args) == 1
                and not isinstance(node.args[0], ast.Starred)
                and self._is_set_valued(node.args[0], local_sets)
            ):
                self._flag(node.args[0], f"{fname}() over")

    def _describe(self, node: ast.AST) -> str:
        name = dotted(node)
        if name is not None:
            return name
        if isinstance(node, ast.Attribute):
            return node.attr
        return type(node).__name__

    def _flag(self, expr: ast.AST, how: str) -> None:
        desc = self._describe(expr)
        symbol = (
            self.index.set_attrs.get(expr.attr, desc)
            if isinstance(expr, ast.Attribute)
            else desc
        )
        self.findings.append(
            Finding(
                rule="RPL004",
                path=self.mod.rel,
                line=getattr(expr, "lineno", 1),
                col=getattr(expr, "col_offset", 0),
                message=(
                    f"{how} unordered set {desc!r}: iteration order is "
                    "arbitrary and can leak into a scheduling choice; wrap in "
                    "sorted(...) with an explicit key"
                ),
                symbol=symbol,
            )
        )
