"""File collection, rule dispatch, suppression filtering, reporting.

Two passes: pass 1 parses every scanned file and builds the
:class:`~repro_torch.analysis.base.TreeIndex` (tracked-enum member lists,
set-typed attribute names, class/method tables — the cross-file facts
single-file rules need); pass 2 runs the per-file rules plus the
configured cross-file parity pairs. Suppressions from ``analysis.toml``
are applied last so the report can list what was suppressed (with its
reason) and which suppressions no longer match anything.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.base import Finding, Module, build_index
from repro_torch.analysis.callgraph import build_callgraph
from repro_torch.analysis.concurrency import check_concurrency
from repro_torch.analysis.config import AnalysisConfig, Suppression
from repro_torch.analysis.determinism import check_determinism
from repro_torch.analysis.discipline import check_discipline
from repro_torch.analysis.exhaustive import check_exhaustiveness
from repro_torch.analysis.parity import check_engine_surface, check_parity_pair
from repro_torch.analysis.taint import check_taint


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Tuple[Finding, Suppression]] = field(default_factory=list)
    unused_suppressions: List[Suppression] = field(default_factory=list)
    parse_errors: List[Finding] = field(default_factory=list)
    files_checked: int = 0
    elapsed_s: float = 0.0

    @property
    def clean(self) -> bool:
        return not self.findings and not self.parse_errors

    def all_findings(self) -> List[Finding]:
        return sorted(
            self.parse_errors + self.findings,
            key=lambda f: (f.path, f.line, f.col, f.rule),
        )

    def to_dict(self) -> Dict[str, object]:
        return {
            "version": 1,
            "clean": self.clean,
            "files_checked": self.files_checked,
            "elapsed_s": round(self.elapsed_s, 4),
            "findings": [f.to_dict() for f in self.all_findings()],
            "suppressed": [
                {**f.to_dict(), "reason": s.reason} for f, s in self.suppressed
            ],
            "unused_suppressions": [
                {"rule": s.rule, "path": s.path, "symbol": s.symbol, "reason": s.reason}
                for s in self.unused_suppressions
            ],
        }


def _collect_files(paths: List[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    # dedupe, stable order
    seen = set()
    out: List[Path] = []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(f)
    return out


def _relpath(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def run_analysis(paths: List[Path], cfg: AnalysisConfig) -> Report:
    t0 = time.perf_counter()
    report = Report()
    modules: List[Module] = []
    by_rel: Dict[str, Module] = {}
    for path in _collect_files(paths):
        rel = _relpath(path, cfg.root)
        try:
            mod = Module.parse(path, rel)
        except SyntaxError as e:
            report.parse_errors.append(
                Finding(
                    rule="RPL000",
                    path=rel,
                    line=e.lineno or 1,
                    col=e.offset or 0,
                    message=f"syntax error: {e.msg}",
                    symbol="syntax",
                )
            )
            continue
        modules.append(mod)
        by_rel[rel] = mod
    report.files_checked = len(modules)
    # canonical order: findings (and every index built from the modules)
    # must be invariant to the order paths were given on the command line
    modules.sort(key=lambda m: m.rel)

    index = build_index(modules, frozenset(cfg.tracked_enums))
    callgraph = build_callgraph(modules, index, cfg.lock_factories)

    raw: List[Finding] = []
    for mod in modules:
        raw.extend(check_determinism(mod, cfg, index))
        raw.extend(check_exhaustiveness(mod, cfg, index))
        raw.extend(check_engine_surface(mod, cfg, index))
        raw.extend(check_discipline(mod, cfg))

    # cross-file passes on the shared call graph
    raw.extend(check_concurrency(callgraph, cfg))
    raw.extend(check_taint(callgraph, cfg))

    # cross-file parity pairs: run when at least one endpoint is in the
    # scanned set; the other endpoint is parsed on demand so a partial
    # scan still compares against the real counterpart
    for pair in cfg.parity_pairs:
        (lp, _), (rp, _) = pair.endpoints()
        if lp not in by_rel and rp not in by_rel:
            continue
        left = by_rel.get(lp) or _load_endpoint(cfg.root / lp, lp)
        right = by_rel.get(rp) or _load_endpoint(cfg.root / rp, rp)
        raw.extend(check_parity_pair(pair, left, right))

    used: Set[Suppression] = set()
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.col, f.rule, f.symbol)):
        for s in cfg.suppressions:
            if s.matches(f):
                report.suppressed.append((f, s))
                used.add(s)
                break
        else:
            report.findings.append(f)
    report.unused_suppressions = [s for s in cfg.suppressions if s not in used]
    report.elapsed_s = time.perf_counter() - t0
    return report


def _load_endpoint(path: Path, rel: str) -> Optional[Module]:
    if not path.is_file():
        return None
    try:
        return Module.parse(path, rel)
    except SyntaxError:
        return None
