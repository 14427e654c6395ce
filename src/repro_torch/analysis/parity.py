"""RPL02x — engine-parity conformance.

The differential suite asserts at *runtime* that the simulator and the
live executor produce identical decision logs. The cheap static half of
that contract: both engines of a pair must reference the same set of
event-kind members — an event the simulator handles or emits with no
matching site in the executor (or vice versa) is a parity fork waiting
for a trace to expose it. Pairs are configured in ``analysis.toml``
(``[[analysis.parity]]``): Simulator↔SalusExecutor over
``MemoryEventKind`` and Cluster↔ClusterExecutor over
``PlacementEventKind``. Intentional asymmetries (e.g. pending-job
re-placement, which has no live counterpart) are suppressed with a
reason.

RPL021 checks the Engine protocol surface itself: every class configured
as an engine implementation must define ``submit``/``run``/``result``/
``decision_log`` (directly or via a base class resolvable by name), so a
protocol change cannot silently leave one backend behind the
``runtime_checkable`` isinstance gate.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.base import Finding, Module, TreeIndex, iter_enum_refs
from repro_torch.analysis.config import AnalysisConfig, ParityPair


def _find_class(mod: Module, name: str) -> Optional[ast.ClassDef]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _endpoint_refs(
    mod: Module, cls: Optional[str], enum: str
) -> Optional[Dict[str, int]]:
    """``member -> first line`` of every ``enum.member`` reference in the
    endpoint scope, or None when the scoping class is missing."""
    scope: ast.AST = mod.tree
    if cls is not None:
        found = _find_class(mod, cls)
        if found is None:
            return None
        scope = found
    refs: Dict[str, int] = {}
    for member, node in iter_enum_refs(scope, enum):
        refs.setdefault(member, node.lineno)
    return refs


def check_parity_pair(
    pair: ParityPair, left_mod: Optional[Module], right_mod: Optional[Module]
) -> List[Finding]:
    (left_path, left_cls), (right_path, right_cls) = pair.endpoints()
    findings: List[Finding] = []
    for path, mod, cls in ((left_path, left_mod, left_cls), (right_path, right_mod, right_cls)):
        if mod is None:
            findings.append(
                Finding(
                    rule="RPL020",
                    path=path,
                    line=1,
                    col=0,
                    message=f"parity endpoint {path} does not exist or failed to parse",
                    symbol=pair.enum,
                )
            )
        elif cls is not None and _find_class(mod, cls) is None:
            findings.append(
                Finding(
                    rule="RPL020",
                    path=mod.rel,
                    line=1,
                    col=0,
                    message=f"parity endpoint class {cls} not found in {mod.rel}",
                    symbol=pair.enum,
                )
            )
    if findings:
        return findings
    assert left_mod is not None and right_mod is not None
    left_refs = _endpoint_refs(left_mod, left_cls, pair.enum) or {}
    right_refs = _endpoint_refs(right_mod, right_cls, pair.enum) or {}

    def describe(cls: Optional[str], mod: Module) -> str:
        return f"{mod.rel}::{cls}" if cls else mod.rel

    left_name = describe(left_cls, left_mod)
    right_name = describe(right_cls, right_mod)
    for member in sorted(set(left_refs) - set(right_refs)):
        findings.append(
            Finding(
                rule="RPL020",
                path=right_mod.rel,
                line=1,
                col=0,
                message=(
                    f"{pair.enum}.{member} is referenced by {left_name} "
                    f"(line {left_refs[member]}) but has no matching site in "
                    f"{right_name}: engine parity fork"
                ),
                symbol=f"{pair.enum}.{member}",
            )
        )
    for member in sorted(set(right_refs) - set(left_refs)):
        findings.append(
            Finding(
                rule="RPL020",
                path=left_mod.rel,
                line=1,
                col=0,
                message=(
                    f"{pair.enum}.{member} is referenced by {right_name} "
                    f"(line {right_refs[member]}) but has no matching site in "
                    f"{left_name}: engine parity fork"
                ),
                symbol=f"{pair.enum}.{member}",
            )
        )
    return findings


def check_engine_surface(
    mod: Module, cfg: AnalysisConfig, index: TreeIndex
) -> List[Finding]:
    """RPL021 — configured engine classes expose the full protocol."""
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef) or node.name not in cfg.engine_classes:
            continue
        methods = index.class_methods(node.name)
        missing = [m for m in cfg.engine_methods if m not in methods]
        for m in missing:
            findings.append(
                Finding(
                    rule="RPL021",
                    path=mod.rel,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"Engine implementation {node.name} does not define "
                        f"{m}() (directly or via a resolvable base class); the "
                        "Engine protocol requires the full surface "
                        f"({', '.join(cfg.engine_methods)})"
                    ),
                    symbol=f"{node.name}.{m}",
                )
            )
    return findings
