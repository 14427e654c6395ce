"""RPL01x — enum/state exhaustiveness.

RPL010  every dispatch site over a tracked enum (``JobState``,
        ``MemoryEventKind``, ``CtlState``, ``PlacementEventKind``) must
        either handle every member or carry an explicit default branch.
        Two dispatch shapes are recognised:

        * an ``if``/``elif`` chain (>= 2 branches) whose tests all
          compare the *same* subject against members of one enum
          (``x is E.A``, ``x == E.A``, ``x in (E.A, E.B)``, ``or``-ed
          comparisons). A bare ``else:`` is the explicit default.
        * a dict literal whose keys are all members of one enum (>= 2
          keys) — e.g. the ``_ENGINE_TO_CTL`` projection table. Dict
          dispatch has no default, so coverage must be total.

        Single-branch guards (``if st in TERMINAL: return``) are not
        dispatch and are ignored. References to members the enum does
        not define (typos) are flagged at the same sites.

RPL011  the ctl lifecycle table must be self-consistent: a module that
        defines both the lifecycle enum (``CtlState``) and a
        ``TRANSITIONS`` dict is checked for (a) a successor set for
        every member, (b) terminal states being absorbing, (c) the
        crash-recovery *requeue edge* back to the initial state from
        every non-terminal state (ROADMAP lifecycle diagram), (d) every
        state reachable from the initial state, and (e) the
        ``ctl_state_of`` projection (``_ENGINE_TO_CTL``) mapping onto
        valid members only. Enum member lists are read from the AST, so
        fixtures can model broken tables without importing anything.
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from repro_torch.analysis.base import Finding, Module, TreeIndex, enum_member
from repro_torch.analysis.config import AnalysisConfig


def check_exhaustiveness(
    mod: Module, cfg: AnalysisConfig, index: TreeIndex
) -> List[Finding]:
    findings = _check_dispatch_sites(mod, index)
    findings.extend(_check_lifecycle_table(mod, cfg))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


# ----------------------------------------------------------------------
# RPL010 — dispatch sites
# ----------------------------------------------------------------------


def _branch_members(
    test: ast.expr, enums: Dict[str, FrozenSet[str]]
) -> Optional[Tuple[str, str, Set[str]]]:
    """``(enum, subject_dump, members)`` for one recognisable branch test."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        acc: Optional[Tuple[str, str, Set[str]]] = None
        for value in test.values:
            part = _branch_members(value, enums)
            if part is None:
                return None
            if acc is None:
                acc = part
            elif part[0] != acc[0] or part[1] != acc[1]:
                return None
            else:
                acc[2].update(part[2])
        return acc
    if not isinstance(test, ast.Compare) or len(test.ops) != 1:
        return None
    op = test.ops[0]
    left, right = test.left, test.comparators[0]
    if isinstance(op, (ast.Is, ast.Eq)):
        for subject, member_side in ((left, right), (right, left)):
            hit = enum_member(member_side, enums)
            if hit is not None and enum_member(subject, enums) is None:
                return hit[0], ast.dump(subject), {hit[1]}
        return None
    if isinstance(op, ast.In) and isinstance(right, (ast.Tuple, ast.List, ast.Set)):
        enum_name: Optional[str] = None
        members: Set[str] = set()
        for elt in right.elts:
            hit = enum_member(elt, enums)
            if hit is None or (enum_name is not None and hit[0] != enum_name):
                return None
            enum_name = hit[0]
            members.add(hit[1])
        if enum_name is None:
            return None
        return enum_name, ast.dump(left), members
    return None


def _check_dispatch_sites(mod: Module, index: TreeIndex) -> List[Finding]:
    findings: List[Finding] = []
    if not index.enums:
        return findings
    elif_continuations: Set[int] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.If):
            if id(node) in elif_continuations:
                continue
            findings.extend(_check_if_chain(node, mod, index, elif_continuations))
        elif isinstance(node, ast.Dict):
            findings.extend(_check_dict_dispatch(node, mod, index))
    return findings


def _check_if_chain(
    node: ast.If, mod: Module, index: TreeIndex, seen: Set[int]
) -> List[Finding]:
    branches: List[Tuple[str, str, Set[str]]] = []
    cursor: ast.stmt = node
    has_default = False
    while isinstance(cursor, ast.If):
        info = _branch_members(cursor.test, index.enums)
        if info is None:
            return []  # not (only) an enum dispatch
        branches.append(info)
        orelse = cursor.orelse
        if len(orelse) == 1 and isinstance(orelse[0], ast.If):
            cursor = orelse[0]
            seen.add(id(cursor))
        else:
            has_default = bool(orelse)
            break
    if len(branches) < 2:
        return []
    enum_names = {b[0] for b in branches}
    subjects = {b[1] for b in branches}
    if len(enum_names) != 1 or len(subjects) != 1:
        return []  # mixed enums / mixed subjects: not a single dispatch
    enum_name = branches[0][0]
    all_members = index.enums[enum_name]
    covered: Set[str] = set()
    for b in branches:
        covered |= b[2]
    findings: List[Finding] = []
    unknown = covered - all_members
    for m in sorted(unknown):
        findings.append(
            Finding(
                rule="RPL010",
                path=mod.rel,
                line=node.lineno,
                col=node.col_offset,
                message=f"dispatch references {enum_name}.{m}, which {enum_name} does not define",
                symbol=f"{enum_name}.{m}",
            )
        )
    missing = all_members - covered
    if missing and not has_default:
        findings.append(
            Finding(
                rule="RPL010",
                path=mod.rel,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"if/elif dispatch over {enum_name} handles "
                    f"{len(covered & all_members)}/{len(all_members)} members and has no "
                    f"else; unhandled: {', '.join(sorted(missing))} — handle them or "
                    "add an explicit default branch"
                ),
                symbol=enum_name,
            )
        )
    return findings


def _check_dict_dispatch(node: ast.Dict, mod: Module, index: TreeIndex) -> List[Finding]:
    if len(node.keys) < 2:
        return []
    enum_name: Optional[str] = None
    covered: Set[str] = set()
    for key in node.keys:
        if key is None:  # **splat: membership unknowable
            return []
        hit = enum_member(key, index.enums)
        if hit is None or (enum_name is not None and hit[0] != enum_name):
            return []
        enum_name = hit[0]
        covered.add(hit[1])
    assert enum_name is not None
    all_members = index.enums[enum_name]
    findings: List[Finding] = []
    for m in sorted(covered - all_members):
        findings.append(
            Finding(
                rule="RPL010",
                path=mod.rel,
                line=node.lineno,
                col=node.col_offset,
                message=f"dict dispatch references {enum_name}.{m}, which {enum_name} does not define",
                symbol=f"{enum_name}.{m}",
            )
        )
    missing = all_members - covered
    if missing:
        findings.append(
            Finding(
                rule="RPL010",
                path=mod.rel,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"dict dispatch over {enum_name} is missing "
                    f"{', '.join(sorted(missing))}; dict dispatch has no default, "
                    "so coverage must be total"
                ),
                symbol=enum_name,
            )
        )
    return findings


# ----------------------------------------------------------------------
# RPL011 — lifecycle table consistency
# ----------------------------------------------------------------------


def _members_in(expr: ast.AST, enum_name: str) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(expr):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == enum_name
        ):
            out.add(node.attr)
    return out


def _check_lifecycle_table(mod: Module, cfg: AnalysisConfig) -> List[Finding]:
    enum_name = cfg.lifecycle_enum
    members: Optional[frozenset] = None
    transitions_node: Optional[ast.Dict] = None
    transitions_line = 1
    terminal: Optional[Set[str]] = None
    projection: Optional[ast.Dict] = None
    projection_line = 1

    from repro_torch.analysis.base import enum_members_of, is_enum_classdef

    for stmt in mod.tree.body:
        if isinstance(stmt, ast.ClassDef) and stmt.name == enum_name:
            if is_enum_classdef(stmt):
                members = enum_members_of(stmt)
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt = stmt.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            if tgt.id == "TRANSITIONS" and isinstance(stmt.value, ast.Dict):
                transitions_node = stmt.value
                transitions_line = stmt.lineno
            elif tgt.id == "TERMINAL":
                terminal = _members_in(stmt.value, enum_name)
            elif tgt.id == "_ENGINE_TO_CTL" and isinstance(stmt.value, ast.Dict):
                projection = stmt.value
                projection_line = stmt.lineno

    if members is None or transitions_node is None:
        return []

    def finding(line: int, message: str, symbol: str = "") -> Finding:
        return Finding(
            rule="RPL011",
            path=mod.rel,
            line=line,
            col=0,
            message=message,
            symbol=symbol or enum_name,
        )

    findings: List[Finding] = []
    table: Dict[str, Set[str]] = {}
    for key, value in zip(transitions_node.keys, transitions_node.values):
        hit = enum_member(key, {enum_name: members}) if key is not None else None
        if hit is None:
            findings.append(
                finding(
                    getattr(key, "lineno", transitions_line),
                    f"TRANSITIONS key is not a {enum_name} member reference",
                )
            )
            continue
        table[hit[1]] = _members_in(value, enum_name)

    for m in sorted(set(table) - set(members)):
        findings.append(
            finding(
                transitions_line,
                f"TRANSITIONS keys {enum_name}.{m}, which {enum_name} does not define",
                f"{enum_name}.{m}",
            )
        )
    missing_keys = set(members) - set(table)
    if missing_keys:
        findings.append(
            finding(
                transitions_line,
                f"TRANSITIONS has no successor set for: {', '.join(sorted(missing_keys))}",
            )
        )
    for src, dsts in sorted(table.items()):
        for dst in sorted(dsts - set(members)):
            findings.append(
                finding(
                    transitions_line,
                    f"TRANSITIONS[{src}] targets {enum_name}.{dst}, which "
                    f"{enum_name} does not define",
                    f"{enum_name}.{dst}",
                )
            )

    term = terminal if terminal is not None else {s for s, d in table.items() if not d}
    for t in sorted(term & set(table)):
        if table[t]:
            findings.append(
                finding(
                    transitions_line,
                    f"terminal state {t} has successors {sorted(table[t])}; "
                    "terminal states must be absorbing",
                    f"{enum_name}.{t}",
                )
            )

    initial = cfg.initial_state
    if initial in members:
        # (c) requeue edges: crash recovery must be able to send any
        # non-terminal, non-initial state back to the initial state
        for src in sorted(set(members) - term - {initial}):
            if initial not in table.get(src, set()):
                findings.append(
                    finding(
                        transitions_line,
                        f"non-terminal state {src} has no requeue edge back to "
                        f"{initial}; crash recovery cannot reclaim jobs stuck there",
                        f"{enum_name}.{src}",
                    )
                )
        # (d) reachability from the initial state
        reachable: Set[str] = set()
        frontier = [initial]
        while frontier:
            cur = frontier.pop()
            if cur in reachable:
                continue
            reachable.add(cur)
            frontier.extend(table.get(cur, set()))
        for m in sorted(set(members) - reachable):
            findings.append(
                finding(
                    transitions_line,
                    f"state {m} is unreachable from {initial} in TRANSITIONS",
                    f"{enum_name}.{m}",
                )
            )

    if projection is not None:
        for value in projection.values:
            for m in sorted(_members_in(value, enum_name) - set(members)):
                findings.append(
                    finding(
                        projection_line,
                        f"ctl_state_of projection targets {enum_name}.{m}, "
                        f"which {enum_name} does not define",
                        f"{enum_name}.{m}",
                    )
                )
    return findings
