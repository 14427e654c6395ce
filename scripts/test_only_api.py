#!/usr/bin/env python3
"""The port's top-level functions that only the tests reach, and their
AST nodes: the room that moving test-only API out of ``src/`` would give
the budget lint (``scripts/lint_budget.py`` gives the calls a node).

    python3 scripts/test_only_api.py [ROOT]

A function of ``ROOT/src/repro_torch`` counts when its name is referenced
(a name, an attribute or an imported alias) in ``ROOT/tests`` and nowhere
in the port outside its own definition, ``chip_smoke.py`` or
``examples/torch``. Methods are not counted. Prints one line a function
and the totals.
"""
from __future__ import annotations

import ast
import sys
from collections import Counter
from pathlib import Path


def referenced(tree: ast.AST) -> Counter:
    names: Counter = Counter()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names[node.id] += 1
        elif isinstance(node, ast.Attribute):
            names[node.attr] += 1
        elif isinstance(node, ast.alias):
            names[node.name.split(".")[-1]] += 1
    return names


def main(root: Path) -> int:
    port = sorted((root / "src" / "repro_torch").rglob("*.py"))
    users = port + [root / "chip_smoke.py"] + sorted((root / "examples" / "torch").glob("*.py"))
    trees = {p: ast.parse(p.read_text(), filename=str(p)) for p in users}
    refs = {p: referenced(t) for p, t in trees.items()}
    in_tests: Counter = Counter()
    for p in sorted((root / "tests").glob("*.py")):
        in_tests.update(referenced(ast.parse(p.read_text(), filename=str(p))))
    total_nodes = 0
    found = 0
    for p in port:
        for fn in trees[p].body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # uses in its own file: every reference but those inside itself
            own = refs[p][fn.name] - referenced(fn)[fn.name]
            elsewhere = sum(c[fn.name] for q, c in refs.items() if q != p)
            if own == 0 and elsewhere == 0 and in_tests[fn.name]:
                nodes = sum(1 for _ in ast.walk(fn))
                total_nodes += nodes
                found += 1
                print(f"{p.relative_to(root)}::{fn.name} {nodes}")
    print(f"{found} functions, {total_nodes} AST nodes")
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])))
