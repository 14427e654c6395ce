#!/usr/bin/env python3
"""What the repository's lint costs, and where: the full-tree pass that
``tests/test_analysis.py::test_full_tree_pass_under_budget`` holds under
5 s, and the port's share of it.

    python3 scripts/lint_budget.py [--runs 5] [ROOT ...]

For each ROOT (default: this checkout; give several, e.g. an unpacked
parent commit beside this one, to interleave them) it runs
``repro.analysis.run_analysis`` over ``ROOT/src`` with ``ROOT``'s
``analysis.toml`` ``--runs`` times, round-robin across the roots, and
prints one JSON line a root: every ``elapsed_s``, their median, the files
checked and whether the tree is clean; ``calls``, the Python function
calls of one more pass under ``cProfile`` (the pass's work, which unlike
its time does not move with the box's load); ``gc_s`` and
``gc_full``, the seconds a full pass spent in the garbage collector and
its full (generation 2) collections, median over the runs; the functions of the call graph
under ``src/repro`` and under ``src/repro_torch``, and the port's
functions a directory, largest first. The cost a function is the median
over a run of ``src/repro`` alone (``--runs`` more runs) spread over the
port's functions; each directory's estimate is its count times that.
Times are wall seconds of this process, so run it idle, or beside the
tier-1 command to see the budget under load. To clock the budget test
inside the tier-1 command itself, load ``scripts/lint_clock.py`` as a
pytest plugin (its docstring says how).
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import json
import pstats
import statistics
import sys
import time
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


class GcClock:
    """Seconds spent in collections, and full collections, since reset."""

    def __init__(self) -> None:
        self.seconds, self.full, self._t0 = 0.0, 0, 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        self.seconds += time.perf_counter() - self._t0
        self.full += info["generation"] == 2

    def reset(self) -> None:
        self.seconds, self.full = 0.0, 0


def _analysis(root: Path):
    sys.path.insert(0, str(root / "src"))
    from repro.analysis import load_config, run_analysis
    from repro.analysis.base import Module, build_index
    from repro.analysis.callgraph import build_callgraph

    return load_config, run_analysis, Module, build_index, build_callgraph


def function_counts(root: Path, Module, build_index, build_callgraph, cfg) -> dict:
    mods = [Module.parse(p, str(p.relative_to(root))) for p in sorted((root / "src").rglob("*.py"))]
    cg = build_callgraph(mods, build_index(mods, frozenset(cfg.tracked_enums)))
    by_dir: Counter = Counter()
    pkgs: Counter = Counter()
    for f in cg.functions.values():
        parts = Path(f.rel).parts  # ("src", pkg, ...)
        pkgs[parts[1]] += 1
        if parts[1] == "repro_torch":
            by_dir["/".join(parts[1:-1]) or parts[1]] += 1
    return {"repro": pkgs["repro"], "repro_torch": pkgs["repro_torch"],
            "port_by_dir": dict(by_dir.most_common())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path, default=[HERE])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    load_config, run_analysis, Module, build_index, build_callgraph = _analysis(HERE)
    roots = [r.resolve() for r in args.roots]
    cfgs = {r: load_config(r / "analysis.toml") for r in roots}
    times = {r: [] for r in roots}
    jax_alone = {r: [] for r in roots}
    last = {}
    gcs = {r: [] for r in roots}
    clock = GcClock()
    for _ in range(args.runs):
        for r in roots:
            gc.collect()
            clock.reset()
            last[r] = run_analysis([r / "src"], cfgs[r])
            times[r].append(last[r].elapsed_s)
            gcs[r].append((clock.seconds, clock.full))
            jax_alone[r].append(run_analysis([r / "src" / "repro"], cfgs[r]).elapsed_s)
    for r in roots:
        prof = cProfile.Profile()
        prof.runcall(run_analysis, [r / "src"], cfgs[r])
        calls = pstats.Stats(prof).total_calls
        counts = function_counts(r, Module, build_index, build_callgraph, cfgs[r])
        full, alone = statistics.median(times[r]), statistics.median(jax_alone[r])
        per_fn = (full - alone) / max(counts["repro_torch"], 1)
        print(json.dumps({
            "root": str(r), "elapsed_s": times[r], "median_s": full,
            "repro_alone_elapsed_s": jax_alone[r], "repro_alone_median_s": alone,
            "files_checked": last[r].files_checked, "clean": last[r].clean, "calls": calls,
            "gc_s": statistics.median(g for g, _ in gcs[r]),
            "gc_full": statistics.median(n for _, n in gcs[r]),
            "functions": {"repro": counts["repro"], "repro_torch": counts["repro_torch"]},
            "port_s_a_function": per_fn,
            "port_by_dir": {d: {"functions": n, "est_s": n * per_fn}
                            for d, n in counts["port_by_dir"].items()},
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
