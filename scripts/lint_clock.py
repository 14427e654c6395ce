"""A pytest plugin that clocks every full-tree lint a test runs: each call
of ``repro.analysis.run_analysis`` over a ``src`` directory appends one
JSON line (wall time, test id, ``elapsed_s``, files checked) to the file
named by ``LINTCLOCK_OUT``. It shows what
``tests/test_analysis.py::test_full_tree_pass_under_budget`` measured in a
run where it passed, e.g. under the tier-1 command:

    LINTCLOCK_OUT=lint.jsonl PYTHONPATH=src:scripts python -m pytest -p lint_clock \
        -p xdist -n 6 --dist loadfile -q

The wrapper only observes: it returns the report unchanged.
"""
from __future__ import annotations

import json
import os
import time

_current = {"test": None}


def pytest_runtest_setup(item):
    _current["test"] = item.nodeid


def pytest_configure(config):
    try:
        import repro.analysis as analysis
        import repro.analysis.runner as runner
    except ImportError:
        return
    run = runner.run_analysis

    def clocked(paths, cfg):
        report = run(paths, cfg)
        if any(str(p).rstrip("/").endswith("src") for p in paths):
            with open(os.environ["LINTCLOCK_OUT"], "a") as f:
                f.write(json.dumps({"t": time.time(), "test": _current["test"],
                                    "elapsed_s": report.elapsed_s,
                                    "files": report.files_checked}) + "\n")
        return report

    runner.run_analysis = clocked
    analysis.run_analysis = clocked
