"""CLI driver: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 clean, 1 findings, 2 config/usage error. With no
``--config``, an ``analysis.toml`` in the current directory (the repo
root in CI) is used; otherwise builtin defaults, which mirror the
shipped config minus its suppressions.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.base import RULES
from repro_torch.analysis.config import ConfigError, load_config
from repro_torch.analysis.runner import run_analysis


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint: determinism / lifecycle / engine-parity static analysis",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=None,
        help="files or directories to scan (default: src/)",
    )
    parser.add_argument(
        "--config",
        type=Path,
        default=None,
        help="analysis.toml to use (default: ./analysis.toml if present)",
    )
    parser.add_argument(
        "--json",
        nargs="?",
        const="-",
        default=None,
        metavar="FILE",
        help="emit the full report as JSON: to stdout with no FILE (then "
        "--format is ignored), or to FILE alongside the chosen format",
    )
    parser.add_argument(
        "--format",
        choices=("text", "github"),
        default="text",
        help="finding output format: human-readable text (default), or "
        "GitHub workflow commands (::error/::warning annotations)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog and exit"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    config_path = args.config
    if config_path is None:
        default = Path("analysis.toml")
        config_path = default if default.is_file() else None
    try:
        cfg = load_config(config_path)
    except ConfigError as e:
        print(f"repro_torch.analysis: config error: {e}", file=sys.stderr)
        return 2

    paths = [Path(p) for p in (args.paths or ["src"])]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(
            f"repro_torch.analysis: no such path: {', '.join(map(str, missing))}",
            file=sys.stderr,
        )
        return 2

    report = run_analysis(paths, cfg)

    if args.json == "-":
        json.dump(report.to_dict(), sys.stdout, indent=2)
        print()
        return 0 if report.clean else 1
    if args.json is not None:
        Path(args.json).write_text(
            json.dumps(report.to_dict(), indent=2) + "\n", encoding="utf-8"
        )

    if args.format == "github":
        for f in report.all_findings():
            print(
                f"::error file={f.path},line={f.line},col={f.col},"
                f"title=repro-lint {f.rule}::{_gh_escape(f'{f.rule} {f.message}')}"
            )
        for s in report.unused_suppressions:
            detail = f"unused suppression {s.rule} path={s.path!r}" + (
                f" symbol={s.symbol!r}" if s.symbol else ""
            )
            print(f"::warning title=repro-lint::{_gh_escape(detail)}")
    else:
        for f in report.all_findings():
            print(f"{f.location()}: {f.rule} {f.message}")
        for s in report.unused_suppressions:
            print(
                f"warning: unused suppression {s.rule} path={s.path!r}"
                + (f" symbol={s.symbol!r}" if s.symbol else ""),
                file=sys.stderr,
            )
    n = len(report.all_findings())
    print(
        f"repro_torch.analysis: {report.files_checked} files, "
        f"{n} finding{'s' if n != 1 else ''}, "
        f"{len(report.suppressed)} suppressed, "
        f"{report.elapsed_s:.2f}s"
    )
    return 0 if report.clean else 1


def _gh_escape(message: str) -> str:
    """Escape a workflow-command message (the data after ``::``)."""
    return message.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")


if __name__ == "__main__":
    sys.exit(main())
