"""The port's linter (``repro_torch.analysis``) against the JAX package's
``repro.analysis`` on the CPU.

* Twins of ``tests/test_analysis.py`` run against ``repro_torch.analysis``:
  every rule's good/bad fixture pair, the per-rule detail checks,
  suppressions, determinism and path-order invariance, the CLI and its
  rule catalog.
* Same reports: on every fixture of all 14 rules, on the cross-file taint
  case and on all of ``src/`` under ``analysis.toml``, both packages give
  the same ``to_dict()`` (``elapsed_s`` aside), finding for finding.
* Same CLI: ``python -m repro.analysis`` and ``python -m
  repro_torch.analysis`` exit alike and print the same ``--json -`` report
  on the same argv; their error lines differ only in the program's name.
* The port's own tree is clean under ``analysis_torch.toml`` with every
  suppression used, and the port's builtin defaults are the reference's
  with ``src/repro/`` moved to ``src/repro_torch/``.
* ``chip_smoke.py``'s lint phase (``phase_lint``) on the CPU.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import chip_smoke  # noqa: E402
import repro.analysis as jax_an  # noqa: E402
import repro.analysis.config as jax_config  # noqa: E402
import repro_torch.analysis as port_an  # noqa: E402
import repro_torch.analysis.config as port_config  # noqa: E402
from repro_torch.analysis import RULES, load_config, run_analysis  # noqa: E402
from repro_torch.analysis.config import ConfigError  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
FIXTURE_CFG = FIXTURES / "analysis.toml"
PORT_CFG = REPO / "analysis_torch.toml"
PKGS = {"jax": jax_an, "port": port_an}

# rule -> (good fixture files, bad fixture files), relative to FIXTURES
PAIRED = {rule: ([f"{rule}/good.py"], [f"{rule}/bad.py"]) for rule in RULES}
PAIRED["RPL020"] = (
    ["RPL020/good_left.py", "RPL020/good_right.py"],
    ["RPL020/bad_left.py", "RPL020/bad_right.py"],
)


def _run(files, cfg_path=FIXTURE_CFG, pkg=port_an):
    return pkg.run_analysis([FIXTURES / f for f in files], pkg.load_config(cfg_path))


def _serialize(report):
    d = report.to_dict()
    d.pop("elapsed_s")
    return d


def _msgs(report):
    return "\n".join(f"{f.location()} {f.rule} {f.message}" for f in report.all_findings())


@functools.lru_cache(maxsize=None)
def _cli(args, module="repro_torch.analysis"):
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
    )


@pytest.fixture(scope="module")
def src_reports():
    """One pass of each package over all of ``src/`` under ``analysis.toml``."""
    return {
        name: _serialize(pkg.run_analysis([REPO / "src"], pkg.load_config(REPO / "analysis.toml")))
        for name, pkg in PKGS.items()
    }


# ----------------------------------------------------------------------
# fixtures: one passing and one failing per rule, both packages alike
# ----------------------------------------------------------------------


@pytest.mark.parametrize("rule", sorted(RULES))
def test_bad_fixture_trips_rule(rule):
    report = _run(PAIRED[rule][1])
    rules_hit = {f.rule for f in report.findings}
    assert rule in rules_hit, f"{rule} bad fixture produced {sorted(rules_hit)}:\n{_msgs(report)}"


@pytest.mark.parametrize("rule", sorted(RULES))
def test_good_fixture_is_clean(rule):
    report = _run(PAIRED[rule][0])
    assert report.clean, _msgs(report)


@pytest.mark.parametrize("side", [0, 1], ids=["good", "bad"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_fixture_report_equals_reference(rule, side):
    files = PAIRED[rule][side]
    port, ref = _run(files), _run(files, pkg=jax_an)
    as_tuples = lambda r: [  # noqa: E731
        (f.rule, f.path, f.line, f.col, f.message, f.symbol) for f in r.all_findings()]
    assert as_tuples(port) == as_tuples(ref)
    assert _serialize(port) == _serialize(ref)


def test_every_rule_has_fixture_pair():
    dirs = {p.name for p in FIXTURES.iterdir() if p.is_dir()}
    assert dirs == set(RULES)
    for rule, (good, bad) in PAIRED.items():
        for f in good + bad:
            assert (FIXTURES / f).is_file(), f"missing fixture {f} for {rule}"


def test_rule_catalog_equals_reference():
    assert RULES == jax_an.RULES
    assert list(RULES) == list(jax_an.RULES)


# ----------------------------------------------------------------------
# rule-specific shape checks
# ----------------------------------------------------------------------


def test_rpl010_flags_both_dispatch_shapes():
    report = _run(PAIRED["RPL010"][1])
    msgs = [f.message for f in report.findings if f.rule == "RPL010"]
    assert any("if/elif dispatch" in m for m in msgs)
    assert any("dict dispatch" in m for m in msgs)
    assert any("FAILED" in m for m in msgs)


def test_rpl011_reports_each_inconsistency():
    report = _run(PAIRED["RPL011"][1])
    msgs = " | ".join(f.message for f in report.findings if f.rule == "RPL011")
    assert "no successor set" in msgs
    assert "must be absorbing" in msgs
    assert "requeue edge" in msgs
    assert "unreachable" in msgs


def test_rpl020_names_the_forked_member():
    report = _run(PAIRED["RPL020"][1])
    forks = [f for f in report.findings if f.rule == "RPL020"]
    assert [f.symbol for f in forks] == ["EvKind.REJECT"]
    assert forks[0].path.endswith("bad_right.py")


def test_rpl030_flags_each_unwrapped_write():
    report = _run(PAIRED["RPL030"][1])
    lines = {f.line for f in report.findings if f.rule == "RPL030"}
    assert len(lines) == 3


def test_rpl031_flags_method_call_and_rebind():
    report = _run(PAIRED["RPL031"][1])
    symbols = sorted(f.symbol for f in report.findings if f.rule == "RPL031")
    assert symbols == ["_active", "_pending_cancel"]


def test_rpl040_cycle_is_interprocedural_and_names_both_locks():
    report = _run(PAIRED["RPL040"][1])
    cycles = [f for f in report.findings if f.rule == "RPL040"]
    assert len(cycles) == 1
    f = cycles[0]
    assert f.symbol == "Daemon._ctl_lock,Store._lock"
    assert "Store.transaction()" in f.message
    assert "deadlock" in f.message


def test_rpl041_flags_only_the_unguarded_minority():
    report = _run(PAIRED["RPL041"][1])
    hits = [f for f in report.findings if f.rule == "RPL041"]
    assert [f.symbol for f in hits] == ["Driver._inflight", "Driver._inflight"]
    kinds = sorted(f.message.split(" ", 1)[0] for f in hits)
    assert kinds == ["read", "write"]


def test_rpl042_names_each_blocking_shape():
    report = _run(PAIRED["RPL042"][1])
    symbols = sorted(f.symbol for f in report.findings if f.rule == "RPL042")
    assert symbols == ["join", "sendall", "sqlite:BEGIN", "sqlite:COMMIT", "time.sleep"]


def test_rpl005_taint_flows_through_helper():
    report = _run(PAIRED["RPL005"][1])
    hits = [f for f in report.findings if f.rule == "RPL005"]
    assert len(hits) == 2
    assert all(f.symbol == "time.time" for f in hits)
    assert any("ordering key" in f.message for f in hits)
    assert any("decision log" in f.message for f in hits)
    assert all("bad.py:8" in f.message for f in hits)


def test_rpl005_tracks_taint_across_files(tmp_path):
    cfg = tmp_path / "analysis.toml"
    cfg.write_text('[analysis]\ndecision_paths = ["."]\n')
    (tmp_path / "helpers.py").write_text(
        "import time\n\n\ndef stamp():\n    return time.time()\n"
    )
    (tmp_path / "sched.py").write_text(
        "from helpers import stamp\n"
        "\n"
        "\n"
        "def pick(jobs):\n"
        "    t = stamp()\n"
        "    return sorted(jobs, key=lambda j: t)[0]\n"
    )
    files = [tmp_path / "helpers.py", tmp_path / "sched.py"]
    report = run_analysis(files, load_config(cfg))
    rpl5 = [f for f in report.findings if f.rule == "RPL005"]
    assert len(rpl5) == 1
    assert rpl5[0].path == "sched.py"
    assert rpl5[0].symbol == "time.time"
    assert "helpers.py:5" in rpl5[0].message
    ref = jax_an.run_analysis(files, jax_an.load_config(cfg))
    assert _serialize(report) == _serialize(ref)


# ----------------------------------------------------------------------
# suppressions and config
# ----------------------------------------------------------------------


def test_suppression_requires_reason(tmp_path):
    cfg = tmp_path / "analysis.toml"
    cfg.write_text('[[suppress]]\nrule = "RPL001"\npath = "x.py"\nreason = "  "\n')
    with pytest.raises(ConfigError, match="reason"):
        load_config(cfg)


def test_suppression_matches_and_reports(tmp_path):
    cfg = tmp_path / "analysis.toml"
    cfg.write_text(
        "[analysis]\n"
        'decision_paths = ["."]\n'
        "[[suppress]]\n"
        'rule = "RPL001"\n'
        'path = "clock.py"\n'
        'symbol = "time.time"\n'
        'reason = "timestamp is record metadata"\n'
        "[[suppress]]\n"
        'rule = "RPL003"\n'
        'path = "never.py"\n'
        'reason = "stale entry"\n'
    )
    src = tmp_path / "clock.py"
    src.write_text("import time\n\nnow = time.time()\n")
    report = run_analysis([src], load_config(cfg))
    assert report.clean
    assert [s.reason for _, s in report.suppressed] == ["timestamp is record metadata"]
    assert [s.rule for s in report.unused_suppressions] == ["RPL003"]
    assert _serialize(report) == _serialize(jax_an.run_analysis([src], jax_an.load_config(cfg)))


def test_unknown_rule_in_suppression_is_config_error(tmp_path):
    cfg = tmp_path / "analysis.toml"
    cfg.write_text('[[suppress]]\nrule = "RPL999"\npath = "x"\nreason = "r"\n')
    with pytest.raises(ConfigError, match="RPL999"):
        load_config(cfg)


def _moved(value):
    """A reference config value with ``src/repro/`` moved to the port's tree."""
    if isinstance(value, str):
        return value.replace("src/repro/", "src/repro_torch/")
    if isinstance(value, tuple):
        return tuple(_moved(v) for v in value)
    if isinstance(value, jax_config.ParityPair):
        return port_config.ParityPair(value.enum, _moved(value.left), _moved(value.right))
    return value


def _fields(cfg):
    """Every setting of a config but its root and suppressions."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("root", "suppressions")}


def test_builtin_defaults_are_the_references_moved_to_the_port():
    port, ref = port_config.AnalysisConfig(), jax_config.AnalysisConfig()
    assert list(_fields(port)) == list(_fields(ref))
    assert _fields(port) == {k: _moved(v) for k, v in _fields(ref).items()}
    assert port.decision_paths[-1] == "src/repro_torch/ctl/"
    # the shipped port config is the builtin defaults plus its suppressions
    assert _fields(load_config(PORT_CFG)) == _fields(port)


def test_port_config_is_the_shipped_config_moved_to_the_port():
    port = load_config(PORT_CFG)
    ref = jax_an.load_config(REPO / "analysis.toml")
    assert port.root == ref.root == REPO
    assert _fields(port) == {k: _moved(v) for k, v in _fields(ref).items()}
    assert len(port.suppressions) == len(ref.suppressions) == 6
    for p, r in zip(port.suppressions, ref.suppressions):
        assert (p.rule, p.path, p.symbol, p.reason) == (r.rule, _moved(r.path), r.symbol, r.reason)


@pytest.mark.parametrize(
    "body, match",
    [('[[suppress]]\nrule = "RPL001"\npath = "x.py"\nreason = ""\n', "reason"),
     ('[[suppress]]\nrule = "RPL999"\npath = "x"\nreason = "r"\n', "RPL999"),
     ("[analysis]\ndecision_paths = 3\n", "list of strings"),
     ("[analysis\n", "analysis.toml")],
    ids=["empty_reason", "unknown_rule", "bad_type", "bad_toml"],
)
def test_config_error_text_equals_reference(tmp_path, body, match):
    cfg = tmp_path / "analysis.toml"
    cfg.write_text(body)
    errors = []
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match=match) as info:
            pkg.load_config(cfg)
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]


# ----------------------------------------------------------------------
# shipped trees + CLI
# ----------------------------------------------------------------------


def test_port_tree_is_clean_under_its_own_config():
    report = run_analysis([REPO / "src" / "repro_torch"], load_config(PORT_CFG))
    assert report.clean, _msgs(report)
    assert report.unused_suppressions == []
    assert report.files_checked >= 80
    assert len(report.suppressed) == 16
    # the analysis package itself is in the scan
    assert report.files_checked == len(list((REPO / "src" / "repro_torch").rglob("*.py")))


def test_full_src_report_equals_reference(src_reports):
    assert src_reports["port"]["clean"] is True
    assert src_reports["port"]["unused_suppressions"] == []
    assert src_reports["port"]["files_checked"] > 150
    assert json.dumps(src_reports["port"]) == json.dumps(src_reports["jax"])


def test_runner_deterministic_and_path_order_invariant():
    cfg = load_config(PORT_CFG)
    core = REPO / "src" / "repro_torch" / "core"
    ctl = REPO / "src" / "repro_torch" / "ctl"
    first = json.dumps(_serialize(run_analysis([core, ctl], cfg)), sort_keys=True)
    second = json.dumps(_serialize(run_analysis([core, ctl], cfg)), sort_keys=True)
    assert first == second
    reordered = json.dumps(_serialize(run_analysis([ctl, core], cfg)), sort_keys=True)
    assert first == reordered


CLI_CASES = {
    "clean": ("--config", "analysis_torch.toml", "src/repro_torch/ctl", "--json"),
    "bad_fixture": ("--config", str(FIXTURE_CFG), str(FIXTURES / "RPL003" / "bad.py"), "--json"),
    "missing_path": ("no/such/path.py", "--json"),
    "empty_reason": ("--config", "{tmp}/empty_reason.toml", "--json"),
    "unknown_rule": ("--config", "{tmp}/unknown_rule.toml", "--json"),
}
CLI_RCS = {"clean": 0, "bad_fixture": 1, "missing_path": 2, "empty_reason": 2, "unknown_rule": 2}


@pytest.fixture(scope="module")
def cfg_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_cfg")
    (d / "empty_reason.toml").write_text(
        '[[suppress]]\nrule = "RPL001"\npath = "x.py"\nreason = ""\n')
    (d / "unknown_rule.toml").write_text(
        '[[suppress]]\nrule = "RPL999"\npath = "x"\nreason = "r"\n')
    return d


def _report_json(stdout):
    if not stdout:
        return None
    d = json.loads(stdout)
    d.pop("elapsed_s")
    return d


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_agrees_with_reference(case, cfg_dir):
    args = tuple(a.format(tmp=cfg_dir) for a in CLI_CASES[case])
    port, ref = _cli(args), _cli(args, module="repro.analysis")
    assert port.returncode == ref.returncode == CLI_RCS[case], port.stdout + port.stderr
    assert _report_json(port.stdout) == _report_json(ref.stdout)
    assert port.stderr.startswith("repro_torch.analysis: ") or not port.stderr
    assert port.stderr.replace("repro_torch.analysis: ", "repro.analysis: ") == ref.stderr


def test_cli_exit_codes_and_json():
    clean = _cli(CLI_CASES["clean"])
    assert clean.returncode == 0, clean.stdout + clean.stderr
    payload = json.loads(clean.stdout)
    assert payload["clean"] is True
    assert payload["findings"] == []
    assert payload["files_checked"] == len(list((REPO / "src/repro_torch/ctl").glob("*.py")))
    assert payload["suppressed"] and all("reason" in s for s in payload["suppressed"])

    bad = _cli(CLI_CASES["bad_fixture"])
    assert bad.returncode == 1
    payload = json.loads(bad.stdout)
    assert payload["clean"] is False
    assert payload["findings"][0]["rule"] == "RPL003"

    usage = _cli(("no/such/path.py",))
    assert usage.returncode == 2
    assert usage.stderr.startswith("repro_torch.analysis: no such path")


def test_cli_format_github_emits_error_annotations():
    args = ("--config", str(FIXTURE_CFG), "--format", "github",
            str(FIXTURES / "RPL041" / "bad.py"))
    bad = _cli(args)
    assert bad.returncode == 1
    errors = [ln for ln in bad.stdout.splitlines() if ln.startswith("::error ")]
    assert errors, bad.stdout
    assert all("file=RPL041/bad.py" in ln and "line=" in ln for ln in errors)
    assert any("RPL041" in ln for ln in errors)
    ref = _cli(args, module="repro.analysis")
    assert errors == [ln for ln in ref.stdout.splitlines() if ln.startswith("::error ")]


def test_cli_json_file_alongside_github_format(tmp_path):
    out_file = tmp_path / "report.json"
    bad = _cli(("--config", str(FIXTURE_CFG), "--format", "github", "--json", str(out_file),
                str(FIXTURES / "RPL042" / "bad.py")))
    assert bad.returncode == 1
    assert "::error " in bad.stdout
    payload = json.loads(out_file.read_text())
    assert payload["clean"] is False
    assert {f["rule"] for f in payload["findings"]} == {"RPL042"}


def test_unused_suppressions_reach_json_and_github_output(tmp_path):
    cfg = tmp_path / "analysis.toml"
    cfg.write_text(
        "[analysis]\n"
        'decision_paths = ["."]\n'
        "[[suppress]]\n"
        'rule = "RPL003"\n'
        'path = "never.py"\n'
        'reason = "stale entry kept for the test"\n'
    )
    src = tmp_path / "ok.py"
    src.write_text("x = 1\n")
    out = _cli(("--config", str(cfg), str(src), "--json"))
    assert out.returncode == 0
    payload = json.loads(out.stdout)
    assert payload["unused_suppressions"] == [
        {
            "rule": "RPL003",
            "path": "never.py",
            "symbol": None,
            "reason": "stale entry kept for the test",
        }
    ]
    args = ("--config", str(cfg), str(src), "--format", "github")
    gh = _cli(args)
    assert gh.returncode == 0
    assert "::warning" in gh.stdout and "RPL003" in gh.stdout
    warnings = [ln for ln in gh.stdout.splitlines() if ln.startswith("::warning")]
    ref = _cli(args, module="repro.analysis")
    assert warnings == [ln for ln in ref.stdout.splitlines() if ln.startswith("::warning")]


@pytest.mark.parametrize("rule", sorted(RULES))
def test_cli_nonzero_on_each_bad_fixture(rule):
    bad = _cli(("--config", str(FIXTURE_CFG), *(str(FIXTURES / f) for f in PAIRED[rule][1])))
    assert bad.returncode == 1, bad.stdout + bad.stderr


def test_list_rules_covers_catalog():
    out = _cli(("--list-rules",))
    assert out.returncode == 0
    for rule in RULES:
        assert rule in out.stdout
    assert out.stdout == _cli(("--list-rules",), module="repro.analysis").stdout


def test_chip_smoke_lint_phase(monkeypatch):
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "no card")
    res = chip_smoke.phase_lint()
    assert res["findings"] == 0 and res["suppressed"] == 16
    assert res["files_checked"] == len(list((REPO / "src" / "repro_torch").rglob("*.py")))
    assert res["rules_held"] == sorted(RULES)
