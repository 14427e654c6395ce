"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no example twin in ``examples/torch`` imports ``jax``
or anything of the JAX package ``repro``, and importing every port module
and example twin leaves both out of ``sys.modules``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


EXAMPLES = ROOT / "examples" / "torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(EXAMPLES.glob("*.py"))


def _module_names():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


def test_importing_the_port_loads_no_jax():
    mods = _module_names()
    assert "repro_torch.launch.serve" in mods and len(mods) > 20
    assert {
        "repro_torch.models.rwkv",
        "repro_torch.kernels.rwkv_scan",
        "repro_torch.kernels.rwkv_scan.ops",
        "repro_torch.kernels.rwkv_scan.ref",
        "repro_torch.data.pipeline",
        "repro_torch.train.optimizer",
        "repro_torch.train.train_step",
        "repro_torch.train.runtime",
        "repro_torch.core.events",
        "repro_torch.core.simulator",
        "repro_torch.core.placement",
        "repro_torch.core.fleet",
        "repro_torch.core.cluster",
        "repro_torch.dist.fault",
        "repro_torch.ckpt.checkpoint",
        "repro_torch.train.grad_compress",
        "repro_torch.launch.mesh",
        "repro_torch.dist.api",
        "repro_torch.dist.sharding",
        "repro_torch.dist.elastic",
        "repro_torch.launch.train",
        "repro_torch.launch.dryrun",
        "repro_torch.launch.op_count",
        "repro_torch.launch.roofline",
    } <= set(mods)
    examples = [str(p) for p in sorted(EXAMPLES.glob("*.py"))]
    assert {Path(p).stem for p in examples} == {
        "train_lm", "quickstart", "hyperparam_tuning", "inference_packing"}
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"for p in {examples!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
