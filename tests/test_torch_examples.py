"""The port's example twins (``examples/torch/``) on the CPU against the JAX
package's examples (``examples/``): ``train_lm``'s config field for field
and its loop saving and resuming bit for bit (at a smoke config: the 100M
model is the card's), ``quickstart``'s admitted/queued split, and
``inference_packing``'s packed services."""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

from repro_torch.configs import get_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(name: str, port: bool):
    path = ROOT / "examples" / ("torch" if port else "") / f"{name}.py"
    return _load(path, f"{'port' if port else 'jax'}_example_{name}")


def test_hundred_m_config_is_jaxs_field_for_field():
    port, jax_cfg = _example("train_lm", True).hundred_m_config(), \
        _example("train_lm", False).hundred_m_config()
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    assert port.param_count() == jax_cfg.param_count()


def test_train_lm_loop_saves_and_resumes_bit_for_bit(tmp_path, capsys):
    """``train_lm``'s loop at a smoke config: 2 steps and a save, then a
    second run to 3 steps resumes from step 2 and ends where an
    uninterrupted 3-step run ends, checkpoint bit for bit."""
    from repro_torch.ckpt.checkpoint import CheckpointManager

    mod = _example("train_lm", True)
    cfg = get_config("qwen3-8b").smoke()
    args = lambda steps, d: Namespace(steps=steps, batch=2, seq_len=16, ckpt_dir=str(tmp_path / d),
                                      device="cpu")
    mod.train(cfg, args(2, "b"))
    assert CheckpointManager(str(tmp_path / "b"), async_save=False).latest_step() == 2
    capsys.readouterr()
    loss_b = mod.train(cfg, args(3, "b"))
    assert "resumed from step 2" in capsys.readouterr().out
    loss_a = mod.train(cfg, args(3, "a"))
    assert loss_a == loss_b and np.isfinite(loss_a)
    got = [CheckpointManager(str(tmp_path / d), async_save=False).restore() for d in ("a", "b")]
    assert got[0][0] == got[1][0] == 3 and sorted(got[0][1]) == sorted(got[1][1])
    for key, arr in got[0][1].items():
        assert arr.tobytes() == got[1][1][key].tobytes(), key


def _split(out: str):
    m = re.search(r"lanes: (\d+), queued: (\d+)", out)
    return int(m.group(1)), int(m.group(2))


def test_quickstart_reaches_jaxs_admitted_and_queued_split(capsys):
    report = _example("quickstart", True).main(["--device", "cpu"])
    port_out = capsys.readouterr().out
    _example("quickstart", False).main()
    assert _split(port_out) == _split(capsys.readouterr().out) == (2, 1)
    assert sorted(s.iterations_done for s in report.stats.values()) == [5, 20, 20]
    assert not report.failures


def test_inference_packing_packs_as_many_services_as_jax(capsys):
    """Every service packed, as the JAX example packs them (run in a
    subprocess at one request a service: the packing is decided before
    any request), and every request served."""
    code = ("import sys; sys.path.insert(0, 'examples'); import inference_packing as ip; "
            "ip.REQUESTS = 1; ip.main()")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        mod = _example("inference_packing", True)
        res = mod.main(["--device", "cpu"])
        out = proc.communicate(timeout=300)[0]
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, out[-2000:]
    jax_packed = int(re.search(r"packed (\d+)/12", out).group(1))
    assert res["packed"] == jax_packed == len(mod.ARCHS) * mod.INSTANCES
    assert res["requests"] == res["services"] * mod.REQUESTS
    assert not res["report"].failures
    assert f"packed {jax_packed}/12 services" in capsys.readouterr().out
    assert mod.service_seed("gemma-2b", 0) == mod.service_seed("gemma-2b", 0) != \
        mod.service_seed("gemma-2b", 1)
