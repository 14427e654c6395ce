"""The port's training CLI (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``), and the MoE layer on a data mesh
against JAX's sharded step.

One JAX subprocess with four forced host devices (``tests/jax_mesh_runs.py``)
and one launch of four gloo ranks (``tests/torch_ranks.py train``), shared
by the module, run side by side:
  * the sharded step on a (2, 2) ``data, model`` mesh, fp32, two
    microbatches of a 4 x 16 batch, MoE groups of ``batch * seq`` tokens
    (the CLI's ``moe_group``), so each group spans both data ranks: the
    port's gloo step against JAX's GSPMD step (loss, the aux loss of each
    microbatch, grad norm, params, AdamW ``m`` and ``v``), for
    mixtral-8x22b smoke and the dense control qwen3-8b smoke;
  * both CLIs at ``--mesh 2,2`` from copies of one step-0 checkpoint of
    JAX's ``Model.init(PRNGKey(0))``, 3 steps of 8 x 16, fp32 compute: the
    final checkpoints agree within tests/test_torch_train.py's tolerances.
Then, in this process on a one-rank group: the verify recipe's run at
``--mesh 1,1`` resuming bit for bit after an injected failure, the
restart budget, the CLI's flags and model options against JAX's, rwkv on
the card, and twins of tests/test_train.py's ``TestTrainStep`` through
the CLI's step."""
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import torch_ranks  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.models import ModelOptions as JaxModelOptions  # noqa: E402
from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.ckpt.checkpoint import _sorted  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
C2_ARCHS = ["mixtral-8x22b", "qwen3-8b"]
BATCH, SEQ = 4, 16
# the CLI's moe_group (min(4096, batch * seq)): with two microbatches a
# group is a global microbatch's 32 tokens, 16 on each data rank
C2_OPTS = {**torch_ranks.MODEL_OPTS, "moe_group": BATCH * SEQ}
TIMEOUT = 300
# tests/test_torch_train.py's WARMUP lr at its first step (3e-4 / 200):
# Adam moves each element by about lr * sign(g) a step, so an element
# whose gradient is within rounding of 0 may flip by 2 lr; over 3 steps at
# this lr that stays inside the params' atol
CLI_LR = 1.5e-6
CLI_ARCHS = ["qwen3-8b", "mixtral-8x22b"]
CLI_STEPS = 3


def _cli_argv(arch, directory, lr):
    return ["--arch", arch, "--smoke", "--steps", str(CLI_STEPS), "--batch", "8", "--seq-len", "16",
            "--mesh", "2,2", "--ckpt-dir", str(directory), "--log-every", "1", "--lr", str(lr)]


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _seed_checkpoint(arch, directory):
    """A step-0 checkpoint of JAX's ``Model.init(PRNGKey(0))`` and
    ``AdamW.init``, written by JAX's manager."""
    params = _jax_params(arch)
    JaxCheckpointManager(str(directory), async_save=False).save(
        0, {"params": params, "opt": JaxAdamW().init(params)})


def _batch(arch, seed):
    rng = np.random.default_rng(seed)
    vocab = get_config(arch).smoke().vocab_size
    return {k: rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32) for k in ("tokens", "labels")}


def _jax_params(arch):
    return jax_build_model(jax_get_config(arch).smoke(), JaxModelOptions()).init(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return launch_runs(tmp_path_factory.mktemp("launch_train"))


def launch_runs(workdir: Path):
    """The JAX subprocess and the gloo launch, side by side, in
    ``workdir``: (JAX's result, rank 0's result, ``workdir``)."""
    import pickle

    batches = {arch: _batch(arch, 3) for arch in C2_ARCHS}
    jax_in = {"steps": {arch: {"opts": C2_OPTS, "adamw": torch_ranks.WARMUP,
                               "microbatches": torch_ranks.MICROBATCHES, "batch": batches[arch]}
                        for arch in C2_ARCHS}}
    cli = {}
    for arch in CLI_ARCHS:
        seed = workdir / "seed" / arch
        _seed_checkpoint(arch, seed)
        for side in ("jax", "port"):
            shutil.copytree(seed, workdir / side / arch)
        cli[arch] = {"argv": _cli_argv(arch, workdir / "jax" / arch, CLI_LR), "fp32": True}
    jax_in["cli"] = cli
    (workdir / "jax_inputs.pkl").write_bytes(pickle.dumps(jax_in))
    steps = {arch: {"arch": arch, "opts": C2_OPTS,
                    "params": from_jax(jax.tree_util.tree_map(np.asarray, _jax_params(arch)), CPU),
                    "batch": {k: torch.from_numpy(v) for k, v in batches[arch].items()}}
             for arch in C2_ARCHS}
    port_cli = {arch: {"argv": _cli_argv(arch, workdir / "port" / arch, CLI_LR) + ["--device", "cpu"],
                       "fp32": True, "port": _free_port()} for arch in CLI_ARCHS}
    torch.save({"steps": steps, "cli": port_cli}, workdir / "inputs.pt")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "jax_mesh_runs.py"), str(workdir)],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        port = torch_ranks.launch("train", 4, workdir, TIMEOUT)
        log = proc.communicate(timeout=TIMEOUT)[0]
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, log[-3000:]
    return pickle.loads((workdir / "jax_out.pkl").read_bytes()), port, workdir


def _close(a, b, rtol, atol, what):
    flat = pytree.tree_flatten_with_path(a)[0]
    assert len(flat) == len(pytree.tree_leaves(b)), what
    for (path, x), y in zip(flat, pytree.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x, np.float32), y.float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {pytree.keystr(path)}")


@pytest.mark.parametrize("arch", C2_ARCHS)
def test_sharded_step_equals_jax_sharded_step(runs, arch):
    """On a (2, 2) mesh with each MoE group spanning both data ranks, the
    port's step equals JAX's GSPMD step within tests/test_torch_train.py's
    tolerances: the groups, capacities, drops and aux loss are the global
    microbatch's (``moe_apply`` on a data mesh), and so the loss, grad
    norm, params and AdamW moments."""
    jx, port = runs[0]["steps"][arch], runs[1]["steps"][arch]
    for rank_aux in port["aux"]:  # every rank holds the global aux loss
        np.testing.assert_allclose(rank_aux, jx["aux"], rtol=1e-5, atol=1e-7)
    assert port["loss"] == pytest.approx(jx["loss"], rel=1e-5)
    assert port["grad_norm"] == pytest.approx(jx["grad_norm"], rel=1e-5)
    tree = _sorted(port["tree"])
    _close(_sorted(jx["params"]), tree["params"], 1e-4, 1e-5, "params")
    _close(_sorted(jx["m"]), tree["opt"]["m"], 1e-4, 1e-7, "m")
    _close(_sorted(jx["v"]), tree["opt"]["v"], 1e-4, 1e-9, "v")


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_cli_on_a_2x2_mesh_ends_at_jax_cli_checkpoint(runs, arch):
    """Both CLIs at ``--mesh 2,2``, each resuming from a copy of one step-0
    checkpoint of JAX's init, 3 steps of 8 x 16 in fp32 compute (mixtral's
    MoE groups span both data ranks): every leaf of the final checkpoint
    within tests/test_torch_train.py's tolerances, and the same lines
    printed."""
    from repro_torch.ckpt.checkpoint import CheckpointManager

    jax_log, port_log, workdir = runs[0]["cli"][arch], runs[1]["cli"][arch], runs[2]
    for log in (jax_log, port_log):
        assert "[train] resumed from checkpoint step 0" in log, log
        assert f"[train] done: {CLI_STEPS} steps" in log, log
    jl = [line.split()[:4] for line in jax_log.splitlines() if line.startswith("step")]
    pl = [line.split()[:4] for line in port_log.splitlines() if line.startswith("step")]
    assert len(jl) == len(pl) == CLI_STEPS
    for a, b in zip(jl, pl):
        assert a[:2] == b[:2] and float(b[3]) == pytest.approx(float(a[3]), rel=1e-4), (a, b)
    got = {side: CheckpointManager(str(workdir / side / arch), async_save=False).restore()
           for side in ("jax", "port")}
    assert got["jax"][0] == got["port"][0] == CLI_STEPS
    jx, pt = got["jax"][1], got["port"][1]
    assert sorted(jx) == sorted(pt)
    for key in jx:
        a, b = np.asarray(jx[key]), np.asarray(pt[key])
        if key == "opt/step":  # JAX's int32 counter, the port's int64
            assert a == b == CLI_STEPS
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, key
        rtol, atol = {"opt/m": (1e-4, 1e-7), "opt/v": (1e-4, 1e-9)}.get(key[:5], (1e-4, 1e-5))
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=key)


# --- in this process, on a one-rank group -----------------------------------

VERIFY = ["--device", "cpu", "--arch", "qwen3-8b", "--smoke", "--steps", "8", "--mesh", "1,1",
          "--batch", "8", "--seq-len", "16", "--ckpt-every", "2", "--log-every", "2"]


def _cli_main(argv, capsys):
    from repro_torch.launch.train import main

    record = main(argv)
    return record, capsys.readouterr().out


def test_verify_run_resumes_bit_for_bit(tmp_path, capsys):
    """The verify recipe's run at ``--mesh 1,1``: killed at step 5 and
    resumed from the step-4 checkpoint (the live state as the template),
    it prints the resume and one restart, and its final checkpoint equals
    an uninterrupted run's bit for bit, as do its losses from the resume
    on. A fresh call with ``--steps 10`` on that directory resumes from
    step 8 through a meta template and writes step 10."""
    from repro_torch.ckpt.checkpoint import CheckpointManager

    a, out_a = _cli_main(VERIFY + ["--ckpt-dir", str(tmp_path / "a")], capsys)
    b, out_b = _cli_main(VERIFY + ["--ckpt-dir", str(tmp_path / "b"), "--inject-failure", "5"],
                         capsys)
    assert "resumed" not in out_a and a["restarts"] == 0
    assert "[train] resumed from checkpoint step 4" in out_b
    assert "[train] completed after 1 restart(s)" in out_b
    assert "[train] done: 8 steps; stragglers flagged:" in out_b
    assert b["resumed"] == [4] and b["restarts"] == 1 and b["losses"] == a["losses"]
    steps = {k: CheckpointManager(str(tmp_path / k), async_save=False).restore()
             for k in ("a", "b")}
    assert steps["a"][0] == steps["b"][0] == 8
    for key, arr in steps["a"][1].items():
        other = steps["b"][1][key]
        assert arr.dtype == other.dtype and arr.tobytes() == other.tobytes(), key
    c, out_c = _cli_main([*VERIFY[:6], "10", *VERIFY[7:], "--ckpt-dir", str(tmp_path / "b")],
                         capsys)
    assert "[train] resumed from checkpoint step 8" in out_c and c["resumed"] == [8]
    assert sorted(c["losses"]) == [8, 9]
    assert CheckpointManager(str(tmp_path / "b"), async_save=False).latest_step() == 10


def test_four_failures_exhaust_the_restart_budget(capsys):
    argv = VERIFY[:6] + ["4"] + VERIFY[7:]
    for step in (0, 1, 2, 3):
        argv += ["--inject-failure", str(step)]
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        _cli_main(argv, capsys)


class _Stop(Exception):
    pass


def _capture(monkeypatch, module, name):
    """Record the arguments of the first call of ``module.name``, then
    stop its caller."""
    got = {}

    def grab(*args, **kwargs):
        got.update(args=args, kwargs=kwargs)
        raise _Stop

    monkeypatch.setattr(module, name, grab)
    return got


@pytest.mark.parametrize("argv", [[], ["--batch", "64", "--seq-len", "128", "--steps", "7"],
                                  ["--batch", "2", "--seq-len", "4096", "--lr", "0.5"]])
def test_flags_model_options_and_adamw_are_jax_clis(monkeypatch, argv):
    """Every JAX flag with its default and type, plus ``--device``; the
    model options JAX's CLI sets, the port's defaults (kernels, bf16
    compute, remat) otherwise; JAX's AdamW config and microbatching."""
    import argparse

    import repro.launch.train as jax_cli
    import repro_torch.launch.train as cli

    parsers = []
    parse = argparse.ArgumentParser.parse_args

    def keep(self, *a, **k):
        parsers.append(self)
        return parse(self, *a, **k)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", keep)
    jgot = _capture(monkeypatch, jax_cli, "make_train_step")
    with pytest.raises(_Stop):
        jax_cli.main(["--arch", "qwen3-8b", "--smoke", *argv])
    pgot = _capture(monkeypatch, cli, "make_step")
    with pytest.raises(_Stop):
        cli.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu", *argv])

    def flags(ap):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, type(a).__name__)
                for a in ap._actions if a.dest != "help"}

    jflags, pflags = flags(parsers[0]), flags(parsers[1])
    assert pflags.pop("device") == (("--device",), "cuda", None, "_StoreAction")
    assert pflags == jflags
    jmodel, jopt, jrun = jgot["args"]
    pmodel, popt, micro = pgot["args"][:3]
    for field in ("loss_chunk", "moe_group", "wkv_chunk", "ssm_chunk", "compute_dtype", "remat",
                  "param_dtype", "aux_coeff"):
        assert getattr(pmodel.opts, field) == getattr(jmodel.opts, field), field
    assert pmodel.opts.kernel_mode == "kernel"
    assert vars(popt.cfg) == vars(jopt.cfg)
    assert micro == jrun.num_microbatches


def test_no_cuda_raises_and_rwkv_on_the_card_raises(monkeypatch):
    """Without ``--device cpu`` and no card the CLI raises; an rwkv arch
    on the card raises NotImplementedError before anything is built."""
    import repro_torch.launch.train as cli

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--arch", "qwen3-8b", "--smoke"])
    monkeypatch.setattr(cli, "pick_device", lambda name: torch.device(name))
    with pytest.raises(NotImplementedError, match="WKV6"):
        cli.main(["--arch", "rwkv6-7b", "--smoke"])


# twins of tests/test_train.py::TestTrainStep through the CLI's step


def _step_state(arch, seed=0):
    from repro_torch.models import ModelOptions, build_model

    model = build_model(get_config(arch).smoke(), ModelOptions(loss_chunk=8,
                                                               compute_dtype="float32"))
    return model, model.init(torch.Generator().manual_seed(seed))


def _tiny_batch(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))) for k in ("tokens", "labels")}


class TestTrainStepThroughTheCli:
    def test_microbatch_equivalence(self):
        from repro_torch.launch.train import make_step
        from repro_torch.train.optimizer import AdamW, AdamWConfig

        model, params = _step_state("gemma-2b")
        opt = AdamW(AdamWConfig(grad_clip=0.0))
        batch = _tiny_batch(model.cfg, 4, 16)
        out = []
        for n in (1, 4):
            p = pytree.tree_map(torch.clone, params)
            state = {"params": p, "opt": opt.init(p)}
            out.append((make_step(model, opt, n, state)(batch), state["params"]))
        (m1, p1), (m4, p4) = out
        assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
        for a, b in zip(pytree.tree_leaves(p1), pytree.tree_leaves(p4)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)

    def test_loss_decreases_on_learnable_data(self):
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.launch.train import make_step
        from repro_torch.train.optimizer import AdamW, AdamWConfig

        model, params = _step_state("qwen3-8b")
        opt = AdamW(AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100))
        state = {"params": params, "opt": opt.init(params)}
        step = make_step(model, opt, 1, state)
        pipe = SyntheticLM(model.cfg.vocab_size, 32, 8, seed=1)
        losses = [float(step({k: torch.from_numpy(v) for k, v in pipe.batch(i).items()})["loss"])
                  for i in range(25)]
        assert losses[-1] < losses[0] - 0.5

    def test_grad_transform_hook_applied(self):
        """The CLI's hook is ``--compress-grads``' compressor: one that
        zeroes the gradients zeroes the norm AdamW sees, and its residual
        tree is the one it was given, updated leaf by leaf."""
        from repro_torch.launch.train import make_step
        from repro_torch.train.optimizer import AdamW, AdamWConfig

        class Zero:
            def apply(self, g, r):
                return torch.zeros_like(g), r + 1

        model, params = _step_state("gemma-2b")
        opt = AdamW(AdamWConfig(grad_clip=0.0))
        resid = pytree.tree_map(lambda p: torch.zeros(p.shape), params)
        state = {"params": params, "opt": opt.init(params), "resid": resid}
        m = make_step(model, opt, 1, state, Zero())(_tiny_batch(model.cfg, 2, 16))
        assert float(m["grad_norm"]) == 0.0
        assert state["resid"] is resid
        assert all(bool((r == 1).all()) for r in pytree.tree_leaves(resid))


def test_compressed_step_equals_compress_then_adamw():
    """``--compress-grads``' step (the whole batch's gradient, the
    compressor leaf by leaf in place, AdamW) equals the JAX CLI's sequence
    done by hand on the port: ``value_and_grad``, one ``apply`` over the
    trees, ``AdamW.update``; bit for bit, residuals too."""
    from repro_torch.launch.train import make_step
    from repro_torch.train.grad_compress import ErrorFeedbackCompressor
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import stack_grads, value_and_grad

    model, params = _step_state("qwen3-8b")
    opt, comp = AdamW(), ErrorFeedbackCompressor(block=64)
    batch = _tiny_batch(model.cfg, 2, 16)
    ref = pytree.tree_map(torch.clone, params)
    ref_state, ref_resid = opt.init(ref), comp.init(ref)
    state = {"params": params, "opt": opt.init(params), "resid": comp.init(params)}
    step = make_step(model, opt, 4, state, comp)  # microbatches are the JAX path's: ignored
    for _ in range(2):
        metrics = step(batch)
        loss, grads = value_and_grad(model, ref, batch)
        grads, ref_resid = comp.apply(stack_grads(grads), ref_resid)
        _, _, ref_metrics = opt.update(grads, ref_state, ref)
        assert torch.equal(metrics["loss"], loss)
        assert torch.equal(metrics["grad_norm"], ref_metrics["grad_norm"])
    for a, b in zip(pytree.tree_leaves([state["params"], state["opt"], state["resid"]]),
                    pytree.tree_leaves([ref, ref_state, ref_resid])):
        assert torch.equal(a, b)
