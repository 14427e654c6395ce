"""Ranks of a gloo process group on localhost, for the port's multi-rank
CPU tests (``tests/test_torch_dist.py``): ``launch`` starts one process a
rank running this file, each with one torch thread at the lowest
scheduling priority, a ``FileStore`` in the test's directory, and a
timeout; every rank makes the same collective calls (a gather on one rank
alone would hang the group).

    python tests/torch_ranks.py <case> <rank> <world> <workdir>

Cases (inputs from ``<workdir>/inputs.pt``, rank 0's result to
``<workdir>/<case>.pt``):
  * ``step``: on a (2, 2) ``data, model`` mesh, each run of ``inputs["runs"]``
    places its params, AdamW state and batch by the sharding rules and takes
    one train step (two microbatches); the result is each run's loss,
    grad norm, and params and state gathered whole, and the placements
    ``constrain`` gives a replicated tensor. The run named by
    ``inputs["save"]`` is then saved to ``<workdir>/ckpt`` (step 1).
  * ``restore``: a fresh launch of 2 ranks, the survivors of the 4:
    ``shrink_mesh((2, 2), lost=2)`` and ``restore_on_mesh`` of that
    checkpoint from a ``meta`` template; the result is the tree gathered
    whole and the number of ranks each leaf lives on. Then, on that mesh,
    ``RESUME_STEPS`` steps of the saved run's arch from its inputs, once
    uninterrupted and once saved asynchronously after every step (rank 0's
    writes slowed, so a rank that did not wait for them would read an
    older step), killed at ``RESUME_FAIL_AT`` and resumed in the same
    launch; the result holds both runs' losses and trees, the step each
    rank restored, and whether each rank's ``wait`` raised rank 0's
    writer error.
  * ``train`` (``tests/test_torch_launch_train.py``): on the (2, 2) mesh,
    each run of ``inputs["steps"]`` takes one step as ``step`` does, at its
    own model options, with the MoE aux loss of each microbatch before the
    step as every rank computes it; then the group is destroyed and each
    run of ``inputs["cli"]`` calls ``repro_torch.launch.train.main`` with
    its ``argv``, which joins a group from torchrun's variables
    (``MASTER_PORT`` the run's ``port``); ``fp32`` runs it with fp32
    compute. The result holds the steps and rank 0's printed lines a run.

Imports only torch and the port."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MODEL_OPTS = dict(compute_dtype="float32", loss_chunk=8, moe_group=16, wkv_chunk=8, ssm_chunk=8)
# AdamW at its warmup lr (tests/test_torch_train.py's WARMUP)
WARMUP = dict(lr=3e-4, warmup_steps=200, total_steps=50_000)
MICROBATCHES = 2
MESH = (2, 2)
RESUME_STEPS, RESUME_FAIL_AT, WRITE_DELAY_S = 3, 2, 0.3


def launch(case: str, world: int, workdir: Path, timeout: float) -> dict:
    """Run ``case`` on ``world`` ranks; return rank 0's result. Raises
    with the ranks' output if any fails or the launch outlives
    ``timeout`` (every rank is killed then)."""
    import torch

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    store = workdir / f"{case}.store"
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r), str(world), str(workdir)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
        store.unlink(missing_ok=True)
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join(f"rank {r} rc {p.returncode}:\n{o[-3000:]}"
                                     for r, (p, o) in enumerate(zip(procs, outs))))
    return torch.load(workdir / f"{case}.pt", weights_only=False)


def _gather(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda t: t.full_tensor(), tree)


def _drop_data(layouts):
    """Layouts with the data axes replicated (JAX dryrun's ``_drop_data``)."""
    from torch.distributed.tensor import Replicate
    from torch.utils import _pytree as pytree

    from repro_torch.dist.api import data_axes, is_layout

    def drop(lay):
        mesh, pl = lay
        return mesh, [Replicate() if i in data_axes(mesh) else p for i, p in enumerate(pl)]

    return pytree.tree_map(drop, layouts, is_leaf=is_layout)


def _mesh_step(mesh, run: dict, model_opts: dict, aux: bool = False) -> dict:
    """One train step of ``run`` (its arch, params, batch, ``zero3`` and
    ``local_accum``) on ``mesh`` with ``MICROBATCHES`` microbatches: its
    loss, grad norm, and params and state gathered whole (the tree itself
    under ``"live"``). With ``aux``, also the MoE aux loss of each
    microbatch before the step, as each rank computes it on its rows under
    the sharding context (a list a rank)."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.api import place, use_sharding
    from repro_torch.dist.sharding import batch_shardings, make_context, param_shardings
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.train_step import TrainRunConfig, make_train_step
    import torch
    import torch.distributed as dist

    cfg = get_config(run["arch"]).smoke()
    model = build_model(cfg, ModelOptions(**model_opts))
    opt = AdamW(AdamWConfig(**WARMUP))
    b, s = run["batch"]["labels"].shape
    out = {}
    with use_sharding(make_context(mesh, cfg, zero3=run.get("zero3", False))):
        p_sh = param_shardings(run["params"], cfg, mesh)
        params = place(run["params"], p_sh)
        state = opt.init(run["params"])
        state = place(state, param_shardings(state, cfg, mesh))
        batch = place(run["batch"], batch_shardings(cfg, ShapeConfig("t", "train", s, b), mesh))
        if aux:
            full = pytree.tree_map(lambda t: t.full_tensor(), params)
            rows = {k: v.to_local() for k, v in batch.items()}
            with torch.no_grad():
                mine = [float(model.apply(full, {k: v[j::MICROBATCHES] for k, v in rows.items()})[1])
                        for j in range(MICROBATCHES)]
            del full
            out["aux"] = [None] * dist.get_world_size()
            dist.all_gather_object(out["aux"], mine)
        accum = _drop_data(p_sh) if run.get("local_accum") else None
        step = make_train_step(model, opt, TrainRunConfig(num_microbatches=MICROBATCHES,
                                                          grad_accum_shardings=accum))
        params, state, metrics = step(params, state, batch)
    tree = {"params": params, "opt": state}
    out.update({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                "tree": _gather(tree), "live": tree})
    return out


def case_step(workdir: Path) -> dict:
    from torch.distributed.tensor import Replicate

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.dist.api import constrain, place, use_sharding
    from repro_torch.dist.sharding import make_context
    from repro_torch.launch.mesh import make_mesh
    import torch

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    mesh = make_mesh(MESH, AXES, "cpu")
    # a replicated tensor constrained to (data, -, model)
    with use_sharding(make_context(mesh, get_config("qwen3-8b").smoke())):
        x = place(torch.zeros(4, 8, 16), (mesh, [Replicate(), Replicate()]))
        out = {"constrained": list(constrain(x, ("data", None, "model")).placements)}
    for name, run in inputs["runs"].items():
        res = _mesh_step(mesh, run, MODEL_OPTS)
        if name == inputs["save"]:
            CheckpointManager(str(workdir / "ckpt"), async_save=False).save(1, res["live"])
        del res["live"]
        out[name] = res
    return out


def case_restore(workdir: Path) -> dict:
    from torch.utils import _pytree as pytree

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.dist.elastic import restore_on_mesh, shrink_mesh
    from repro_torch.train.optimizer import AdamW
    import torch

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    run = inputs["runs"][inputs["save"]]
    mesh = shrink_mesh(MESH, AXES, lost=2, device_type="cpu")
    meta = pytree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                           run["params"])
    template = {"params": meta, "opt": AdamW().init(meta)}
    mgr = CheckpointManager(str(workdir / "ckpt"), async_save=False)
    step, tree, _ = restore_on_mesh(mgr, template, get_config(run["arch"]).smoke(), mesh)
    ranks = {t.device_mesh.size() for t in pytree.tree_leaves(tree)}
    return {"step": step, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "ranks": sorted(ranks), "tree": _gather(tree),
            "resume": _resume(workdir, run, mesh)}


def _slow_writes(mgr, fail: bool = False):
    """``mgr`` with rank 0's writes delayed by ``WRITE_DELAY_S`` (or
    failing)."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == 0:
        write = mgr._write

        def slow(*args):
            time.sleep(WRITE_DELAY_S)
            if fail:
                raise OSError("disk full")
            write(*args)

        mgr._write = slow
    return mgr


def _resume(workdir: Path, run: dict, mesh) -> dict:
    from torch.utils import _pytree as pytree

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.api import place
    from repro_torch.dist.elastic import restore_on_mesh
    from repro_torch.dist.fault import FailureInjector, RestartSupervisor
    from repro_torch.dist.sharding import batch_shardings, param_shardings
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.train_step import TrainRunConfig, make_train_step
    import torch
    import torch.distributed as dist

    cfg = get_config(run["arch"]).smoke()
    opt = AdamW(AdamWConfig(**WARMUP))
    step = make_train_step(build_model(cfg, ModelOptions(**MODEL_OPTS)), opt,
                           TrainRunConfig(num_microbatches=MICROBATCHES))
    b, s = run["batch"]["labels"].shape
    b_sh = batch_shardings(cfg, ShapeConfig("t", "train", s, b), mesh)
    on_mesh = lambda tree: place(tree, param_shardings(tree, cfg, mesh))

    def fresh():
        params = pytree.tree_map(torch.clone, run["params"])
        return on_mesh({"params": params, "opt": opt.init(params)})

    def train(tree, i):
        batch = place({k: v.roll(i, dims=1) for k, v in run["batch"].items()}, b_sh)
        params, state, metrics = step(tree["params"], tree["opt"], batch)
        return {"params": params, "opt": state}, float(metrics["loss"])

    tree, losses_a = fresh(), []
    for i in range(RESUME_STEPS):
        tree, loss = train(tree, i)
        losses_a.append(loss)
    tree_a = _gather(tree)

    mgr = _slow_writes(CheckpointManager(str(workdir / "resume"), keep=2))
    injector, sup = FailureInjector([RESUME_FAIL_AT]), RestartSupervisor(max_restarts=1)
    b_run = {"losses": {}, "restored": None}

    def resume() -> int:
        mgr.wait()
        if mgr.latest_step() is None:
            b_run["tree"] = fresh()
            return 0
        template = pytree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                                   b_run["tree"])
        b_run["restored"], b_run["tree"], _ = restore_on_mesh(mgr, template, cfg, mesh)
        return b_run["restored"]

    def body(start: int) -> int:
        for i in range(start, RESUME_STEPS):
            injector.maybe_fail(i)
            b_run["tree"], b_run["losses"][i] = train(b_run["tree"], i)
            mgr.save(i + 1, b_run["tree"])
        mgr.wait()
        return RESUME_STEPS

    sup.run(body, resume)
    broken = _slow_writes(CheckpointManager(str(workdir / "broken")), fail=True)
    broken.save(1, {"w": torch.zeros(4)})
    try:
        broken.wait()
        raised = None
    except RuntimeError as e:
        raised = str(e)
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, {"restored": b_run["restored"], "raised": raised})
    return {"losses_a": losses_a, "tree_a": tree_a,
            "losses_b": [b_run["losses"][i] for i in range(RESUME_STEPS)],
            "tree_b": _gather(b_run["tree"]), "restarts": sup.restarts,
            "left": sorted(p.name for p in mgr.dir.iterdir()), "per_rank": per_rank}


def _cli(run: dict, rank: int, world: int) -> str:
    """``repro_torch.launch.train.main(run["argv"])``, which joins a group
    from torchrun's variables; its printed lines."""
    import contextlib
    import functools
    import io

    import repro_torch.launch.train as cli

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(run["port"]), "WORLD_SIZE": str(world),
           "RANK": str(rank), "LOCAL_RANK": str(rank)}
    os.environ.update(env)
    opts, out = cli.ModelOptions, io.StringIO()
    if run.get("fp32"):
        cli.ModelOptions = functools.partial(opts, compute_dtype="float32")
    try:
        with contextlib.redirect_stdout(out):
            cli.main(run["argv"])
    finally:
        cli.ModelOptions = opts
        for k in env:
            del os.environ[k]
    return out.getvalue()


def case_train(workdir: Path) -> dict:
    from repro_torch.launch.mesh import make_mesh
    import torch
    import torch.distributed as dist

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    mesh = make_mesh(MESH, AXES, "cpu")
    out = {"steps": {}}
    for name, run in inputs.get("steps", {}).items():
        res = _mesh_step(mesh, run, run["opts"], aux=True)
        del res["live"]
        out["steps"][name] = res
    rank, world = dist.get_rank(), dist.get_world_size()
    dist.destroy_process_group()  # each CLI run joins a group of its own
    out["cli"] = {name: _cli(run, rank, world) for name, run in inputs.get("cli", {}).items()}
    return out


def main() -> None:
    import torch
    import torch.distributed as dist

    case, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    # the lowest priority: under xdist the ranks yield the cores to the
    # suite's workers (the lint budget test among them)
    os.nice(19)
    torch.set_num_threads(1)
    store = dist.FileStore(str(workdir / f"{case}.store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = {"step": case_step, "restore": case_restore, "train": case_train}[case](workdir)
        if rank == 0:
            torch.save(out, workdir / f"{case}.pt")
        if dist.is_initialized():
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
