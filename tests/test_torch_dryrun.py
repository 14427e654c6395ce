"""The port's dry run (``repro_torch.launch.dryrun``, ``op_count``,
``roofline``) against the JAX package's (``repro.launch.dryrun``,
``hlo_flops``, ``hlo_analysis``): the config helpers it needs for every
arch and shape, twins of ``tests/test_hlo_analysis.py`` at its
tolerances, closed forms of bytes and live bytes, gemma-2b's whole train,
prefill and decode steps (full width, one layer, fp32, reference path)
within 3% of ``analyze_hlo`` on JAX's compiled steps, a rank's share of a
(2, 2) fake mesh, the kernel wrappers' fake branch and each kernel's
``cost`` against ``PERF.md``'s Bound column, and the CLI."""
import json
import math
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import all_cells as jax_all_cells  # noqa: E402
from repro.configs import get_shape as jax_get_shape  # noqa: E402
from repro.configs import skipped_cells as jax_skipped_cells  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCHS,
    SHAPES,
    ShapeConfig,
    all_cells,
    get_config,
    get_shape,
    skipped_cells,
)
from repro_torch.dist.api import use_sharding  # noqa: E402
from repro_torch.dist.sharding import make_context  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import _mask, attention_ref  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.rwkv_scan import ops as wkv_ops  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.op_count import OpCounter, times  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import ModelOptions  # noqa: E402
from repro_torch.train.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro_torch.train.serve_step import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.train.train_step import TrainRunConfig, make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PRODUCTS = ("mm", "addmm", "bmm", "baddbmm")


@pytest.fixture
def fake_ranks():
    """``dryrun.fake_group`` of the given size, destroyed after the test."""
    yield dryrun.fake_group
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# config helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_config_helpers_equal_jax(arch):
    jc, pc = JAX_ARCHS[arch], get_config(arch)
    assert (pc.active_param_count(), pc.param_count(), pc.sub_quadratic) == \
        (jc.active_param_count(), jc.param_count(), jc.sub_quadratic)
    for name in JAX_SHAPES:
        ps, js = get_shape(name), jax_get_shape(name)
        assert pc.supports(ps) == jc.supports(js)
        assert (ps.tokens_per_step, ps.kind, ps.seq_len, ps.global_batch) == \
            (js.tokens_per_step, js.kind, js.seq_len, js.global_batch)


def test_cells_equal_jax():
    names = lambda cells: [(a.name, s.name) for a, s in cells]  # noqa: E731
    assert list(ARCHS) == list(JAX_ARCHS) and list(SHAPES) == list(JAX_SHAPES)
    assert names(all_cells()) == names(jax_all_cells()) and len(all_cells()) == 33
    assert names(skipped_cells()) == names(jax_skipped_cells())
    with pytest.raises(KeyError):
        get_shape("train_8k")


@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_abstract_params_are_model_init(arch):
    """Leaf for leaf, the fake params have ``Model.init``'s shapes and
    dtypes (smoke config, a real draw beside)."""
    cfg = get_config(arch).smoke()
    for dt in ("float32", "bfloat16"):
        model = build_model(cfg, ModelOptions(param_dtype=dt))
        real = model.init(torch.Generator().manual_seed(0))
        with FakeTensorMode():
            fake = dryrun.abstract_params(model)
        flat_r, spec_r = torch.utils._pytree.tree_flatten(real)
        flat_f, spec_f = torch.utils._pytree.tree_flatten(fake)
        assert spec_r == spec_f
        assert [(t.shape, t.dtype) for t in flat_r] == [(t.shape, t.dtype) for t in flat_f]


# ---------------------------------------------------------------------------
# twins of tests/test_hlo_analysis.py, and closed forms
# ---------------------------------------------------------------------------


def _count(fn, *args, **kw):
    with FakeTensorMode():
        args = [torch.empty(a, device=dryrun.DEVICE) if isinstance(a, tuple) else a
                for a in args]
        counter, out, memory = dryrun.count(fn, args, **kw)
    return counter, memory


def test_single_matmul_flops_and_bytes():
    c, _ = _count(lambda x, y: x @ y, (128, 256), (256, 64))
    assert c.flops == pytest.approx(2 * 128 * 256 * 64, rel=0.05)
    assert c.hbm_bytes == 4 * (128 * 256 + 256 * 64 + 128 * 64)  # exact: reads, one write


def test_loop_multiplies_flops_by_trip_count():
    def f(x, a):
        for _ in range(17):
            x = x @ a
        return x

    c, _ = _count(f, (64, 64), (64, 64))
    assert c.flops == pytest.approx(17 * 2 * 64**3, rel=0.1)
    counter = OpCounter()  # the body counted once, times 17
    with FakeTensorMode(), counter, times(counter, 17):
        torch.empty(64, 64) @ torch.empty(64, 64)
    assert counter.flops == pytest.approx(17 * 2 * 64**3, rel=0.1)


def test_nested_loops_multiply():
    counter = OpCounter()
    with FakeTensorMode(), counter:
        a = torch.empty(32, 32)
        with times(counter, 3), times(counter, 5):
            a @ a
    assert counter.flops == pytest.approx(15 * 2 * 32**3, rel=0.1)
    assert counter.flops_by_op["mm"] == 15 * 2 * 32**3


def test_collectives_counted_inside_loops(fake_ranks):
    """An all-reduce of 64 fp32 in a loop of 13 trips on 4 fake ranks."""
    fake_ranks(4)
    counter = OpCounter()
    with FakeTensorMode(), counter:
        x = torch.empty(64)
        with times(counter, 13):
            dist.all_reduce(x)
        dist.all_gather([torch.empty(64) for _ in range(4)], x)
    assert counter.collective_counts == {"all-reduce": 13, "all-gather": 1}
    assert counter.collective_bytes == {"all-reduce": 13 * 256, "all-gather": 256}


def test_peak_live_bytes_allocate_free_allocate():
    def f(x):
        a = torch.empty(1 << 20, dtype=torch.uint8)
        del a
        return torch.empty(1 << 21, dtype=torch.uint8)

    c, memory = _count(f, (256,))
    assert c.peak == 1024 + (1 << 21)  # the argument and the larger, never both
    assert memory == {"argument_bytes": 1024, "output_bytes": 1 << 21, "temp_bytes": 0,
                      "alias_bytes": 0}


def test_in_place_output_aliases_its_argument():
    c, memory = _count(lambda x: x.mul_(2.0), (256,))
    assert memory == {"argument_bytes": 1024, "output_bytes": 1024, "temp_bytes": 0,
                      "alias_bytes": 1024}
    assert c.flops == 256 and c.hbm_bytes == 2 * 1024


# ---------------------------------------------------------------------------
# whole steps against JAX's analyze_hlo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_step_flops():
    """``tests/jax_step_flops.py`` in a subprocess of its own."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "jax_step_flops.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _gemma_one_layer_counts() -> dict:
    """The port's counts of the steps ``tests/jax_step_flops.py`` lowers."""
    cfg = replace(get_config("gemma-2b"), n_layers=1)
    model = build_model(cfg, ModelOptions(kernel_mode="reference", compute_dtype="float32",
                                          param_dtype="float32"))
    opt = AdamW(AdamWConfig())
    out = {}
    with FakeTensorMode():
        params = dryrun.abstract_params(model)
        tokens = torch.zeros(1, 512, dtype=torch.int32, device=dryrun.DEVICE)
        steps = {
            "train": (make_train_step(model, opt, TrainRunConfig()),
                      (params, opt.init(params), {"tokens": tokens, "labels": tokens})),
            "prefill": (make_prefill_step(model, max_len=512), (params, {"tokens": tokens})),
            "decode": (make_decode_step(model), (
                params, {"tokens": torch.zeros(4, 1, dtype=torch.int32, device=dryrun.DEVICE)},
                model.init_cache(4, 512, device=dryrun.DEVICE), 511)),
        }
        for name, (step, args) in steps.items():
            out[name] = dryrun.count(step, args)[0].flops
    return out


def test_whole_steps_within_3_percent_of_jax(jax_step_flops):
    port = _gemma_one_layer_counts()
    gaps = {k: port[k] / jax_step_flops[k] - 1 for k in port}
    print("port / JAX - 1:", gaps)
    assert all(abs(g) <= 0.03 for g in gaps.values()), gaps


def test_rank_share_of_a_2x2_mesh(fake_ranks):
    """qwen3-8b at one layer: on a (2, 2) fake mesh rank 0's product FLOPs
    are a quarter of one rank's on a (1, 1) mesh (half the rows, half the
    heads, MLP columns and vocabulary)."""
    cfg = replace(get_config("qwen3-8b"), n_layers=1)
    shape = ShapeConfig("train_small", "train", 512, 2)
    products, collectives = {}, {}
    for ranks in (1, 2):
        fake_ranks(ranks * ranks)
        mesh = make_mesh((ranks, ranks), ("data", "model"), dryrun.DEVICE)
        with FakeTensorMode():
            step, args, n = dryrun.build_cell(cfg, shape, mesh, microbatch_override=1)
            with use_sharding(make_context(mesh, cfg)):
                counter = dryrun.count(step, args, n)[0]
        products[ranks] = sum(counter.flops_by_op[k] for k in PRODUCTS)
        collectives[ranks] = counter.collective_counts["all-reduce"]
    assert products[2] == pytest.approx(products[1] / 4, rel=0.01)
    assert collectives[1] == 0 < collectives[2]


def test_microbatches_divide_a_ranks_rows(fake_ranks):
    """qwen2-72b's 16 microbatches on a data axis that leaves a rank 8
    rows: 8, the rank's rows in all (2x16x16's train cells); an explicit
    count is kept."""
    cfg = replace(get_config("qwen2-72b"), n_layers=1)
    fake_ranks(8)
    mesh = make_mesh((4, 2), ("data", "model"), dryrun.DEVICE)
    with FakeTensorMode():
        n = dryrun.build_cell(cfg, ShapeConfig("t", "train", 64, 32), mesh)[2]
        m = dryrun.build_cell(cfg, ShapeConfig("t", "train", 64, 32), mesh,
                              microbatch_override=2)[2]
    assert (n, m) == (8, 2)


# ---------------------------------------------------------------------------
# the kernel wrappers on fake tensors, and their cost
# ---------------------------------------------------------------------------


def _fake_calls(dev):
    """(wrapper, call on fake tensors, expected (shape, dtype) of each
    output, its cost)."""
    e = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device=dev)  # noqa: E731
    f32 = torch.float32
    return [
        (rms_ops.rmsnorm, lambda: rms_ops.rmsnorm(e(8, 64), e(64)),
         [((8, 64), torch.bfloat16)], rms_ops.cost(8, 64, 2, 2)),
        (rms_ops.rmsnorm, lambda: rms_ops.rmsnorm(e(8, 64), e(64), e(8, 64)),
         [((8, 64), torch.bfloat16)], rms_ops.cost(8, 64, 2, 2, residual=True)),
        (rms_ops.rmsnorm_bwd, lambda: rms_ops.rmsnorm_bwd(e(8, 64), e(8, 64), e(64, dt=f32)),
         [((8, 64), torch.bfloat16), ((64,), f32)], rms_ops.cost(8, 64, 2, 4, backward=True)),
        (fa_ops.flash_attention,
         lambda: fa_ops.flash_attention(e(1, 128, 4, 64), e(1, 128, 2, 64), e(1, 128, 2, 64)),
         [((1, 128, 4, 64), torch.bfloat16)], fa_ops.cost(1, 128, 128, 4, 2, 64, 2)),
        (fa_ops.flash_attention,
         lambda: fa_ops._forward(e(1, 128, 4, 64), e(1, 256, 2, 64), e(1, 256, 2, 64), True, 64,
                                 128, want_lse=True),
         [((1, 128, 4, 64), torch.bfloat16), ((1, 4, 128), f32)],
         fa_ops.cost(1, 128, 256, 4, 2, 64, 2, window=64, q_offset=128)),
        (fa_ops.flash_attention_bwd,
         lambda: fa_ops.flash_attention_bwd(e(1, 128, 4, 64), e(1, 128, 4, 64), e(1, 128, 2, 64),
                                            e(1, 128, 2, 64), e(1, 128, 4, 64),
                                            e(1, 4, 128, dt=f32)),
         [((1, 128, 4, 64), torch.bfloat16)] + [((1, 128, 2, 64), torch.bfloat16)] * 2,
         fa_ops.cost(1, 128, 128, 4, 2, 64, 2, backward=True)),
        (wkv_ops.wkv6,
         lambda: wkv_ops.wkv6(*(e(2, 16, 4, 64, dt=f32) for _ in range(4)), e(4, 64, dt=f32),
                              chunk=16, s0=e(2, 4, 64, 64, dt=f32)),
         [((2, 16, 4, 64), f32), ((2, 4, 64, 64), f32)], wkv_ops.cost(2, 16, 4, 64, 64, carried=True)),
        (wkv_ops.wkv6_bwd,
         lambda: wkv_ops.wkv6_bwd(e(2, 16, 4, 64, dt=f32), None,
                                  *(e(2, 16, 4, 64, dt=f32) for _ in range(4)), e(4, 64, dt=f32)),
         [((2, 16, 4, 64), f32)] * 4 + [((4, 64), f32), None],
         wkv_ops.cost(2, 16, 4, 64, 64, backward=True)),
    ]


@pytest.mark.parametrize("dev", ["cuda", "cpu"])
def test_fake_calls_charge_their_cost_and_launch_nothing(dev):
    for fn, call, shapes, cost in _fake_calls(dev):
        before = fn.launches
        counter = OpCounter()
        with FakeTensorMode(), counter:
            out = call()
        outs = out if isinstance(out, tuple) else (out,)
        assert [None if t is None else (tuple(t.shape), t.dtype) for t in outs] == shapes
        assert all(t is None or t.device.type == dev for t in outs)
        assert counter.kernels == {fn.__name__: {"launches": 1, "ops": cost[0], "bytes": cost[1]}}
        assert fn.launches == before and counter.flops == cost[0]


def test_fake_autograd_charges_forward_and_backward_kernels():
    """Under autograd the fake calls go through the kernels' autograd
    functions: the backward charges B1, B2 and B3."""
    counter, dev = OpCounter(), dryrun.DEVICE  # a CPU build's autograd aborts on fake cuda
    with FakeTensorMode(), counter:
        x = torch.empty(8, 64, device=dev, requires_grad=True)
        rms_ops.rmsnorm(x, torch.empty(64, device=dev)).sum().backward()
        q = torch.empty(1, 64, 2, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
        fa_ops.flash_attention(q, q, q).float().sum().backward()
        r = torch.empty(1, 16, 2, 64, device=dev, requires_grad=True)
        wkv_ops.wkv6(r, r, r, r, torch.empty(2, 64, device=dev), chunk=16)[0].sum().backward()
    assert {k: v["launches"] for k, v in counter.kernels.items()} == {
        "rmsnorm": 1, "rmsnorm_bwd": 1, "flash_attention": 1, "flash_attention_bwd": 1,
        "wkv6": 1, "wkv6_bwd": 1}


def test_real_cpu_tensors_take_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    x, s = torch.randn(8, 64, generator=g), torch.randn(64, generator=g)
    q = torch.randn(1, 32, 4, 16, generator=g)
    counter = OpCounter()
    with counter:
        out = rms_ops.rmsnorm(x, s)
        att = fa_ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    assert counter.kernels == {} and counter.flops > 0
    torch.testing.assert_close(out, rmsnorm_ref(x, s), rtol=0, atol=0)
    torch.testing.assert_close(att, attention_ref(q, q[:, :, :2], q[:, :, :2]), rtol=0, atol=0)


@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (64, 64, True, None, 0), (33, 97, True, 16, 64), (16, 40, False, 8, 24), (5, 300, False, None, 0),
])
def test_flash_pairs_equal_the_mask(sq, sk, causal, window, q_offset):
    assert fa_ops.pairs(sq, sk, causal, window, q_offset) == \
        int(_mask(sq, sk, causal, window, q_offset, "cpu").sum())


@pytest.mark.parametrize("name,cost,dtype,attention,want", [
    ("K1 (8192, 4096) bf16", rms_ops.cost(8192, 4096, 2, 2), torch.float32, False, 0.0401),
    ("K3 (1, 2048) 32/8 d 128 bf16", fa_ops.cost(1, 2048, 2048, 32, 8, 128, 2), torch.bfloat16,
     True, 0.0348),
    ("K4 (1, 2048)", wkv_ops.cost(1, 2048, 64, 64, 64), torch.float32, False, 0.0504),
    ("B1 (4096, 2048) bf16", rms_ops.cost(4096, 2048, 2, 2, backward=True), torch.float32, False,
     0.0150),
    ("B2 (1, 4096) 8/1 d 256 bf16", fa_ops.cost(1, 4096, 4096, 8, 1, 256, 2, backward=True),
     torch.bfloat16, True, 0.174),
    ("B3 (1, 4096)", wkv_ops.cost(1, 4096, 64, 64, 64, backward=True), torch.float32, False,
     0.192),
])
def test_cost_is_perf_md_bound_column(name, cost, dtype, attention, want):
    """Each to 3 significant figures of its row in PERF.md §6, at
    ``chip_smoke.bound``'s rates (``launch/roofline.py``'s figures)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    got = chip_smoke.bound(cost, dtype, attention)[0]
    assert float(f"{got:.3g}") == want, (name, got)


def test_roofline_terms_keys_and_dominant():
    t = roofline.roofline_terms(989e12, 3.35e12 * 2, 0.0)
    assert t == {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.0, "dominant": "memory",
                 "step_lower_bound_s": 2.0, "roofline_fraction": 0.5}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_main_writes_a_cell_report(tmp_path, fake_ranks, capsys):
    dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--out", str(tmp_path)])
    report = json.loads((tmp_path / "gemma-2b__decode_32k__16x16.json").read_text())
    assert set(report) >= {
        "arch", "shape", "mesh", "n_devices", "memory", "peak_bytes_per_device", "fits_80GB",
        "flops_per_device", "hbm_bytes_per_device", "collectives", "roofline",
        "model_flops_per_device", "useful_flops_ratio", "kernel_mode", "count_s"}
    assert report["n_devices"] == 256 and report["mesh"] == "16x16"
    assert set(report["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                     "alias_bytes"}
    assert set(report["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant",
                                       "step_lower_bound_s", "roofline_fraction"}
    assert report["fits_80GB"] and 0 < report["useful_flops_ratio"] <= 1
    cfg = get_config("gemma-2b")
    assert report["model_flops_per_device"] == 2.0 * cfg.active_param_count() * 128 / 256
    assert math.isfinite(report["roofline"]["step_lower_bound_s"])
    assert "all cells OK" in capsys.readouterr().out
    roofline.report(tmp_path)
    row = capsys.readouterr().out.strip().split(",")
    assert row[0] == "roofline_gemma-2b_decode_32k_16x16" and float(row[1]) > 0


def test_main_train_cell_flags(tmp_path, fake_ranks):
    """A train cell under JAX's other flags: ZeRO-3, the local accumulator,
    two microbatches, the kernels counted by their cost, a tag; then
    skipped as existing."""
    argv = ["--arch", "gemma-2b", "--shape", "train_4k", "--out", str(tmp_path), "--zero3",
            "--local-grad-accum", "--microbatches", "2", "--kernel-mode", "kernel", "--tag", "t"]
    dryrun.main(argv)
    report = json.loads((tmp_path / "gemma-2b__train_4k__16x16__t.json").read_text())
    assert report["microbatches"] == 2 and report["tag"] == "t"
    # a rank's 16 rows in two microbatches: each kernel's launches a step
    assert {k: v["launches"] for k, v in report["kernels"].items()} == {
        "rmsnorm": 2 * 73, "flash_attention": 2 * 36, "rmsnorm_bwd": 2 * 37,
        "flash_attention_bwd": 2 * 18}
    assert report["collectives"]["counts"]["all-gather"] > 0  # ZeRO-3's gathers
    path = tmp_path / "gemma-2b__train_4k__16x16__t.json"
    path.write_text("{}")
    dryrun.main(argv + ["--skip-existing"])
    assert path.read_text() == "{}"
