#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc, at
first use), then runs five phases, each printing JSON lines:

1. env      — the card's name and power limit (nvidia-smi), torch/CUDA
              versions, the kernels' build time.
2. kernels  — every kernel at the serve path's shapes and at prefill
              sizes, held against its plain PyTorch version on the card
              (tolerance stated per line), timed beside the plain version,
              one PyTorch library call where one computes the same
              function, and its bound (bytes or operations at the H100's
              published peaks).
3. serve    — ``repro_torch.launch.serve.main`` with gemma-2b and qwen3-8b
              at full width (random weights from fixed seeds) on one
              ``SalusExecutor``: every request served, no failures, and
              the kernels' launch counters rise by exactly the count the
              path implies. Then the ``{"kernels": [...]}`` summary line.
4. parity   — qwen3-8b at full width and depth, prefill of a (1, 512)
              prompt through the kernels against the plain versions, bf16.
5. paging   — two gemma-2b-width services (depth 2) on one executor with
              paging on and a capacity that forces the first out to host
              and back; its next tokens after the round trip must equal
              those before.

Any failed check raises and the script exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without CUDA, or run outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (dense), the bound's denominators: bf16 on the
# tensor cores; fp32 outside them (the kernels do fp32 arithmetic on the
# plain ALUs, and fp32 attention may not use TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the JAX kernel tests' tolerances (tests/test_kernels_rmsnorm.py, _flash.py)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RMS_SRC = "src/repro_torch/csrc/rmsnorm.cu"
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
RMS_TPU = "src/repro/kernels/fused_rmsnorm/kernel.py:19"
RMS_RES_TPU = "src/repro/kernels/fused_rmsnorm/kernel.py:27"
FLASH_TPU = "src/repro/kernels/flash_attention/kernel.py:35"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events, after
    one warm-up call."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def within(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    """|a - b| <= tol + tol * |b| everywhere (the JAX tests' rtol = atol)."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all().item())


def bound(nbytes: float, ops: float, flops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: env
# ---------------------------------------------------------------------------


def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    info = {
        "phase": "env",
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "kernel_build_s": build_s,
    }
    emit(info)
    return info


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def rmsnorm_case(rows: int, d: int, dtype, residual: bool, iters: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.fused_rmsnorm import ops
    from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device="cuda").manual_seed(rows * 7 + d)
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    scale = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1.0).to(dtype)
    r = torch.randn(rows, d, generator=gen, device="cuda").to(dtype) if residual else None
    out = ops.rmsnorm(x, scale, r)
    ref = rmsnorm_ref(x, scale, r)
    sync()
    tol = TOL[dtype]
    err = max_err(out, ref)
    ok = within(out, ref, tol)
    ms = time_ms(lambda: ops.rmsnorm(x, scale, r), iters)
    plain_ms = time_ms(lambda: rmsnorm_ref(x, scale, r), iters)
    library_ms = None
    if not residual and hasattr(F, "rms_norm"):
        library_ms = time_ms(lambda: F.rms_norm(x, (d,), scale, 1e-6), iters)
    es = x.element_size()
    nbytes = rows * d * es * (3 if residual else 2) + d * scale.element_size()
    ops_count = rows * d * (5 if residual else 4)
    bound_ms, bound_by = bound(nbytes, ops_count, PEAK_FLOPS[torch.float32])
    res = {
        "phase": "kernels",
        "kernel": "rmsnorm_residual" if residual else "rmsnorm",
        "shape": [rows, d],
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err,
        "tol": tol,
        "ok": ok,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    emit(res)
    check(ok, f"rmsnorm {rows}x{d} {dtype} residual={residual}: err {err} > tol {tol}")
    return res


def flash_case(b, sq, sk, hq, hkv, d, dtype, *, causal=True, window=None,
               q_offset=0, iters=10) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(sq * 31 + hq * 7 + d)
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    run = lambda: ops.flash_attention(q, k, v, block_q=sq, block_k=sk, **kw)
    plain = lambda: attention_ref(q, k, v, **kw)
    out, ref = run(), plain()
    sync()
    tol = FLASH_TOL[dtype]
    err = max_err(out, ref)
    ok = within(out, ref, tol)
    ms = time_ms(run, iters)
    plain_ms = time_ms(plain, iters)
    library_ms = None
    if window is None and q_offset == 0 and sq == sk:
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=hq != hkv
            ),
            iters,
        )
    qpos = torch.arange(sq, device="cuda")[:, None] + q_offset
    kpos = torch.arange(sk, device="cuda")[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    pairs = int(mask.sum().item())  # the (query, key) pairs this input needs
    flops = 4.0 * b * hq * d * pairs
    es = q.element_size()
    nbytes = es * (2 * b * sq * hq * d + 2 * b * sk * hkv * d)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_FLOPS[dtype])
    res = {
        "phase": "kernels",
        "kernel": "flash_attention",
        "shape": {"b": b, "sq": sq, "sk": sk, "hq": hq, "hkv": hkv, "d": d,
                  "causal": causal, "window": window, "q_offset": q_offset},
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err,
        "tol": tol,
        "ok": ok,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "gflop": flops / 1e9,
    }
    emit(res)
    check(ok, f"flash {res['shape']} {dtype}: err {err} > tol {tol}")
    return res


def phase_kernels() -> dict:
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}
    for dtype in (f32, bf16):
        # serve path (b*s = 64 rows): attn/mlp norm qwen3 (4096), gemma
        # (2048); qk-norm rows b*s*heads; and a prefill-sized input
        for rows, d in ((64, 4096), (64, 2048), (2048, 128), (512, 128), (8192, 4096)):
            res = rmsnorm_case(rows, d, dtype, residual=False, iters=50)
            results[("rmsnorm", rows, d, res["dtype"])] = res
        for rows, d in ((64, 4096), (8192, 4096)):
            res = rmsnorm_case(rows, d, dtype, residual=True, iters=50)
            results[("rmsnorm_residual", rows, d, res["dtype"])] = res
    cases = [
        # serve prompt (4, 16): qwen3-8b, gemma-2b
        dict(b=4, sq=16, sk=16, hq=32, hkv=8, d=128, dtype=bf16, iters=50),
        dict(b=4, sq=16, sk=16, hq=8, hkv=1, d=256, dtype=bf16, iters=50),
        # prefill of 2048 tokens: qwen3-8b, gemma-2b
        dict(b=1, sq=2048, sk=2048, hq=32, hkv=8, d=128, dtype=bf16, iters=5),
        dict(b=1, sq=2048, sk=2048, hq=8, hkv=1, d=256, dtype=bf16, iters=5),
        # the parity phase's prompt, fp32 at the JAX tests' 2e-5
        dict(b=1, sq=512, sk=512, hq=32, hkv=8, d=128, dtype=f32, iters=5),
        # sliding window, and a query suffix at an offset
        dict(b=1, sq=1024, sk=1024, hq=8, hkv=2, d=128, dtype=bf16, window=256, iters=10),
        dict(b=1, sq=512, sk=1024, hq=8, hkv=2, d=128, dtype=bf16, q_offset=512, iters=10),
    ]
    for c in cases:
        res = flash_case(**c)
        s = res["shape"]
        results[("flash_attention", s["b"], s["sq"], s["hq"], s["d"], s["window"],
                 s["q_offset"], res["dtype"])] = res
    return results


# ---------------------------------------------------------------------------
# phase 3: serve at full width
# ---------------------------------------------------------------------------


def launches_per_request(cfg) -> dict:
    """Kernel launches of one prefill: attn + mlp norm per layer, q/k norm
    per layer when the arch has qk-norm, the final norm; one attention per
    layer."""
    norms = cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
    return {"rmsnorm": norms, "flash_attention": cfg.n_layers}


def profile_request(sess) -> dict:
    """One more request of a served session under ``torch.profiler``: wall
    time, the device time of its kernels grouped by kind, and the device's
    busy share of the wall time. Runs after the launch counts are read, so
    it adds nothing to them."""
    from torch.profiler import ProfilerActivity, profile

    batch = sess.data_fn(0)
    sess.step_fn(sess.state, batch)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.step_fn(sess.state, batch)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"rmsnorm": 0.0, "flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    n_kernels = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key.lower()
        if "rmsnorm_kernel" in name:
            key = "rmsnorm"
        elif "flash_fwd_kernel" in name:
            key = "flash_attention"
        elif any(t in name for t in ("gemm", "xmma", "nvjet", "cutlass", "sm90_")):
            key = "gemm"
        else:
            key = "other"
        groups[key] += us / 1e3
        n_kernels += evt.count
    device_ms = sum(groups.values())
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if device_ms else None,
        "device_ms_by_kind": groups,
        "kernels_launched": n_kernels,
    }


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rms_ops
    from repro_torch.launch import serve

    archs = ["gemma-2b", "qwen3-8b"]
    argv = [
        "--archs", ",".join(archs), "--no-smoke", "--device", "cuda",
        "--capacity-gb", "72", "--rps", "4", "--duration", "3", "--requests", "4",
        "--policy", "priority", "--seed", "0",
    ]
    rms_ops.rmsnorm.launches = 0
    fa_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    report, ex = serve.serve(serve.build_parser().parse_args(argv))
    wall_s = time.perf_counter() - t0
    launches = {
        "rmsnorm": rms_ops.rmsnorm.launches,
        "flash_attention": fa_ops.flash_attention.launches,
    }
    check(not report.failures, f"serve failures: {report.failures}")
    expected = {"rmsnorm": 0, "flash_attention": 0}
    services = {}
    for jid, st in report.stats.items():
        sess = ex.sessions[jid]
        job = sess.job
        cfg = get_config(job.name)
        check(st.iterations_done == sess.n_iters,
              f"{job.name}: served {st.iterations_done} of {sess.n_iters} requests")
        for m in sess.metrics_log:
            tok = m["next_token"]
            check(tok.shape == (serve.PROMPT_SHAPE[0],), f"{job.name}: token shape {tok.shape}")
            check(bool(((tok >= 0) & (tok < cfg.vocab_size)).all().item()),
                  f"{job.name}: token out of range")
        # one profiling step at session creation plus one prefill a request
        per = launches_per_request(cfg)
        for name in expected:
            expected[name] += per[name] * (st.iterations_done + 1)
        services[job.name] = {
            "requests": st.iterations_done,
            "latency_ms": [x * 1e3 for x in st.request_latencies],
            "p50_ms": st.p50_latency * 1e3,
            "p99_ms": st.p99_latency * 1e3,
            "profile_gb": {"persistent": job.profile.persistent / 2**30,
                           "ephemeral": job.profile.ephemeral / 2**30},
            "launches_per_request": per,
        }
    check(launches == expected, f"launch counts {launches} != expected {expected}")
    for jid in report.stats:
        sess = ex.sessions[jid]
        services[sess.job.name]["profiled_request"] = profile_request(sess)
    res = {
        "phase": "serve",
        "wall_s": wall_s,
        "services": services,
        "launches": launches,
        "expected_launches": expected,
        "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(res)
    del report, ex, sess, job
    gc.collect()
    torch.cuda.empty_cache()
    return res


def kernels_line(k: dict, serve_res: dict) -> None:
    """The summary line: each kernel the serve path launches, measured at
    its largest serve-path shape (qwen3-8b, bf16), with the path's count."""
    rms = k[("rmsnorm", 64, 4096, "bfloat16")]
    rms_res = k[("rmsnorm_residual", 64, 4096, "bfloat16")]
    fa = k[("flash_attention", 4, 16, 32, 128, None, 0, "bfloat16")]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "rmsnorm", "route": "cuda", "source": RMS_SRC,
         "replaces": RMS_TPU, "also_replaces": RMS_RES_TPU,
         "launches": serve_res["launches"]["rmsnorm"], "shape": rms["shape"],
         "dtype": "bfloat16", **{x: rms[x] for x in keys},
         "residual_form": {x: rms_res[x] for x in keys}},
        {"name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
         "replaces": FLASH_TPU,
         "launches": serve_res["launches"]["flash_attention"], "shape": fa["shape"],
         "dtype": "bfloat16", **{x: fa[x] for x in keys}},
    ]})


# ---------------------------------------------------------------------------
# phase 4: full-depth model parity, kernels against plain versions
# ---------------------------------------------------------------------------


def phase_parity(seq: int = 512) -> dict:
    """qwen3-8b at full width and depth, one (1, seq) prompt: the kernels
    against the plain versions, in bf16 (the serving dtype) and in fp32,
    each also held against the plain fp32 prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rms_ops
    from repro_torch.models import ModelOptions, build_model

    cfg = get_config("qwen3-8b")
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = build_model(cfg).init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, seq), generator=gen, device="cuda")}

    def prefill(kernel_mode: str, dtype: str):
        model = build_model(cfg, ModelOptions(kernel_mode=kernel_mode, compute_dtype=dtype))
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch)
        sync()
        return logits.float(), cache, (time.perf_counter() - t0) * 1e3

    prefill("kernel", "bfloat16")  # warm-up: cuBLAS handles and workspaces
    before = (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches)
    k16, cache_k, kernel_ms = prefill("kernel", "bfloat16")
    launched = (rms_ops.rmsnorm.launches - before[0],
                fa_ops.flash_attention.launches - before[1])
    r16, cache_r, plain_ms = prefill("reference", "bfloat16")
    k32, _, kernel32_ms = prefill("kernel", "float32")
    r32, _, plain32_ms = prefill("reference", "float32")
    per = launches_per_request(cfg)
    check(launched == (per["rmsnorm"], per["flash_attention"]),
          f"parity prefill launched {launched}, expected {per}")
    for name, t in (("kernel bf16", k16), ("kernel fp32", k32)):
        check(bool(torch.isfinite(t).all().item()), f"{name}: non-finite logits")
        check(t.shape == (1, cfg.vocab_size), f"{name}: logits shape {tuple(t.shape)}")
    # bf16 through 36 layers: the kernels keep attention probabilities in
    # fp32 (as the Pallas kernel does) where the plain path rounds them to
    # bf16 (as the JAX oracle does), so the two drift apart by the order of
    # bf16's own rounding error through the stack. That error is measured
    # here as the plain bf16 path's distance from the plain fp32 path; the
    # kernels may differ from the plain path by twice it, and must land
    # no further than 1.25 times it from fp32.
    err_plain16 = max_err(r16, r32)
    err_kernel16 = max_err(k16, r32)
    diff16 = max_err(k16, r16)
    tol16 = 2.0 * err_plain16
    # fp32: the kernels do the plain versions' arithmetic in another order
    tol32 = 1e-3
    diff32 = max_err(k32, r32)
    top2 = torch.topk(r16, 2, dim=-1).values[0]
    res = {
        "phase": "parity",
        "arch": cfg.name,
        "n_layers": cfg.n_layers,
        "prompt": [1, seq],
        "bf16": {
            "logits_max_abs_diff": diff16,
            "tol": tol16,
            "kernel_vs_fp32": err_kernel16,
            "plain_vs_fp32": err_plain16,
            "argmax_kernel": int(k16.argmax().item()),
            "argmax_plain": int(r16.argmax().item()),
            "plain_top2_gap": float(top2[0] - top2[1]),
            "k_cache_max_abs_diff": max_err(cache_k["k"], cache_r["k"]),
            "v_cache_max_abs_diff": max_err(cache_k["v"], cache_r["v"]),
        },
        "fp32": {
            "logits_max_abs_diff": diff32,
            "tol": f"{tol32} (1 + |plain|)",
            "argmax_kernel": int(k32.argmax().item()),
            "argmax_plain": int(r32.argmax().item()),
        },
        "logits_std": r32.std().item(),
        "prefill_ms": {"kernel_bf16": kernel_ms, "plain_bf16": plain_ms,
                       "kernel_fp32": kernel32_ms, "plain_fp32": plain32_ms},
        "launches": {"rmsnorm": launched[0], "flash_attention": launched[1]},
    }
    emit(res)
    check(diff16 <= tol16, f"bf16 logits differ by {diff16} > {tol16}")
    check(err_kernel16 <= 1.25 * err_plain16,
          f"bf16 kernels {err_kernel16} from fp32, plain {err_plain16}")
    check(res["bf16"]["argmax_kernel"] == res["bf16"]["argmax_plain"], "bf16 argmax differs")
    check(within(k32, r32, tol32), f"fp32 logits differ by {diff32}")
    check(res["fp32"]["argmax_kernel"] == res["fp32"]["argmax_plain"], "fp32 argmax differs")
    del params, cache_k, cache_r
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 5: paging round trip
# ---------------------------------------------------------------------------


def phase_paging() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import MemoryConfig, SalusExecutor, VirtualDevice, get_policy
    from repro_torch.core.profiles import profile_step
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = replace(get_config("gemma-2b"), name="gemma-2b-depth2", n_layers=2)
    model = build_model(cfg)

    def handle(state, request):
        logits, _ = model.prefill(state, request)
        return state, {"next_token": torch.argmax(logits, dim=-1)}

    gen = torch.Generator(device=dev).manual_seed(5)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen, device=dev)}
    data_fn = lambda i: prompt
    params_a = model.init(torch.Generator(device=dev).manual_seed(1))
    params_b = model.init(torch.Generator(device=dev).manual_seed(2))
    before = handle(params_a, prompt)[1]["next_token"].cpu()
    prof_a = profile_step(handle, params_a, prompt, dev)
    prof_b = profile_step(handle, params_b, prompt, dev)
    # both fit alone; together only with one's persistent state on host
    capacity = prof_a.persistent + prof_b.persistent + max(prof_a.ephemeral, prof_b.ephemeral) - 1
    ex = SalusExecutor(capacity, get_policy("fifo"), memory=MemoryConfig(paging=True), device=dev)
    vdev = VirtualDevice(ex)
    sess_a = vdev.create_session("A", handle, params_a, data_fn, n_iters=2, profile=prof_a)
    del params_a
    sync()
    mem_before = torch.cuda.memory_allocated()
    vdev.create_session("B", handle, params_b, data_fn, n_iters=2, profile=prof_b)
    del params_b
    sync()
    mem_after_out = torch.cuda.memory_allocated()
    report = vdev.run()
    kinds = [(kind, name) for kind, _o, name, _l in report.decision_log]
    check(("page_out", "A") in kinds and ("page_in", "A") in kinds,
          f"no page-out/page-in round trip of A: {kinds}")
    check(not report.failures, f"paging failures: {report.failures}")
    after = [m["next_token"].cpu() for m in sess_a.metrics_log]
    check(len(after) == 2 and all(torch.equal(t, before) for t in after),
          f"A's tokens changed over the round trip: {before} vs {after}")
    freed = mem_before - mem_after_out
    check(freed >= 0.99 * prof_a.persistent,
          f"page-out freed {freed} bytes of A's {prof_a.persistent}")
    res = {
        "phase": "paging",
        "decisions": kinds,
        "persistent_gb": prof_a.persistent / 2**30,
        "device_bytes_freed_by_page_out_gb": freed / 2**30,
        "transfer_latencies_s": report.transfer_latencies,
        "transfer_gb_per_s": [prof_a.persistent / t / 1e9 for t in report.transfer_latencies],
        "tokens_before": before.tolist(),
        "tokens_after": [t.tolist() for t in after],
    }
    emit(res)
    return res


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_env()
    k = phase_kernels()
    serve_res = phase_serve()
    kernels_line(k, serve_res)
    phase_parity()
    phase_paging()
    emit({"phase": "done", "wall_s": time.perf_counter() - t0})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
