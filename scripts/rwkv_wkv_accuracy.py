#!/usr/bin/env python3
"""How close each WKV6 path of the port comes to an fp64 recurrence, and
how much of that a 4-layer rwkv6-7b's fp32 gradients feel. On the card:

    python3 scripts/rwkv_wkv_accuracy.py [--src DIR]

``--src`` takes the ``src/`` of another checkout (an unpacked parent
commit, say) in place of this one's, so its kernels are measured in the
same call. Prints JSON lines:

1. the forward at (1, 4096), 64 heads of 64, with rwkv6-7b's initial
   decays (``exp(-exp(-6 + 0.7 z))``), the slow and the faster regime:
   relative Frobenius gap of ``o`` and the final state from the fp64
   step-by-step oracle, for K4, ``wkv_chunked`` and the fp32 oracle;
2. the backward at the same shape, the initial decays and a wider spread
   of them: each gradient's gap from autograd of the fp64 oracle, for B3,
   autograd of ``wkv_chunked`` and of the fp32 oracle;
3. rwkv6-7b at full width and 4 of 32 layers on one (1, 4096) batch in
   fp32 (``chip_smoke.rwkv_train_parity``'s params and batch): the loss
   and every gradient leaf through the kernels against the plain path
   (``wkv_chunked``), and against the plain path with the step-by-step
   oracle as its WKV.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path[:0] = [args.src, str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.rwkv_scan import ops, ref
    from repro_torch.models import rwkv

    wkv6_ref = ref.wkv6_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, d = 1, 4096, 64, 64

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    r, k, v, do = (randn(b, s, h, d) for _ in range(4))
    u = randn(h, d) * 0.1
    decays = {"init": torch.exp(-torch.exp(-6 + 0.7 * randn(b, s, h, d))),
              "init_wide": torch.exp(-torch.exp(-6 + 1.5 * randn(b, s, h, d))),
              "slow": torch.sigmoid(randn(b, s, h, d)) * 0.1 + 0.88,
              "faster": torch.sigmoid(randn(b, s, h, d)) * 0.9 + 0.05}
    for name in ("init", "slow", "faster"):
        w = decays[name]
        with torch.no_grad():
            o64, s64 = wkv6_ref(r.double(), k.double(), v.double(), w.double(), u.double())
            paths = {"k4": ops.wkv6(r, k, v, w, u, chunk=64),
                     "wkv_chunked": rwkv.wkv_chunked(r, k, v, w, u, chunk=64),
                     "oracle_fp32": wkv6_ref(r, k, v, w, u)}
        print(json.dumps({"src": args.src, "forward": name, "rel_fro_vs_fp64": {
            p: {"o": rel(o, o64), "state": rel(st, s64)} for p, (o, st) in paths.items()}}),
            flush=True)
        del o64, s64, paths

    def chunked_grads(*ins):
        ins = [t.detach().requires_grad_() for t in ins]
        with torch.enable_grad():
            o, _ = rwkv.wkv_chunked(*ins, chunk=64)
            return torch.autograd.grad(o, ins, do)

    names = ("dr", "dk", "dv", "dw", "du")
    if hasattr(ops, "wkv6_bwd"):  # a tree with the backward kernel
        wkv6_bwd_ref = ref.wkv6_bwd_ref
        for name in ("init", "init_wide"):
            w = decays[name]
            exact = wkv6_bwd_ref(do.double(), None, r.double(), k.double(), v.double(),
                                 w.double(), u.double())
            paths = {"b3": ops.wkv6_bwd(do, None, r, k, v, w, u),
                     "wkv_chunked": chunked_grads(r, k, v, w, u),
                     "oracle_fp32": wkv6_bwd_ref(do, None, r, k, v, w, u)}
            print(json.dumps({"src": args.src, "backward": name, "rel_fro_vs_fp64": {
                p: {n: rel(g, x) for n, g, x in zip(names, got, exact)}
                for p, got in paths.items()}}), flush=True)
            del exact, paths
    del r, k, v, do, decays

    from repro_torch.data.pipeline import SyntheticLM

    cfg, shape, model, _, _ = cs.train_model(n_layers=cs.RWKV_TRAIN_DEPTH, arch=cs.RWKV_ARCH)
    params = model.init(torch.Generator(device="cuda").manual_seed(16))
    batch = {n: torch.from_numpy(x).cuda()
             for n, x in SyntheticLM(cfg.vocab_size, shape.seq_len, 1, seed=1).batch(0).items()}

    def loss_grads(mode):
        _, _, m, _, _ = cs.train_model(mode, "float32", cs.RWKV_TRAIN_DEPTH, cs.RWKV_ARCH)
        if not hasattr(ops, "wkv6_bwd"):  # a tree without the backward: the loss only
            with torch.no_grad():
                return float(m.loss(params, batch)), None
        from repro_torch.train.train_step import stack_grads, value_and_grad

        loss, g = value_and_grad(m, params, batch)
        return float(loss), stack_grads(g)

    l_k, g_k = loss_grads("kernel")
    l_r, g_r = loss_grads("reference")
    out = {"src": args.src, "model": "kernels against wkv_chunked",
           "loss_rel": abs(l_k - l_r) / abs(l_r)}
    if g_k is not None:
        out["grad_rel_fro"] = cs.leaf_gaps(g_k, g_r)
    print(json.dumps(out), flush=True)
    del g_r
    chunked = rwkv.wkv_chunked
    rwkv.wkv_chunked = lambda r, k, v, w, u, *, chunk=64: wkv6_ref(r, k, v, w, u)
    try:
        l_o, g_o = loss_grads("reference")
    finally:
        rwkv.wkv_chunked = chunked
    out = {"src": args.src, "model": "kernels against the plain path with the fp32 oracle's WKV",
           "loss_rel": abs(l_k - l_o) / abs(l_o)}
    if g_k is not None:
        out["grad_rel_fro"] = cs.leaf_gaps(g_k, g_o)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
