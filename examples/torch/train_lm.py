"""End-to-end example (the JAX package's ``examples/train_lm.py`` on the
port): train a ~100M-param qwen3-family model for a few hundred steps on
the synthetic Markov LM stream, with checkpointing and straggler
monitoring — the full production loop at laptop scale.

Run:  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] [--device cpu]

On the card by default; ``--device cpu`` runs it on the CPU (there is no
fallback). The checkpoints go to ``--ckpt-dir``, by default a directory
in the temporary directory; a second run there resumes from its latest
step.
"""
import argparse
import os
import tempfile
import time
from dataclasses import replace

import torch
from torch.utils import _pytree as pytree

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import device as pick_device
from repro_torch.dist.fault import StragglerMonitor
from repro_torch.models import ModelOptions, build_model
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.train_step import TrainRunConfig, make_train_step


def hundred_m_config():
    """qwen3-style ~100M: 16L x 512d x 8H, d_ff 2048, vocab 32k."""
    return replace(
        get_config("qwen3-8b"),
        name="qwen3-100m",
        n_layers=16,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=32_000,
    )


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def train(cfg, args) -> float:
    """The loop on ``cfg``: returns the last step's loss."""
    dev = pick_device(args.device)
    model = build_model(cfg, ModelOptions(loss_chunk=128))
    opt = AdamW(AdamWConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = opt.init(params)
    pipe = SyntheticLM(cfg.vocab_size, args.seq_len, args.batch, seed=0)
    step_fn = make_train_step(model, opt, TrainRunConfig(num_microbatches=2))
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    monitor = StragglerMonitor()

    start = mgr.latest_step() or 0
    if start:
        _, tree, _ = mgr.restore_tree({"params": params, "opt": opt_state})
        on_dev = lambda t: pytree.tree_map(lambda x: x.to(dev), t)
        params, opt_state = on_dev(tree["params"]), on_dev(tree["opt"])
        print(f"resumed from step {start}")

    loss = float("nan")
    t_begin = time.perf_counter()
    for i in range(start, args.steps):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(i).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        monitor.observe(i, time.perf_counter() - t0)
        if i % 20 == 0:
            tok_s = args.batch * args.seq_len / (time.perf_counter() - t0)
            print(f"step {i:4d}  loss {loss:.4f}  lr {float(metrics['lr']):.2e}  "
                  f"{tok_s/1e3:.1f}k tok/s")
        if (i + 1) % 100 == 0:
            mgr.save(i + 1, {"params": params, "opt": opt_state})
    mgr.save(args.steps, {"params": params, "opt": opt_state})
    mgr.wait()
    dt = time.perf_counter() - t_begin
    print(f"done: {args.steps - start} steps in {dt:.0f}s, "
          f"final loss {loss:.4f}, stragglers {len(monitor.flagged)}")
    return loss


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = hundred_m_config()
    print(f"arch {cfg.name}: {cfg.param_count()/1e6:.0f}M params")
    loss = train(cfg, args)
    assert loss < 4.0, "model failed to learn the synthetic stream"
    return loss


if __name__ == "__main__":
    main()
