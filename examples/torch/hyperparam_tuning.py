"""Paper §5.2 live (the JAX package's ``examples/hyperparam_tuning.py`` on
the port): a hyper-parameter sweep PACKed onto one device.

Eight learning-rate candidates for the same smoke-scale model train
concurrently under the PACK policy; poor candidates are killed early
(the all-or-nothing property: makespan is what matters). Compare wall time
against sequential FIFO execution of the same sweep.

Run:  PYTHONPATH=src python examples/torch/hyperparam_tuning.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import GB, MB, MemoryProfile, SalusExecutor, VirtualDevice, get_policy
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import device as pick_device
from repro_torch.models import ModelOptions, build_model
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.train_step import make_train_step

LRS = [3e-2, 1e-2, 3e-3, 1e-3, 3e-4, 1e-4, 3e-5, 1e-5]
N_ITERS = 12


def make_candidate(lr: float, dev: torch.device):
    cfg = get_config("gemma-2b").smoke()
    model = build_model(cfg, ModelOptions(loss_chunk=8))
    opt = AdamW(AdamWConfig(lr=lr, warmup_steps=2, total_steps=N_ITERS))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = opt.init(params)
    pipe = SyntheticLM(cfg.vocab_size, 32, 4, seed=1)
    raw = make_train_step(model, opt)

    def step(state, batch):
        p, o = state
        p, o, m = raw(p, o, batch)
        return (p, o), m

    def data_fn(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(i).items()}

    return step, (params, opt_state), data_fn


def run_policy(policy_name: str, dev: torch.device):
    executor = SalusExecutor(capacity=4 * GB, policy=get_policy(policy_name), device=dev)
    vdev = VirtualDevice(executor)
    sessions = [
        vdev.create_session(
            f"lr={lr:g}", *make_candidate(lr, dev), n_iters=N_ITERS,
            profile=MemoryProfile(32 * MB, 200 * MB), utilization=0.4,
        )
        for lr in LRS
    ]
    t0 = time.perf_counter()
    vdev.run()
    return sessions, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = pick_device(ap.parse_args(argv).device)
    sessions, t_pack = run_policy("pack", dev)
    print(f"PACK makespan: {t_pack:.1f}s for {len(LRS)} candidates (one device)")
    best = min(sessions, key=lambda s: float(s.metrics_log[-1]["loss"]))
    for s in sessions:
        marker = " <== best" if s is best else ""
        print(f"  {s.name:10s} final loss {float(s.metrics_log[-1]['loss']):.4f}{marker}")
    _, t_fifo = run_policy("fifo", dev)
    print(f"FIFO makespan: {t_fifo:.1f}s; PACK/FIFO = {t_fifo/t_pack:.2f}x")
    return {"pack_s": t_pack, "fifo_s": t_fifo, "sessions": sessions}


if __name__ == "__main__":
    main()
