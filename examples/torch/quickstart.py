"""Quickstart (the JAX package's ``examples/quickstart.py`` on the port):
the two Salus primitives in ~60 lines.

1. FAST JOB SWITCHING — two training jobs time-share the device at
   iteration granularity; params stay resident, switching moves zero bytes.
2. MEMORY SHARING (GPU lanes) — admission through Algorithm 1's safety
   condition; a too-big third job queues until a lane frees up.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import GB, MB, MemoryProfile, SalusExecutor, VirtualDevice, get_policy
from repro_torch.device import device as pick_device


def make_training_job(seed: int, dev: torch.device, d: int = 128):
    """A real (tiny) PyTorch training job: linear regression, its data
    drawn from explicit generators."""
    w_true = torch.randn(d, 1, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)

    def data_fn(i):
        gen = torch.Generator(device=dev).manual_seed(seed * 997 + i)
        x = torch.randn(64, d, generator=gen, device=dev)
        return x, x @ w_true

    def step(w, batch):
        x, y = batch
        w = w.detach().requires_grad_()
        loss = torch.mean((x @ w - y) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        return (w - 0.05 * g).detach(), {"loss": loss.detach()}

    w0 = torch.zeros(d, 1, device=dev)
    return step, w0, data_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = pick_device(ap.parse_args(argv).device)

    # The executor owns the device; FAIR equalizes service across jobs.
    executor = SalusExecutor(capacity=1 * GB, policy=get_policy("fair"), device=dev)
    vdev = VirtualDevice(executor)

    # Sessions = paper's (1a) create + (1b) lane request. Profiles here are
    # given explicitly; the adaptor can also measure them by running one
    # step (profiles.profile_step), or a model's (profiles.profile_model).
    a = vdev.create_session("job-a", *make_training_job(1, dev), n_iters=20,
                            profile=MemoryProfile(4 * MB, 400 * MB))
    b = vdev.create_session("job-b", *make_training_job(2, dev), n_iters=20,
                            profile=MemoryProfile(4 * MB, 400 * MB))
    big = vdev.create_session("job-big", *make_training_job(3, dev), n_iters=5,
                              profile=MemoryProfile(8 * MB, 900 * MB))
    print(f"lanes: {executor.registry.stats()['n_lanes']}, "
          f"queued: {executor.registry.stats()['queued']} (job-big waits for memory)")

    report = vdev.run()  # (2a/2b) iterations scheduled per policy

    for sess in (a, b, big):
        st = report.stats[sess.job.job_id]
        print(
            f"{sess.name}: {st.iterations_done} iters, "
            f"JCT {st.jct:.2f}s, queued {st.queuing:.2f}s, "
            f"final loss {float(sess.metrics_log[-1]['loss']):.4f}"
        )
    print(f"switches: {len(report.switch_latencies)} "
          f"(persistent memory stayed on-device for every one of them)")
    return report


if __name__ == "__main__":
    main()
