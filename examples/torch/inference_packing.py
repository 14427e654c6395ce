"""Paper §5.3 live (the JAX package's ``examples/inference_packing.py`` on
the port): pack many DL inference services onto ONE device.

Builds smoke-scale instances of several assigned architectures, measures
their memory profiles by running one serving step each, admits them
through the lane manager, and serves interleaved request batches — then
prints the device count a no-sharing deployment would need.

Each service's params are drawn from a generator seeded by ``zlib.crc32``
of its ``(name, instance)``, where the JAX example takes the builtin
``hash``, which Python salts per process: the port's services are the
same from run to run. Requests run under ``torch.no_grad()`` (rwkv's WKV6
kernel has a forward only).

Run:  PYTHONPATH=src python examples/torch/inference_packing.py [--device cpu]
"""
import argparse
import time
import zlib

import torch

from repro_torch.configs import get_config
from repro_torch.core import GB, SalusExecutor, VirtualDevice, get_policy
from repro_torch.device import device as pick_device
from repro_torch.models import ModelOptions, build_model

ARCHS = ["gemma-2b", "qwen3-8b", "rwkv6-7b", "hymba-1.5b", "musicgen-medium", "qwen1.5-32b"]
INSTANCES = 2  # per model
REQUESTS = 12


def service_seed(name: str, inst: int) -> int:
    return zlib.crc32(repr((name, inst)).encode("utf-8")) % 2**31


def make_service(name: str, inst: int, dev: torch.device):
    cfg = get_config(name).smoke()
    model = build_model(cfg, ModelOptions(loss_chunk=8, moe_group=16,
                                          wkv_chunk=8, ssm_chunk=8))
    params = model.init(torch.Generator(device=dev).manual_seed(service_seed(name, inst)))

    @torch.no_grad()
    def handle(state, request):
        logits, _ = model.prefill(state, request, max_len=32)
        return state, {"next": torch.argmax(logits, -1)}

    def data_fn(i):
        gen = torch.Generator(device=dev).manual_seed(i * 7 + inst)
        if cfg.frontend == "audio_frames":
            x = torch.randn(2, 16, cfg.d_model, generator=gen, device=dev)
            return {"frame_embeds": x.to(torch.bfloat16)}
        return {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=dev)}

    return handle, params, data_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = pick_device(ap.parse_args(argv).device)
    executor = SalusExecutor(capacity=4 * GB, policy=get_policy("pack"), device=dev)
    vdev = VirtualDevice(executor)
    services = []
    for name in ARCHS:
        for inst in range(INSTANCES):
            # profile measured by the adaptor (runs one step)
            services.append(
                vdev.create_session(
                    f"{name}#{inst}", *make_service(name, inst, dev),
                    n_iters=REQUESTS, kind="inference", utilization=0.2,
                )
            )
    st = executor.registry.stats()
    n = len(services)
    print(f"packed {n - st['queued']}/{n} services into ONE device "
          f"({st['n_lanes']} lanes, {st['persistent_used']/2**20:.0f} MiB persistent, "
          f"{st['free']/2**30:.2f} GiB free)")
    print(f"no-sharing deployment would need {n} devices -> "
          f"{n / max(1, 1 + (1 if st['queued'] else 0))}x fewer here")

    t0 = time.perf_counter()
    report = vdev.run()
    dt = time.perf_counter() - t0
    done = sum(s.iterations_done for s in report.stats.values())
    print(f"served {done} requests in {dt:.1f}s; per-service mean latency:")
    for sess in services[:6]:
        s = report.stats[sess.job.job_id]
        if s.iterations_done:
            print(f"  {sess.name:22s} {s.service_time/s.iterations_done*1e3:7.1f} ms/req")
    return {"packed": n - st["queued"], "services": n, "requests": done, "wall_s": dt,
            "report": report, "sessions": services}


if __name__ == "__main__":
    main()
