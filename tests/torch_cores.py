"""The port's CPU tests under pytest-xdist (``-n N``): each worker is a
process of its own, and torch gives each one an intra-op thread pool of
one thread a core, so N workers run N pools of all the cores at once and
oversubscribe the machine. ``share_cores()`` gives each worker's torch
its share of the cores (at least one thread).

A worker also collects every test file, so its heap holds torch, JAX and
both packages: a few hundred thousand objects that each full garbage
collection walks again, 0.1-0.8 s a pause. Such a pause inside a test's
wall-clock window (a JCT band, a serving window) fails it.
``share_cores()`` therefore freezes what has been allocated so far
(``gc.freeze``): later full collections skip it. Outside xdist it does
nothing, and a file run alone keeps every core."""
import gc
import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
        gc.freeze()
