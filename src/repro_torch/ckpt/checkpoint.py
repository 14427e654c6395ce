"""Async, atomic checkpointing (the JAX package's ``ckpt/checkpoint.py``,
on the same disk layout, so each side reads the other's checkpoints).

Layout (per step):
    <dir>/step_000123.tmp/...   (written)
    <dir>/step_000123/          (atomic rename on completion)
        manifest.json           tree structure + shapes/dtypes + meta
        arr_00000.npy ...       one file per leaf (host-local full arrays)

Leaves are numbered in JAX's flattening order: dict keys sorted at every
level, sequences by index (``torch.utils._pytree`` keeps insertion order,
so the tree is sorted before it is flattened). A leaf's key is its path,
``"/"``-joined. ``None`` is an empty subtree, as in JAX.

bfloat16 leaves: JAX saves them as ``ml_dtypes`` arrays, which ``np.load``
gives back as 2-byte void arrays; the manifest's dtype says
``"bfloat16"``. The port writes a bf16 leaf as a 2-byte void view of its
bits (``np.load`` gives the same bytes back on either side) and reads
any leaf the manifest calls bfloat16 through ``uint16`` into
``torch.bfloat16``, bit for bit (the card has no ``ml_dtypes``).

``save`` copies every leaf to host memory before it returns: the port's
optimizer updates params and state in place, so a write that read the
live tensors later would store a later step. A ``DTensor`` leaf is
gathered with ``full_tensor()``, a collective: every rank of its mesh
calls ``save``, and rank 0 writes. With a process group of several ranks,
``wait`` is a collective too: every rank returns once rank 0's writes are
published, and rank 0's writer error is raised on every rank; and
``restore_tree`` is one, reading the step rank 0 picks (broadcast), so
no rank reads an older step, or one that rank 0's pruning is deleting.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch.dist.api import place

BF16 = "bfloat16"


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _sorted(tree):
    """The same tree with every dict's keys in sorted order (JAX's)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(x) for x in tree)
    return tree


def _flatten(tree) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` in JAX's leaf order, ``None`` leaves left out."""
    flat, _ = pytree.tree_flatten_with_path(_sorted(tree))
    return [(_key(path), leaf) for path, leaf in flat if leaf is not None]


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _from_rank0(value):
    """Rank 0's ``value`` on every rank of a group of several ranks (a
    collective: every rank calls it); ``value`` itself otherwise."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that nothing else aliases; bf16 as a 2-byte
    void view of its bits."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view("V2")
    return t.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    return BF16 if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded leaf (``np.load``'s, C-ordered) as a CPU tensor; ``dtype``
    is the manifest's."""
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._queue: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        # one record a published write: step, start and end
        # (time.perf_counter) and the bytes of its leaves
        self.writes: List[Dict] = []
        if async_save:
            self._thread = threading.Thread(target=self._writer_loop, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def save(self, step: int, tree, meta: Optional[Dict] = None) -> None:
        """Snapshot to host memory now (a copy); write to disk
        asynchronously. Rank 0 writes; every rank calls it."""
        if self._error:
            raise RuntimeError("checkpoint writer failed") from self._error
        writer = _rank() == 0
        host_items = []
        for k, v in _flatten(tree):
            if isinstance(v, DTensor):
                v = v.full_tensor()  # a collective: every rank gathers
            if writer:
                host_items.append((k, _host(v)))
        if not writer:
            return
        if self.async_save:
            self._queue.put((step, host_items, meta or {}))
        else:
            self._write(step, host_items, meta or {})

    def wait(self) -> None:
        """Block until all queued saves hit disk. With several ranks, every
        rank calls it and returns once rank 0's writes are published; rank
        0's writer error is raised on each."""
        if self.async_save:
            self._queue.join()
        error = _from_rank0(None if self._error is None else repr(self._error))
        if error is not None:
            raise RuntimeError(f"checkpoint writer failed on rank 0: {error}") from self._error

    def _writer_loop(self):
        while True:
            step, items, meta = self._queue.get()
            try:
                self._write(step, items, meta)
            except BaseException as e:  # surfaced on next save()/wait()
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step: int, items, meta: Dict) -> None:
        start = time.perf_counter()
        final = self._step_dir(step)
        tmp = final.with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "meta": meta, "leaves": []}
        for i, (key, arr) in enumerate(items):
            fname = f"arr_{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(arr.shape), "dtype": _dtype_name(arr)}
            )
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self.writes.append({"step": step, "start": start, "end": time.perf_counter(),
                            "bytes": sum(arr.nbytes for _, arr in items)})
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read(self, step: Optional[int]):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = {e["key"]: (np.load(d / e["file"]), e["dtype"]) for e in manifest["leaves"]}
        return step, leaves, manifest.get("meta", {})

    def restore(self, step: Optional[int] = None) -> Tuple[int, Dict[str, np.ndarray], Dict]:
        """Returns (step, {key: np.ndarray}, meta), as ``np.load`` reads
        each leaf (a bf16 leaf is a 2-byte void array, as in JAX)."""
        step, leaves, meta = self._read(step)
        return step, {k: arr for k, (arr, _) in leaves.items()}, meta

    def restore_tree(self, template, step: Optional[int] = None, shardings=None):
        """Restore into the structure of ``template`` (a tree of tensors,
        on any device, ``meta`` included), as CPU tensors of the
        template's dtypes. A stored leaf whose dtype differs is cast only
        between integer types (the optimizer's step counter: int32 in
        JAX's state, int64 in the port's); any other mismatch raises.
        With ``shardings`` (a tree of ``(DeviceMesh, placements)`` pairs,
        ``dist.sharding.param_shardings``' form), each leaf becomes a
        ``DTensor`` on its mesh: elastic resharding. With several ranks,
        every rank calls it and each reads the step rank 0 picks."""
        step = _from_rank0(self.latest_step() if step is None else step)
        step, leaves, meta = self._read(step)

        def one(path, tmpl):
            if tmpl is None:
                return None
            key = _key(path)
            if key not in leaves:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr, dtype = leaves[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(tmpl.shape)}")
            t = _to_tensor(arr, dtype)
            if t.dtype != tmpl.dtype:
                if t.dtype.is_floating_point or tmpl.dtype.is_floating_point:
                    raise ValueError(f"dtype mismatch for {key}: {dtype} vs {tmpl.dtype}")
                t = t.to(tmpl.dtype)
            return t

        tree = pytree.tree_map_with_path(one, template)
        if shardings is not None:
            tree = place(tree, shardings)
        return step, tree, meta
