"""One rank's work, counted op by op as a program runs on fake tensors:
the dry run's counter (``launch/dryrun.py``). It is the port's
counterpart of the JAX package's ``launch/hlo_flops.py::analyze_hlo`` /
``CostReport`` and ``launch/hlo_analysis.py::parse_collectives`` /
``CollectiveStats``: PyTorch runs eagerly, so a dispatch mode sees every
aten op as it runs, where JAX parses the compiled HLO.

* FLOPs: a product ``2 |out| contracted`` (``torch.utils.flop_counter``'s
  formulas, ``hlo_flops.py::_dot_flops``'s rule); the elementwise ops of
  ``hlo_flops.py``'s ``ELEMENTWISE`` set ``|out|`` each.
* HBM bytes: every op that is no view reads its inputs and writes its
  outputs once (in eager mode each is a kernel of its own); a gather reads
  and writes its output's size, a scatter or copy twice what it writes, as
  ``hlo_flops.py`` counts them. Not XLA's fusion-boundary count.
* Collectives by kind, their operand bytes (the raw ``c10d`` calls and
  DTensor's functional collectives alike).
* Peak live bytes: each storage counts from the op that creates it until
  it dies; ``track`` counts a tree's storages (the arguments) as live.
* Kernels: a wrapper's fake call charges its kernel's ``cost``
  (``kernels/_build.py::charge``) as operations, bytes and one launch.

``times(counter, n)`` scales what is counted inside it by ``n`` (a loop
body run once for ``n`` trips); live bytes are never scaled.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

ELEMENTWISE = set("add sub mul div pow maximum minimum exp log tanh sqrt rsqrt neg abs sigmoid "
                  "expm1 cos sin floor ceil round sign atan2 remainder".split())
GATHERS = {"index", "index_select", "gather", "embedding"}
SCATTERS = {"index_put", "scatter", "scatter_add", "index_add", "index_copy", "copy"}
NO_TRAFFIC = {"empty", "empty_like", "new_empty", "empty_strided", "wait_tensor", "_unsafe_view"}
# op -> kind; a c10d op's operand is its second argument, all-reduce's its first
COLLECTIVES = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
}


class OpCounter(TorchDispatchMode):
    """The counts: ``flops``, ``hbm_bytes``, ``flops_by_op``,
    ``collective_counts`` and ``collective_bytes`` by kind, ``kernels``
    (name -> launches, ops, bytes), ``peak`` live bytes."""

    def __init__(self):
        super().__init__()
        self.flops = self.hbm_bytes = self.live = self.peak = 0
        self.flops_by_op, self.collective_counts = Counter(), Counter()
        self.collective_bytes = Counter()
        self.kernels, self.sizes, self.scale = {}, {}, 1

    def __enter__(self):
        _build.counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.counters.remove(self)
        return super().__exit__(*exc)

    def kernel(self, name: str, ops: float, nbytes: float) -> None:
        n = self.scale
        self.kernels.setdefault(name, Counter()).update(launches=n, ops=ops * n, bytes=nbytes * n)
        self.flops += ops * n
        self.hbm_bytes += nbytes * n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        _tally(self, func, args, kwargs or {}, out)
        return out


@contextlib.contextmanager
def times(counter: OpCounter, n: int):
    counter.scale *= n
    try:
        yield counter
    finally:
        counter.scale //= n


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def track(c: OpCounter, tree) -> dict:
    """Count the storages of ``tree``'s tensors (a ``DTensor``'s local
    piece; none on the meta device) as live from now until each dies;
    returns ``{storage: bytes}`` of them all, counted before or not."""
    out = {}
    for t in _tensors(tree):
        if t.device.type == "meta":  # shapes only (a layout's template): no bytes
            continue
        st = getattr(t, "_local_tensor", t).untyped_storage()
        if st._cdata not in c.sizes:
            c.sizes[st._cdata] = st.nbytes()
            c.live += st.nbytes()
            c.peak = max(c.peak, c.live)
            weakref.finalize(st, _free, c, st._cdata)
        out[st._cdata] = c.sizes[st._cdata]
    return out


def _free(c: OpCounter, key) -> None:
    c.live -= c.sizes.pop(key)


def _tally(c: OpCounter, func, args, kwargs, out) -> None:
    name, n, outs = func._overloadpacket.__name__, c.scale, _tensors(out)
    track(c, outs)
    kind, base = COLLECTIVES.get(name), name.rstrip("_")
    if outs and outs[0].device.type == "meta":
        return
    if kind:
        operand = args[1 if func.namespace == "c10d" and kind != "all-reduce" else 0]
        c.collective_counts[kind] += n
        c.collective_bytes[kind] += n * _nbytes(operand)
        return
    formula = flop_registry.get(func._overloadpacket)
    if formula:
        flops = formula(*args, **kwargs, out_val=out)
    else:
        flops = outs[0].numel() if base in ELEMENTWISE and outs else 0
    if flops:
        c.flops += n * flops
        c.flops_by_op[name] += n * flops
    if not outs or func.is_view or name in NO_TRAFFIC:
        return
    if base in GATHERS:
        c.hbm_bytes += n * 2 * _nbytes(outs)
    elif base in SCATTERS:
        c.hbm_bytes += n * 2 * _nbytes(args[1:])
    else:
        c.hbm_bytes += n * _nbytes((args, kwargs, outs))
