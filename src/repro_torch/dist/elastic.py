"""Elastic scaling: restore a checkpoint onto a *different* mesh (the JAX
package's ``dist/elastic.py``).

Checkpoints store host-local full arrays (see ``ckpt/checkpoint.py``), so
a restore places each leaf with the target mesh's layouts — the sharding
rules recompute the layout for whatever mesh survives. An elastic
restart is a new launch: the survivors form a new process group, and
:func:`shrink_mesh` builds its mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.dist.sharding import param_shardings
from repro_torch.launch.mesh import make_mesh


def restore_on_mesh(
    mgr, template, cfg, mesh, step: Optional[int] = None
) -> Tuple[int, Any, Dict]:
    """Restore the latest (or ``step``) checkpoint from ``mgr`` into the
    structure of ``template`` (shapes and dtypes only: ``meta`` tensors
    will do), laid out for ``mesh``.

    Returns ``(step, tree, meta)`` — same contract as
    ``CheckpointManager.restore_tree``, with every leaf a ``DTensor`` on
    ``mesh`` per the param rules.
    """
    shardings = param_shardings(template, cfg, mesh)
    return mgr.restore_tree(template, step=step, shardings=shardings)


def shrink_mesh(shape: Sequence[int], axes: Sequence[str], lost: int, device_type: str):
    """New mesh after losing ``lost`` devices: the leading (data) axis
    absorbs the loss; trailing axes (model groups) stay intact.

    The surviving device count must still fill whole data-groups —
    otherwise the stranded remainder devices are dropped too. Called by
    the survivors' new launch, whose process group has the new mesh's
    ranks.
    """
    shape = tuple(int(s) for s in shape)
    total = 1
    for s in shape:
        total *= s
    rest = 1
    for s in shape[1:]:
        rest *= s
    remaining = total - int(lost)
    new_first = remaining // rest
    if new_first < 1:
        raise ValueError(
            f"cannot shrink mesh {shape}: {lost} lost leaves fewer than one "
            f"group of {rest} devices"
        )
    return make_mesh((new_first,) + shape[1:], tuple(axes), device_type)
