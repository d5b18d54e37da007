"""Multi-host bring-up: jax.distributed init + host-aware mesh layout.

The reference engine is single-process with zero networking (SURVEY.md §2);
scaling across hosts is a new capability. Two concerns live here:

1. ``init_distributed`` — one-call wrapper over ``jax.distributed.initialize``
   so every host joins the same runtime (coordinator discovery via explicit
   args or the standard env/cluster autodetection).

2. ``multihost_grid_mesh`` — a 2D ("x", "y") device mesh in which **each
   process's devices form a contiguous block of mesh rows**. The sharded
   solver (parallel/solver.py) exchanges halos along both axes with
   ``lax.ppermute``; with this layout every y-neighbor pair and all but the
   block-boundary x-neighbor pairs are same-process (the fast intra-host
   links), so exactly one slab per exchange per host boundary crosses the
   host network — the minimum possible for a 2D decomposition.
   ``simulate_sharded_wide(halo=k)`` amortizes that hop over k steps.
"""

from __future__ import annotations

import math

import numpy as np
from jax.sharding import Mesh

from planeverb.parallel.mesh import factor_mesh

__all__ = ["init_distributed", "multihost_grid_mesh", "layout_by_process"]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the multi-host JAX runtime. Call once per process before any
    device use. No-op when already initialized or explicitly single-process.

    With no arguments, relies on JAX's cluster auto-detection (a cluster
    manager's environment); pass explicit values for bare clusters.
    """
    if num_processes == 1:
        return
    import jax

    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:  # already initialized: idempotent bring-up
        if "already" not in str(e).lower():
            raise


def layout_by_process(devices, shape: tuple[int, int] | None = None):
    """Arrange devices into a [mx, my] grid, rows grouped by process.

    Devices are bucketed by ``.process_index``; each process's bucket is
    reshaped to an (a, my) block and the blocks are stacked along x, so the
    mesh's y-axis never crosses a process boundary. Returns a numpy object
    array ready for ``jax.sharding.Mesh``.

    With one process this reduces to the most-square factorization
    (mesh.factor_mesh). ``shape`` overrides the global (mx, my) but must
    keep per-process blocks contiguous: my must divide the per-process
    device count.
    """
    devices = list(devices)
    n = len(devices)
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(int(getattr(d, "process_index", 0)), []).append(d)
    nproc = len(by_proc)
    local = n // nproc
    if any(len(v) != local for v in by_proc.values()):
        raise ValueError("uneven devices per process: "
                         f"{ {k: len(v) for k, v in by_proc.items()} }")

    if shape is None:
        if nproc == 1:
            shape = factor_mesh(n)
        else:
            # most-square local block; hosts stack along x
            a, my = factor_mesh(local)
            shape = (nproc * a, my)
    mx, my = shape
    if mx * my != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if local % my != 0:
        raise ValueError(
            f"shape {shape}: y-extent {my} does not divide the per-process "
            f"device count {local}; y-axis halos would cross host "
            f"boundaries")

    rows = []
    for pid in sorted(by_proc):
        block = np.asarray(by_proc[pid], dtype=object).reshape(local // my, my)
        rows.append(block)
    return np.concatenate(rows, axis=0)


def multihost_grid_mesh(shape: tuple[int, int] | None = None) -> Mesh:
    """2D ("x", "y") mesh over all *global* devices, process-contiguous
    (see layout_by_process). Use instead of mesh.grid_mesh on multi-host."""
    import jax

    return Mesh(layout_by_process(jax.devices(), shape), ("x", "y"))
