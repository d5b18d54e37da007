"""Device mesh construction and grid padding for spatial sharding."""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["grid_mesh", "mesh_from_count", "pad_to_mesh", "factor_mesh"]


def factor_mesh(n: int) -> tuple[int, int]:
    """Split n devices into the most-square (mx, my) factorization.

    A square-ish mesh minimizes halo perimeter per shard (the per-step
    ppermute payload is proportional to the shard boundary length).
    """
    best = (1, n)
    for mx in range(1, int(math.isqrt(n)) + 1):
        if n % mx == 0:
            best = (mx, n // mx)
    return best


def grid_mesh(devices=None, shape: tuple[int, int] | None = None) -> Mesh:
    """Build a 2D ("x", "y") mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = factor_mesh(n)
    mx, my = shape
    if mx * my != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.asarray(devices).reshape(mx, my)
    return Mesh(arr, ("x", "y"))


def mesh_from_count(n_devices: int) -> Mesh:
    """Most-square 2D mesh over the first ``n_devices`` available devices.

    The one validation + construction path behind every user-facing
    "--mesh N" knob (server init, viewer, CLI); raises ``ValueError`` when
    the host has fewer devices than requested.
    """
    devices = jax.devices()
    if n_devices > len(devices):
        raise ValueError(f"mesh wants {n_devices} devices, "
                         f"only {len(devices)} available")
    return grid_mesh(devices[:n_devices])


def pad_to_mesh(nx: int, ny: int, mesh: Mesh) -> tuple[int, int]:
    """Padded field dims divisible by the mesh.

    Padding cells carry beta = 0 (solid), so they never develop pressure and
    the padded solve is exactly the unpadded solve on the real region.
    """
    mx = mesh.shape["x"]
    my = mesh.shape["y"]
    return (-(-nx // mx) * mx, -(-ny // my) * my)
