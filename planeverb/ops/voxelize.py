"""AABB voxelization: scene geometry -> (beta, reflection) fields.

Vectorized re-design of the reference's per-cell paint loops
(Grid.cpp:136-296). Instead of imperatively painting and un-painting boxes
(the reference's RemoveAABB restores free space even under overlapping boxes
— a known quirk), we *rebuild* the fields from the full box set with one
vectorized pass: boolean masks from box corner indices, folded in paint order
so overlapping boxes last-wins exactly like sequential AddAABB calls.

Cell flag semantics (Grid.cpp:88-113): interior cells are air (beta=1); the
last row (x == grid_x) and last column (y == grid_y) of the extended
staggered grid are non-air (beta=0); boxes force beta=0 and set the
reflection coefficient R.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from planeverb.config import GridParams

__all__ = ["base_fields", "voxelize", "voxelize_np", "boxes_to_array"]


def base_fields(params: GridParams) -> tuple[np.ndarray, np.ndarray]:
    """Empty-scene (beta, reflection) as numpy [nx, ny] float32."""
    nx, ny = params.nx, params.ny
    beta = np.ones((nx, ny), np.float32)
    beta[params.grid_x, :] = 0.0
    beta[:, params.grid_y] = 0.0
    reflection = np.zeros((nx, ny), np.float32)  # free space R = 0
    return beta, reflection


def boxes_to_array(boxes, max_boxes: int | None = None) -> np.ndarray:
    """Pack AABBs into a [B, 5] float32 array (x, y, w, h, R).

    Padded rows use zero width/height, which rasterize to an empty cell range.
    """
    n = len(boxes)
    b = max_boxes if max_boxes is not None else max(n, 1)
    out = np.zeros((b, 5), np.float32)
    for i, box in enumerate(boxes):
        out[i] = (box.x, box.y, box.width, box.height, box.absorption)
    return out


def _box_mask(params: GridParams, box_row, ix, iy):
    """Cell coverage mask for one box, truncation semantics per AddAABB
    (Grid.cpp:229-246): cells [start, end) per axis, int-truncated corners."""
    x, y, w, h, _ = (box_row[0], box_row[1], box_row[2], box_row[3], box_row[4])
    inv_dx = jnp.float32(1.0) / jnp.float32(params.dx)
    offx = jnp.float32(params.grid_offset_x)
    offy = jnp.float32(params.grid_offset_y)
    start_x = ((x - w * 0.5 + offx) * inv_dx).astype(jnp.int32)
    end_x = ((x + w * 0.5 + offx) * inv_dx).astype(jnp.int32)
    start_y = ((y - h * 0.5 + offy) * inv_dx).astype(jnp.int32)
    end_y = ((y + h * 0.5 + offy) * inv_dx).astype(jnp.int32)
    return ((ix >= start_x) & (ix < end_x) & (iy >= start_y) & (iy < end_y))


@functools.partial(jax.jit, static_argnames=("params",))
def voxelize(params: GridParams, boxes: jax.Array):
    """Rasterize a [B, 5] box array into (beta, reflection) [nx, ny] fields.

    Boxes are folded in order so overlaps resolve last-wins, matching
    sequential AddAABB paint order.
    """
    nx, ny = params.nx, params.ny
    ix = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 0)
    iy = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 1)

    beta0 = jnp.ones((nx, ny), jnp.float32)
    beta0 = beta0.at[params.grid_x, :].set(0.0)
    beta0 = beta0.at[:, params.grid_y].set(0.0)
    refl0 = jnp.zeros((nx, ny), jnp.float32)

    def paint(carry, box_row):
        beta, refl = carry
        m = _box_mask(params, box_row, ix, iy)
        beta = jnp.where(m, 0.0, beta)
        refl = jnp.where(m, box_row[4], refl)
        return (beta, refl), None

    (beta, refl), _ = jax.lax.scan(paint, (beta0, refl0), boxes)
    return beta, refl


def voxelize_np(params: GridParams, boxes) -> tuple[np.ndarray, np.ndarray]:
    """Host-side numpy rasterization (same semantics), for tests/tools."""
    beta, refl = base_fields(params)
    inv_dx = np.float32(1.0) / np.float32(params.dx)
    for box in boxes:
        sx = int(np.float32(box.x - box.width * 0.5 + params.grid_offset_x) * inv_dx)
        ex = int(np.float32(box.x + box.width * 0.5 + params.grid_offset_x) * inv_dx)
        sy = int(np.float32(box.y - box.height * 0.5 + params.grid_offset_y) * inv_dx)
        ey = int(np.float32(box.y + box.height * 0.5 + params.grid_offset_y) * inv_dx)
        sx_c, ex_c = max(sx, 0), min(ex, params.grid_x + 1)
        sy_c, ey_c = max(sy, 0), min(ey, params.grid_y + 1)
        if sx_c < ex_c and sy_c < ey_c:
            beta[sx_c:ex_c, sy_c:ey_c] = 0.0
            refl[sx_c:ex_c, sy_c:ey_c] = np.float32(box.absorption)
    return beta, refl
