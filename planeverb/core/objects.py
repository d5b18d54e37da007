"""Game-object runtime: 3D objects auto-synced into the 2D solver slice.

The reference's engine-side per-frame component is PlaneverbObject
(/root/reference UnityDemo .../PlaneverbUnityPluginAPI/PlaneverbObject.cs):
every frame it merges its child collider bounds (GetMaxBounds, :184-192),
tests whether the merged box spans the listener's head height
(IsWithinPlayerHeadSlice, :194-200), and drives Add/Update/RemoveGeometry
accordingly (:93-118) — objects outside the head slice are culled from the
simulation entirely. CalculateAABB (:163-180) projects the surviving 3D box
onto the (x, z) solver plane, shaving SIZE_EPSILON so a box that exactly
abuts a cell boundary doesn't paint the extra row.

:class:`ObjectManager` is that component system as one registry: objects
hold world-space 3D bounds (one box or merged children) + a material, and
``sync()`` performs every object's per-frame Update against the context's
current listener height. Game loops call ``sync()`` once per frame (after
moving the listener); ``add``/``update`` sync their own object immediately.

Note the deliberate difference from :func:`planeverb.scene.
project_to_slice`: that helper imports a static 3D scene using a ±head_slice
*band* around the listener and keeps full extents; this runtime implements
the reference component's exact point-containment test and SIZE_EPSILON
shave (PlaneverbObject.cs:73,163-200) for per-frame object tracking.
"""

from __future__ import annotations

import dataclasses
import threading

from planeverb.config import material_r
from planeverb.scene import AABB, AABB3D, merge_bounds

__all__ = ["ObjectManager", "SIZE_EPSILON"]

SIZE_EPSILON = 0.01  # PlaneverbObject.cs:73 — shaved off projected extents


@dataclasses.dataclass
class _ObjectRecord:
    bounds: AABB3D
    gid: int | None = None       # geometry id while inside the head slice


class ObjectManager:
    """Tracks 3D game objects and mirrors the in-slice ones into the
    context's geometry registry (PlaneverbObject component system)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self._lock = threading.Lock()
        self._objects: dict[int, _ObjectRecord] = {}
        self._next = 0

    # -------------------------------------------------------------- objects
    def add(self, bounds, absorption: float | str | None = None) -> int:
        """Register an object. ``bounds`` is an AABB3D or an iterable of
        child-collider AABB3Ds (merged like GetMaxBounds,
        PlaneverbObject.cs:184-192). ``absorption`` is an R value or a
        material name from the 38-entry table (the reference's material
        enum -> coefficient mapping, PlaneverbObject.cs:203-244). Returns
        an object id (not a geometry id — the geometry binding tracks
        head-slice membership)."""
        box = self._merge(bounds, absorption)
        listener_y = self.ctx.get_listener_position()[1]
        with self._lock:
            oid = self._next
            self._next += 1
            rec = _ObjectRecord(bounds=box)
            self._objects[oid] = rec
            self._sync_record(rec, listener_y, {})
        return oid

    def update(self, oid: int, bounds,
               absorption: float | str | None = None) -> None:
        """Move/resize an object (the per-frame transform change path)."""
        box = self._merge(bounds, absorption)
        listener_y = self.ctx.get_listener_position()[1]
        with self._lock:
            rec = self._objects.get(oid)
            if rec is None:
                raise KeyError(f"no object id {oid}")
            rec.bounds = box
            # per-object sync: M moving objects per frame cost O(M), not
            # O(M*N); listener moves re-test everything via sync()
            self._sync_record(rec, listener_y, {})

    def remove(self, oid: int) -> None:
        """OnDestroy analog (PlaneverbObject.cs:157-163)."""
        with self._lock:
            rec = self._objects.pop(oid, None)
        if rec is not None and rec.gid is not None:
            self.ctx.geometry.remove(rec.gid)

    def get_bounds(self, oid: int) -> AABB3D | None:
        with self._lock:
            rec = self._objects.get(oid)
            return rec.bounds if rec is not None else None

    def in_head_slice(self, oid: int) -> bool:
        with self._lock:
            rec = self._objects.get(oid)
            return rec is not None and rec.gid is not None

    # ------------------------------------------------------------ per frame
    def sync(self) -> dict:
        """Every object's per-frame Update (PlaneverbObject.cs:93-118):
        in-slice objects are added/updated in the geometry registry,
        out-of-slice ones removed. Returns {"added": n, "updated": n,
        "removed": n, "culled": n}."""
        _, listener_y, _ = self.ctx.get_listener_position()
        stats = {"added": 0, "updated": 0, "removed": 0, "culled": 0}
        with self._lock:
            for rec in self._objects.values():
                self._sync_record(rec, listener_y, stats)
        return stats

    def _sync_record(self, rec: _ObjectRecord, listener_y: float,
                     stats: dict) -> None:
        """One object's Update body (caller holds the lock)."""
        b = rec.bounds
        spans = (b.y - b.height * 0.5 <= listener_y
                 <= b.y + b.height * 0.5)
        if spans:
            box = AABB(b.x, b.z,
                       max(b.width - SIZE_EPSILON, 0.0),
                       max(b.depth - SIZE_EPSILON, 0.0),
                       b.absorption)
            if rec.gid is None:
                rec.gid = self.ctx.geometry.add(box)
                stats["added"] = stats.get("added", 0) + 1
            else:
                self.ctx.geometry.update(rec.gid, box)
                stats["updated"] = stats.get("updated", 0) + 1
        elif rec.gid is not None:
            self.ctx.geometry.remove(rec.gid)
            rec.gid = None
            stats["removed"] = stats.get("removed", 0) + 1
        else:
            stats["culled"] = stats.get("culled", 0) + 1

    @staticmethod
    def _merge(bounds, absorption: float | str | None) -> AABB3D:
        if absorption is not None:
            absorption = material_r(absorption)
        if isinstance(bounds, AABB3D):
            if absorption is not None:
                bounds = dataclasses.replace(bounds, absorption=absorption)
            return bounds
        return merge_bounds(bounds, absorption)
