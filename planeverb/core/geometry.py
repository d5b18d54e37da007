"""Geometry registry: thread-safe AABB set with versioning.

Analog of /root/reference ProjectPlaneverb/src/Geometry/GeometryManager.cpp.
The reference queues {Add|Remove} deltas behind a mutex and drains them into
imperative grid paints at the sim sync point (GeometryManager.cpp:123-152);
un-painting restores free space even under overlaps (a tolerated bug,
Grid.cpp:249-296). Here the registry keeps the authoritative box set and a
monotonically increasing version; the engine re-rasterizes the whole field
set (one vectorized pass, ops/voxelize.py) whenever the version changes —
idempotent, order-preserving, and race-free by snapshot.
"""

from __future__ import annotations

import threading

from planeverb.scene import AABB, Scene

__all__ = ["GeometryRegistry"]


class GeometryRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._boxes: dict[int, AABB] = {}
        self._order: list[int] = []   # paint order = insertion order
        self._free: list[int] = []
        self._next = 0
        self._version = 0

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def add(self, box: AABB) -> int:
        with self._lock:
            if self._free:
                gid = self._free.pop()
            else:
                gid = self._next
                self._next += 1
            self._boxes[gid] = box
            self._order.append(gid)
            self._version += 1
            return gid

    def update(self, gid: int, box: AABB) -> None:
        with self._lock:
            if gid in self._boxes:
                self._boxes[gid] = box
                self._version += 1

    def remove(self, gid: int) -> None:
        with self._lock:
            if gid in self._boxes:
                del self._boxes[gid]
                self._order.remove(gid)
                self._free.append(gid)
                self._version += 1

    def get(self, gid: int) -> AABB | None:
        with self._lock:
            return self._boxes.get(gid)

    def snapshot(self) -> tuple[int, list[AABB]]:
        """Returns (version, boxes in paint order)."""
        with self._lock:
            return self._version, [self._boxes[g] for g in self._order]

    def items(self) -> list[tuple[int, AABB]]:
        """(gid, box) pairs in paint order."""
        with self._lock:
            return [(g, self._boxes[g]) for g in self._order]

    def free_ids(self) -> list[int]:
        """The free-list stack, oldest-freed first (top = last element)."""
        with self._lock:
            return list(self._free)

    def restore(self, items: list[tuple[int, AABB]],
                free: list[int] | None = None) -> None:
        """Replace contents with explicit (gid, box) pairs in paint order,
        preserving ids (session checkpoint/resume, planeverb.session).

        ``free`` restores the free-list stack order so id reuse after resume
        matches the uncheckpointed session; without it, freed ids are reused
        in ascending order.
        """
        with self._lock:
            self._boxes = {gid: box for gid, box in items}
            self._order = [gid for gid, _ in items]
            self._next = max(self._boxes, default=-1) + 1
            holes = {g for g in range(self._next) if g not in self._boxes}
            if free is not None and set(free) == holes:
                self._free = list(free)
            else:
                self._free = sorted(holes)
            self._version += 1

    def load_scene(self, scene: Scene) -> list[int]:
        return [self.add(b) for b in scene]

    def clear(self) -> None:
        with self._lock:
            self._boxes.clear()
            self._order.clear()
            self._free.clear()
            self._version += 1
