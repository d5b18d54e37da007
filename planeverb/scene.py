"""Scene representation: AABB geometry, .pv file I/O, and demo scenes.

  - ``AABB``           mirrors reference PvMathTypes.h:34-49 (position is the
                       box center; width along x, height along y/z-plane).
  - ``load_pv/save_pv``mirrors the sandbox text format (Editor.cpp:219-281):
                       first line = count, then ``id x y width height absorption``
                       per line. ``absorption`` is the reflection coefficient R.
  - demo scene constructors reproduce the bundled .pv assets' geometry so the
    test suite has known-answer scenes without shipping copied data files.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Iterable

__all__ = ["AABB", "AABB3D", "Scene", "load_pv", "loads_pv", "save_pv",
           "DEMO_SCENES", "demo_scene", "project_to_slice"]


@dataclasses.dataclass(frozen=True)
class AABB:
    """Axis-aligned box: center position, extents, reflection coefficient R."""

    x: float
    y: float
    width: float
    height: float
    absorption: float  # reflection coefficient R = sqrt(1 - energy absorption)


@dataclasses.dataclass(frozen=True)
class AABB3D:
    """A world-space 3D box (game-engine collider bounds).

    The simulation is a horizontal 2D slice; 3D geometry enters it via
    :func:`project_to_slice`. Center (x, y, z) with y up; full extents.
    """

    x: float
    y: float
    z: float
    width: float    # x extent
    height: float   # y extent (vertical)
    depth: float    # z extent
    absorption: float = 0.989949494


def merge_bounds(boxes, absorption: float | None = None) -> AABB3D:
    """Merge child collider bounds into one enclosing AABB3D — the per-object
    bounds computation of the reference's PlaneverbObject.GetMaxBounds
    (UnityDemo PlaneverbObject.cs:184-192), which encapsulates every child
    collider before registering the object with the engine.

    ``absorption`` overrides the merged box's material; default is the first
    child's.
    """
    boxes = list(boxes)
    if not boxes:
        raise ValueError("merge_bounds needs at least one box")
    lox = min(b.x - b.width * 0.5 for b in boxes)
    hix = max(b.x + b.width * 0.5 for b in boxes)
    loy = min(b.y - b.height * 0.5 for b in boxes)
    hiy = max(b.y + b.height * 0.5 for b in boxes)
    loz = min(b.z - b.depth * 0.5 for b in boxes)
    hiz = max(b.z + b.depth * 0.5 for b in boxes)
    return AABB3D(x=(lox + hix) * 0.5, y=(loy + hiy) * 0.5,
                  z=(loz + hiz) * 0.5, width=hix - lox, height=hiy - loy,
                  depth=hiz - loz,
                  absorption=(boxes[0].absorption if absorption is None
                              else absorption))


def project_to_slice(boxes, listener_y: float,
                     head_slice: float = 0.5) -> Scene:
    """Head-slice culling: 3D boxes -> the 2D scene at the listener's ears.

    A box enters the simulation only if its vertical extent spans the
    listener's head slice [listener_y - head_slice, listener_y + head_slice]
    — the reference's PlaneverbObject.IsWithinPlayerHeadSlice behavior
    (UnityDemo PlaneverbObject.cs:194-200); surviving boxes project to 2D
    AABBs on the (x, z) plane.
    """
    lo = listener_y - head_slice
    hi = listener_y + head_slice
    out = []
    for b in boxes:
        top = b.y + b.height * 0.5
        bottom = b.y - b.height * 0.5
        if bottom <= hi and top >= lo:
            out.append(AABB(b.x, b.z, b.width, b.depth, b.absorption))
    return Scene(boxes=out, name="head-slice")


@dataclasses.dataclass
class Scene:
    """An ordered collection of AABBs (paint order matters for overlaps)."""

    boxes: list[AABB] = dataclasses.field(default_factory=list)
    name: str = ""

    def __iter__(self):
        return iter(self.boxes)

    def __len__(self):
        return len(self.boxes)


def loads_pv(text: str, name: str = "") -> Scene:
    """Parse the sandbox .pv text format (Editor.cpp:245-281).

    Extension over the reference format: the absorption column also accepts
    a material name from the 38-entry table (e.g. ``CONCRETE_ROUGH``) in
    place of a numeric R value; reference-written files are all numeric and
    parse unchanged.
    """
    from planeverb.config import material_r

    tokens = text.split()
    it = iter(tokens)
    count = int(next(it))
    boxes = []
    for _ in range(count):
        _id = int(float(next(it)))  # ids re-assigned on load; preserved order
        x = float(next(it))
        y = float(next(it))
        w = float(next(it))
        h = float(next(it))
        a = material_r(next(it))
        boxes.append(AABB(x, y, w, h, a))
    return Scene(boxes=boxes, name=name)


def load_pv(path: str) -> Scene:
    with open(path, "r") as f:
        return loads_pv(f.read(), name=path)


def save_pv(scene: Scene, path_or_file) -> None:
    """Serialize in the sandbox .pv format (Editor.cpp:219-243)."""
    out = io.StringIO()
    out.write(f"{len(scene.boxes)}\n")
    for i, b in enumerate(scene.boxes):
        out.write(f"{i} {_fmt(b.x)} {_fmt(b.y)} {_fmt(b.width)} "
                  f"{_fmt(b.height)} {_fmt(b.absorption)}\n")
    data = out.getvalue()
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "w") as f:
            f.write(data)


def _fmt(v: float) -> str:
    s = f"{v:g}"
    return s


def _scene(name: str, rows: Iterable[tuple]) -> Scene:
    return Scene(boxes=[AABB(*r) for r in rows], name=name)


# Known-answer demo scenes with the same geometry as the reference's bundled
# .pv assets (data reproduced as constructors; see SURVEY.md §2 E2).
DEMO_SCENES = {
    # 10x10 room with four 0.969536-reflective walls (SmallRoom.pv)
    "SmallRoom": _scene("SmallRoom", [
        (5.0, 2.5, 10.0, 1.0, 0.969536),
        (5.0, 7.5, 10.0, 1.0, 0.969536),
        (2.5, 5.0, 1.0, 10.0, 0.969536),
        (7.5, 5.0, 1.0, 10.0, 0.969536),
    ]),
    # 10x10 room with walls on the outer edge (BigRoom.pv)
    "BigRoom": _scene("BigRoom", [
        (5.0, 0.0, 10.0, 1.0, 0.969536),
        (5.0, 10.0, 10.0, 1.0, 0.969536),
        (0.0, 5.0, 1.0, 10.0, 0.969536),
        (10.0, 5.0, 1.0, 10.0, 0.969536),
    ]),
    # ~25 m room with a partial interior divider (HugeRoom.pv)
    "HugeRoom": _scene("HugeRoom", [
        (12.41, 12.29, 11.3, 0.5, 0.969536),
        (12.5, 0.03, 25.77, 1.0, 0.969536),
        (12.51, 24.62, 26.02, 1.01, 0.969536),
        (0.11, 12.6, 1.0, 25.09, 0.969536),
        (24.89, 12.44, 1.0, 25.5, 0.969536),
    ]),
    # closed box with moderately absorbing walls (Shoebox.pv)
    "Shoebox": _scene("Shoebox", [
        (12.46, 0.03, 25.77, 1.0, 0.85),
        (12.51, 20.23, 26.02, 1.01, 0.85),
        (0.11, 12.34, 1.0, 25.09, 0.85),
        (14.04, 12.45, 1.0, 25.5, 0.85),
    ]),
    # single fully-reflective wall for diffraction tests (SingleWall.pv)
    "SingleWall": _scene("SingleWall", [
        (0.0, 12.53, 1.0, 26.0, 0.0),
    ]),
    # single centered wall (MiddleWallScene.pv)
    "MiddleWallScene": _scene("MiddleWallScene", [
        (12.5, 12.5, 8.0, 1.0, 0.98),
    ]),
    # room with an opening to redirect DOA (DirectionTester.pv)
    "DirectionTester": _scene("DirectionTester", [
        (3.35, 5.0, 6.18, 0.5, 0.969536),
        (5.0, 0.0, 10.0, 1.0, 0.969536),
        (0.0, 2.33, 1.0, 5.87, 0.969536),
        (10.0, 2.36, 1.0, 5.61, 0.969536),
        (8.88, 5.0, 3.37, 0.5, 0.969536),
    ]),
    # room with interior half-wall (ExampleProject.pv)
    "ExampleProject": _scene("ExampleProject", [
        (5.0, 5.0, 5.0, 0.5, 0.969536),
        (5.0, 0.0, 10.0, 1.0, 0.969536),
        (5.0, 10.0, 10.0, 1.0, 0.969536),
        (0.0, 5.0, 1.0, 10.0, 0.969536),
        (10.0, 5.0, 1.0, 10.0, 0.969536),
    ]),
    # 4-wall room with an interior baffle (DemoFiles/SmallRoomScene.pv)
    "SmallRoomScene": _scene("SmallRoomScene", [
        (3.4, 5.0, 6.18, 1.0, 0.969536),
        (5.88, 11.24, 10.69, 1.0, 0.969536),
        (0.28, 8.19, 1.0, 6.92, 0.969536),
        (11.38, 8.14, 1.0, 6.49, 0.969536),
        (9.49, 5.0, 3.37, 1.0, 0.969536),
    ]),
    # Unity-scene replication test (DemoFiles/UnityReplicationTest.pv)
    "UnityReplicationTest": _scene("UnityReplicationTest", [
        (10.0, 5.0, 0.9, 0.9, 0.85),
        (5.0, 1.98, 7.99, 1.0, 0.85),
        (1.51, 7.58, 1.0, 10.58, 0.85),
        (8.57, 5.76, 1.0, 6.93, 0.85),
        (13.82, 8.71, 9.86, 1.0, 0.85),
    ]),
    # 18-box floor plan (FloorPlanScene.pv)
    "FloorPlanScene": _scene("FloorPlanScene", [
        (7.0, 16.0, 8.0, 1.0, 0.9),
        (18.0, 19.21, 1.0, 11.37, 0.9),
        (12.5, 0.0, 25.0, 1.0, 0.9),
        (14.37, 13.5, 7.76, 1.0, 0.9),
        (0.0, 6.0, 1.0, 13.01, 0.9),
        (0.0, 20.87, 1.0, 9.24, 0.9),
        (12.5, 25.0, 25.0, 1.0, 0.9),
        (25.0, 22.0, 1.0, 6.0, 0.9),
        (7.0, 20.87, 1.0, 9.24, 0.9),
        (23.0, 15.52, 5.0, 1.0, 0.9),
        (25.0, 7.86, 1.0, 15.83, 0.9),
        (19.97, 1.93, 9.16, 4.05, 0.9),
        (21.94, 6.5, 5.47, 5.18, 0.9),
        (11.0, 2.15, 1.0, 3.81, 0.9),
        (7.37, 10.0, 14.29, 1.0, 0.9),
        (11.0, 8.43, 1.0, 3.22, 0.9),
        (6.0, 6.91, 1.0, 5.81, 0.9),
        (8.17, 4.0, 4.83, 1.0, 0.9),
    ]),
}


def demo_scene(name: str) -> Scene:
    """Fetch a built-in demo scene by name (e.g. 'SmallRoom')."""
    return DEMO_SCENES[name]
