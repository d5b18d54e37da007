"""Game-object runtime tests (core/objects.py, PlaneverbObject analog).

Pins the reference component's per-frame contract: child-bounds merging,
head-slice culling against the listener height, add/update/remove flow into
the geometry registry, and the SIZE_EPSILON projection shave
(PlaneverbObject.cs:73,93-118,163-200).
"""

import numpy as np
import pytest

import planeverb as pv

CFG = pv.PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0,
                         grid_resolution=275)


def _ctx():
    c = pv.Context(CFG)
    c.set_listener_position(5.0, 1.6, 5.0)   # standing listener head height
    return c


def test_head_slice_culling_and_sync():
    ctx = _ctx()
    om = pv.ObjectManager(ctx)

    # a full-height wall spans the head slice -> voxelized
    wall = pv.AABB3D(x=5.0, y=1.5, z=5.0, width=1.0, height=3.0, depth=4.0,
                     absorption=0.95)
    oid = om.add(wall)
    assert om.in_head_slice(oid)
    assert len(ctx.geometry.snapshot()[1]) == 1

    # a knee-high crate does not -> culled
    crate = pv.AABB3D(x=3.0, y=0.25, z=3.0, width=0.5, height=0.5, depth=0.5)
    oid2 = om.add(crate)
    assert not om.in_head_slice(oid2)
    assert len(ctx.geometry.snapshot()[1]) == 1

    # listener crouches below the wall top but into the crate's span? no —
    # crouch to 0.4 m: crate [0, 0.5] now spans, wall [0, 3] still spans
    ctx.set_listener_position(5.0, 0.4, 5.0)
    stats = om.sync()
    assert om.in_head_slice(oid2)
    assert stats["added"] == 1 and stats["updated"] == 1
    assert len(ctx.geometry.snapshot()[1]) == 2

    # jump above both -> everything culled out
    ctx.set_listener_position(5.0, 10.0, 5.0)
    stats = om.sync()
    assert stats["removed"] == 2
    assert ctx.geometry.snapshot()[1] == []

    # back down: re-added
    ctx.set_listener_position(5.0, 1.0, 5.0)
    om.sync()
    assert om.in_head_slice(oid) and not om.in_head_slice(oid2)


def test_projection_matches_calculate_aabb():
    """The projected 2D box is (x, z) center with width/depth extents minus
    SIZE_EPSILON and the object's absorption (PlaneverbObject.cs:163-180)."""
    from planeverb.core.objects import SIZE_EPSILON

    ctx = _ctx()
    om = pv.ObjectManager(ctx)
    om.add(pv.AABB3D(x=2.0, y=1.0, z=7.0, width=1.5, height=4.0, depth=0.6,
                     absorption=0.9))
    _, boxes = ctx.geometry.snapshot()
    b = boxes[0]
    assert (b.x, b.y) == (2.0, 7.0)
    assert b.width == pytest.approx(1.5 - SIZE_EPSILON)
    assert b.height == pytest.approx(0.6 - SIZE_EPSILON)
    assert b.absorption == 0.9


def test_child_bounds_merge_and_update():
    ctx = _ctx()
    om = pv.ObjectManager(ctx)
    children = [
        pv.AABB3D(x=0.0, y=1.0, z=4.0, width=1.0, height=2.0, depth=1.0,
                  absorption=0.9),
        pv.AABB3D(x=2.0, y=2.0, z=6.0, width=1.0, height=4.0, depth=1.0),
    ]
    oid = om.add(children)
    merged = om.get_bounds(oid)
    assert merged.width == pytest.approx(3.0)    # [-0.5, 2.5] x extent
    assert merged.absorption == 0.9              # first child's material

    # object moves (per-frame transform change): geometry follows, same gid
    gid_before = ctx.geometry.snapshot()[1]
    om.update(oid, pv.AABB3D(x=8.0, y=1.0, z=8.0, width=1.0, height=3.0,
                             depth=1.0, absorption=0.8))
    _, boxes = ctx.geometry.snapshot()
    assert len(boxes) == 1 and boxes[0].x == 8.0
    with pytest.raises(KeyError):
        om.update(999, children[0])


def test_remove_is_destroy():
    ctx = _ctx()
    om = pv.ObjectManager(ctx)
    oid = om.add(pv.AABB3D(x=5.0, y=1.5, z=5.0, width=1.0, height=3.0,
                           depth=1.0))
    assert len(ctx.geometry.snapshot()[1]) == 1
    om.remove(oid)
    assert ctx.geometry.snapshot()[1] == []
    om.remove(oid)  # idempotent


def test_objects_change_acoustics():
    """End to end: an ObjectManager wall blocks sound only while the
    listener's head is in its slice."""
    ctx = _ctx()
    ctx.set_listener_position(2.0, 1.5, 5.0)
    ctx.step()
    open_occ = ctx.result_at(8.0, 5.0).occlusion

    om = pv.ObjectManager(ctx)
    om.add(pv.AABB3D(x=5.0, y=1.5, z=5.0, width=0.75, height=3.0, depth=8.0,
                     absorption=0.98))
    ctx.step()
    blocked = ctx.result_at(8.0, 5.0).occlusion
    assert blocked < 0.6 * open_occ

    # duck under the wall (a doorway crawl): culled -> sound clears up
    ctx.set_listener_position(2.0, -5.0, 5.0)
    om.sync()
    ctx.step()
    cleared = ctx.result_at(8.0, 5.0).occlusion
    assert abs(cleared - open_occ) < 1e-5 * max(open_occ, 1.0)


def test_object_material_names():
    """ObjectManager accepts material names where it accepts R floats
    (PlaneverbObject.cs:203-244 enum plumbing)."""
    from planeverb.config import MATERIALS

    ctx = _ctx()
    om = pv.ObjectManager(ctx)
    oid = om.add(pv.AABB3D(5.0, 1.0, 5.0, 1.0, 4.0, 1.0),
                 absorption="WOOD_PANEL")
    assert om.get_bounds(oid).absorption == MATERIALS.WOOD_PANEL
    om.update(oid, pv.AABB3D(5.0, 1.0, 5.0, 1.0, 4.0, 1.0),
              absorption="drapery_heavy")
    assert om.get_bounds(oid).absorption == MATERIALS.DRAPERY_HEAVY
