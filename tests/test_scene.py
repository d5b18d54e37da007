"""Scene I/O round-trips and demo-scene integrity."""

import io

from planeverb.scene import (DEMO_SCENES, AABB, Scene, demo_scene,
                             loads_pv, save_pv)


def test_pv_roundtrip():
    scene = Scene(boxes=[AABB(1.5, 2.5, 3.0, 4.0, 0.9),
                         AABB(-1.0, 0.0, 1.0, 1.0, 0.5)])
    buf = io.StringIO()
    save_pv(scene, buf)
    parsed = loads_pv(buf.getvalue())
    assert len(parsed) == 2
    assert parsed.boxes[0] == scene.boxes[0]
    assert parsed.boxes[1] == scene.boxes[1]


def test_loads_reference_format():
    text = "2\n3 5 2.5 10 1 0.969536\n4 5 7.5 10 1 0.969536\n"
    scene = loads_pv(text)
    assert len(scene) == 2
    assert scene.boxes[0] == AABB(5.0, 2.5, 10.0, 1.0, 0.969536)


def test_demo_scene_inventory():
    for name in ("SmallRoom", "BigRoom", "HugeRoom", "Shoebox", "SingleWall",
                 "MiddleWallScene", "DirectionTester", "ExampleProject",
                 "FloorPlanScene", "SmallRoomScene", "UnityReplicationTest"):
        assert name in DEMO_SCENES
    assert len(demo_scene("SmallRoom")) == 4
    assert len(demo_scene("FloorPlanScene")) == 18
    assert len(demo_scene("UnityReplicationTest")) == 5


class TestHeadSlice:
    def test_project_to_slice_culls_by_listener_height(self):
        from planeverb.scene import AABB3D, project_to_slice

        boxes = [
            AABB3D(1.0, 1.0, 2.0, 2.0, 2.0, 3.0, 0.9),   # spans 0..2
            AABB3D(4.0, 5.0, 1.0, 1.0, 1.0, 1.0, 0.8),   # spans 4.5..5.5
            AABB3D(0.0, -3.0, 0.0, 1.0, 1.0, 1.0, 0.7),  # underground
        ]
        scene = project_to_slice(boxes, listener_y=1.5)
        assert len(scene.boxes) == 1
        b = scene.boxes[0]
        # 2D projection keeps (x, z) footprint and absorption
        assert (b.x, b.y, b.width, b.height) == (1.0, 2.0, 2.0, 3.0)
        assert b.absorption == 0.9

        # raising the listener to the second box's height flips the cull
        scene2 = project_to_slice(boxes, listener_y=5.0)
        assert len(scene2.boxes) == 1
        assert scene2.boxes[0].x == 4.0


def test_merge_bounds_encapsulates_children():
    from planeverb.scene import AABB3D, merge_bounds

    kids = [AABB3D(0.0, 1.0, 0.0, 2.0, 2.0, 2.0, absorption=0.8),
            AABB3D(3.0, 2.0, -1.0, 1.0, 4.0, 1.0)]
    m = merge_bounds(kids)
    assert (m.x, m.y, m.z) == (1.25, 2.0, -0.25)
    assert (m.width, m.height, m.depth) == (4.5, 4.0, 2.5)
    assert m.absorption == 0.8
    assert merge_bounds(kids, absorption=0.5).absorption == 0.5
    import pytest

    with pytest.raises(ValueError):
        merge_bounds([])


def test_pv_material_names():
    """The .pv absorption column accepts material names (extension over the
    reference's numeric-only format, which still parses unchanged)."""
    from planeverb.config import MATERIALS
    from planeverb.scene import loads_pv

    s = loads_pv("2\n0 1 2 3 4 CONCRETE_ROUGH\n1 5 6 7 8 0.5\n")
    assert s.boxes[0].absorption == MATERIALS.CONCRETE_ROUGH
    assert s.boxes[1].absorption == 0.5
