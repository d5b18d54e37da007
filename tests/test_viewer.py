"""Interactive web sandbox tests (Editor.cpp analog, sandbox/viewer.py).

Exercises the HTTP surface end-to-end against a live engine context:
page load, state snapshot, listener/emitter/geometry commands, parameter
and IR queries, demo-scene loading, and .pv export.
"""

import json
import urllib.request

import numpy as np
import pytest

from planeverb.config import PlaneverbConfig
from planeverb.sandbox.viewer import ViewerServer
from planeverb.scene import demo_scene, loads_pv

CFG = PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0, grid_resolution=275)


@pytest.fixture(scope="module")
def viewer():
    v = ViewerServer(CFG, scene=demo_scene("SmallRoom"), port=0,
                     background=False)
    v.start_background()
    yield v
    v.shutdown()


def _get(viewer, path):
    host, port = viewer.address
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=120) as r:
        body = r.read()
        if r.headers.get_content_type() == "application/json":
            return json.loads(body)
        return body.decode()


def _cmd(viewer, **req):
    host, port = viewer.address
    r = urllib.request.urlopen(
        urllib.request.Request(
            f"http://{host}:{port}/api/command",
            data=json.dumps(req).encode(),
            headers={"Content-Type": "application/json"}),
        timeout=600)
    return json.loads(r.read())


def test_page_serves(viewer):
    page = _get(viewer, "/")
    assert "<!doctype html>" in page and "planeverb" in page
    assert "/api/state" in page  # the app actually talks to the API


def test_state_snapshot(viewer):
    s = _get(viewer, "/api/state")
    assert s["grid"]["nx"] > 0 and s["grid"]["fs"] > 0
    assert len(s["occupancy"]) == s["grid"]["nx"]
    assert len(s["occupancy"][0]) == s["grid"]["ny"]
    # SmallRoom walls voxelize to solid cells
    assert any("#" in row for row in s["occupancy"])
    assert len(s["geometry"]) == 4
    assert s["scene"] == "SmallRoom"
    assert "SmallRoom" in s["scenes"]
    assert s["running"] is False


def test_full_editing_session(viewer):
    # place listener + emitter, step, read params at the emitter
    assert _cmd(viewer, cmd="listener", x=5.0, z=5.0)["ok"]
    r = _cmd(viewer, cmd="emit", x=6.5, z=5.0)
    eid = r["id"]
    r = _cmd(viewer, cmd="step")
    assert r["ok"] and r["iteration"] >= 1

    out = _get(viewer, "/api/output?x=6.5&z=5.0")
    assert out["valid"] and out["occlusion"] > 0 and out["rt60"] > 0
    assert out["dry_db"] == pytest.approx(
        20 * np.log10(max(out["occlusion"], 1e-6)), abs=1e-6)

    # IR probe matches the context accessor
    ir = _get(viewer, "/api/ir?x=6.5&z=5.0")
    assert ir["fs"] == viewer.ctx.params.fs
    assert len(ir["samples"]) == viewer.ctx.params.response_length
    assert max(abs(v) for v in ir["samples"]) > 0

    # geometry CRUD: a blocker changes the result at the emitter
    r = _cmd(viewer, cmd="add_geometry", cx=5.75, cy=5.0, w=0.8, h=3.0,
             absorption=0.98)
    gid = r["id"]
    _cmd(viewer, cmd="step")
    out2 = _get(viewer, "/api/output?x=6.5&z=5.0")
    assert out2["occlusion"] != out["occlusion"]
    assert _cmd(viewer, cmd="remove_geometry", id=gid)["ok"]

    # emitter bookkeeping (incl. emit-time attributes) shows up in state
    s = _get(viewer, "/api/state")
    [em] = [e for e in s["emitters"] if e["id"] == eid]
    assert (em["x"], em["z"]) == (6.5, 5.0)
    assert em["volume_db"] == 0.0 and em["pattern"] == 0
    assert _cmd(viewer, cmd="update_emission", id=eid, x=6.0, z=5.0,
                volume_db=-6.0, pattern=1)["ok"]
    [em] = [e for e in _get(viewer, "/api/state")["emitters"]
            if e["id"] == eid]
    assert em["volume_db"] == -6.0 and em["pattern"] == 1 and em["x"] == 6.0
    assert _cmd(viewer, cmd="end_emission", id=eid)["ok"]
    assert _get(viewer, "/api/state")["emitters"] == []


def test_pv_roundtrip_and_scene_load(viewer):
    pv_text = _get(viewer, "/api/scene.pv")
    scene = loads_pv(pv_text)
    assert len(scene.boxes) == len(_get(viewer, "/api/state")["geometry"])

    assert _cmd(viewer, cmd="load_scene", name="MiddleWallScene")["ok"]
    s = _get(viewer, "/api/state")
    assert s["scene"] == "MiddleWallScene" and len(s["geometry"]) == 1

    assert _cmd(viewer, cmd="load_scene", name="SmallRoom")["ok"]  # restore


def test_errors_do_not_kill_server(viewer):
    r = _cmd(viewer, cmd="no_such_command")
    assert r["ok"] is False and "unknown" in r["error"]
    r = _cmd(viewer, cmd="update_geometry", id=99999, cx=0, cy=0, w=1, h=1)
    assert r["ok"] is False
    with pytest.raises(urllib.error.HTTPError):
        _get(viewer, "/api/nope")
    # still alive
    assert _get(viewer, "/api/state")["grid"]["nx"] > 0
