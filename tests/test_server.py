"""Engine server protocol tests (binding-layer analog)."""

import numpy as np
import pytest

from planeverb.server import EngineClient, EngineServer


@pytest.fixture()
def server():
    srv = EngineServer(port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


@pytest.fixture()
def client(server):
    c = EngineClient(*server.address)
    yield c
    c.close()


def test_full_session(client):
    # init a 10 m grid, manual stepping
    r = client.call("init", grid_size_x=10, grid_size_y=10,
                    grid_resolution=275, background=False)
    assert r["ok"] and r["fs"] > 0 and r["grid"][0] > 0

    # build a room, place listener + emitter, step once
    for wall in [(5.0, 2.5, 10.0, 1.0), (5.0, 7.5, 10.0, 1.0),
                 (2.5, 5.0, 1.0, 10.0), (7.5, 5.0, 1.0, 10.0)]:
        r = client.call("add_geometry", x=wall[0], y=wall[1],
                        width=wall[2], height=wall[3], absorption=0.969536)
        assert r["ok"]
    client.call("set_listener_position", x=5.0, z=5.0)
    r = client.call("emit", x=6.5, z=5.0)
    eid = r["id"]
    r = client.call("step")
    assert r["ok"] and r["iteration"] == 1

    out = client.call("get_output", id=eid)
    assert out["ok"] and out["valid"]
    assert out["occlusion"] > 0 and out["rt60"] > 0
    assert abs(np.hypot(*out["direction"]) - 1.0) < 1e-4

    # geometry update changes results
    r = client.call("add_geometry", x=5.75, y=5.0, width=0.8, height=3.0,
                    absorption=0.98)
    blocker = r["id"]
    client.call("step")
    out2 = client.call("get_output", id=eid)
    assert out2["occlusion"] != out["occlusion"]
    client.call("remove_geometry", id=blocker)

    ir = client.call("get_impulse_response", x=6.5, z=5.0)
    assert ir["ok"] and len(ir["ir"]) > 100

    prof = client.call("profile")
    assert prof["ok"] and "simulate+analyze" in prof["stages"]

    r = client.call("end_emission", id=eid)
    assert r["ok"]
    assert client.call("exit")["ok"]


def test_geometry_material_names(server, client):
    """add/update_geometry accept material names where floats are accepted
    (name->R against the 38-entry table, PlaneverbObject.cs:203-244)."""
    from planeverb.config import MATERIALS

    r = client.call("init", grid_size_x=6, grid_size_y=6,
                    grid_resolution=275, background=False)
    assert r["ok"]
    r = client.call("add_geometry", x=3.0, y=3.0, width=1.0, height=1.0,
                    absorption="CONCRETE_ROUGH")
    assert r["ok"]
    gid = r["id"]
    ctx = server._ctx
    assert ctx.geometry.get(gid).absorption == MATERIALS.CONCRETE_ROUGH
    r = client.call("update_geometry", id=gid, x=3.0, y=3.0, width=1.0,
                    height=1.0, absorption="grass")
    assert r["ok"]
    assert ctx.geometry.get(gid).absorption == MATERIALS.GRASS
    r = client.call("add_geometry", x=1.0, y=1.0, width=1.0, height=1.0,
                    absorption="NOT_A_MATERIAL")
    assert not r["ok"] and "unknown material" in r["error"]
    client.call("exit")


def test_manual_step_rejected_while_background(client):
    """The step command and the background loop are mutually exclusive:
    Context.step() is lock-serialized, and the server refuses to mix the
    two cadences (use wait_iteration against a running loop)."""
    r = client.call("init", grid_size_x=6, grid_size_y=6,
                    grid_resolution=275, background=True)
    assert r["ok"]
    r = client.call("step")
    assert not r["ok"] and "background" in r["error"]
    r = client.call("wait_iteration", n=1, timeout=120.0)
    assert r["ok"] and r["iteration"] >= 1
    client.call("exit")


def test_errors_do_not_kill_connection(client):
    r = client.call("get_output", id=0)       # before init
    assert not r["ok"] and "init" in r["error"]
    r = client.call("frobnicate")
    assert not r["ok"] and "unknown cmd" in r["error"]
    r = client.call("init", grid_size_x=6, grid_size_y=6,
                    grid_resolution=275, background=False)
    assert r["ok"]
    r = client.call("emit")                   # missing args
    assert not r["ok"] and "KeyError" in r["error"]
    # connection still usable
    assert client.call("exit")["ok"]


def test_two_clients_share_engine(server):
    a = EngineClient(*server.address)
    b = EngineClient(*server.address)
    try:
        a.call("init", grid_size_x=6, grid_size_y=6, grid_resolution=275,
               background=False)
        r = b.call("emit", x=3.0, z=3.0)
        assert r["ok"]
        a.call("step")
        out = b.call("get_output", id=r["id"])
        assert out["ok"]
    finally:
        a.close()
        b.close()


def test_init_with_mesh(client):
    """init with a mesh count runs the engine sharded over the devices;
    outputs match the reference single-device init."""
    r = client.call("init", grid_size_x=10, grid_size_y=10,
                    grid_resolution=275, background=False, mesh=8)
    assert r["ok"] and r["mesh"] == {"x": 2, "y": 4}
    assert client.call("add_geometry", x=5.0, y=5.0, width=1.0, height=1.0,
                       absorption=0.9)["ok"]
    client.call("set_listener_position", x=3.0, y=0.0, z=5.0)
    e = client.call("emit", x=7.0, y=0.0, z=5.0)["id"]
    client.call("step")
    sharded = client.call("get_output", id=e)

    r = client.call("init", grid_size_x=10, grid_size_y=10,
                    grid_resolution=275, background=False)
    assert r["ok"] and "mesh" not in r
    assert client.call("add_geometry", x=5.0, y=5.0, width=1.0, height=1.0,
                       absorption=0.9)["ok"]
    client.call("set_listener_position", x=3.0, y=0.0, z=5.0)
    e = client.call("emit", x=7.0, y=0.0, z=5.0)["id"]
    client.call("step")
    single = client.call("get_output", id=e)
    for f in ("occlusion", "wet_gain", "rt60", "lowpass"):
        assert sharded[f] == pytest.approx(single[f], rel=2e-4), f
    # asking for more devices than exist is a clean error
    r = client.call("init", mesh=512)
    assert not r["ok"] and "devices" in r["error"]


def test_multi_listener_over_wire(client):
    """set_listener_positions + per-view get_output(s) (split-screen over
    the protocol; Context.set_listener_positions docs)."""
    r = client.call("init", grid_size_x=10, grid_size_y=10,
                    grid_resolution=275, background=False, publish="grids")
    assert r["ok"]
    r = client.call("set_listener_positions",
                    positions=[[3.0, 0.0, 3.0], [7.0, 0.0, 6.0]])
    assert r["ok"] and r["count"] == 2
    eid = client.call("emit", x=6.0, z=5.0)["id"]
    client.call("step")

    v0 = client.call("get_output", id=eid, listener=0)
    v1 = client.call("get_output", id=eid, listener=1)
    assert v0["ok"] and v0["valid"] and v1["ok"] and v1["valid"]
    assert v0["occlusion"] != v1["occlusion"]
    # out-of-range view -> invalid sentinel, not an error
    v2 = client.call("get_output", id=eid, listener=5)
    assert v2["ok"] and not v2["valid"]

    rows = client.call("get_outputs", listener=1)
    assert rows["ok"] and rows["count"] == 1
    assert rows["rows"][0] == pytest.approx(v1["occlusion"])

    # the cells publish (the server default) supports views too: rows are
    # fetched per view in one [B, Q, 9] transfer
    r = client.call("init", grid_size_x=10, grid_size_y=10,
                    grid_resolution=275, background=False, publish="cells")
    assert r["ok"]
    r = client.call("set_listener_positions",
                    positions=[[3.0, 0.0, 3.0], [7.0, 0.0, 6.0]])
    assert r["ok"]
    eid = client.call("emit", x=6.0, z=5.0)["id"]
    client.call("step")
    c0 = client.call("get_output", id=eid, listener=0)
    c1 = client.call("get_output", id=eid, listener=1)
    assert c0["valid"] and c1["valid"]
    assert c0["occlusion"] == pytest.approx(v0["occlusion"], rel=1e-6)
    assert c1["occlusion"] == pytest.approx(v1["occlusion"], rel=1e-6)
