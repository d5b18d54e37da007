"""C ABI acoustics binding (native/src/pv_engine_client.cpp) end-to-end.

Every call crosses the compiled C library exactly as a game engine would
(PlaneverbUnity.cpp surface analog); results are cross-checked against the
Python client on the same server.
"""

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
def cabi(server):
    from planeverb.native import NativeEngineClient

    host, port = server.address
    c = NativeEngineClient(host, port)
    yield c
    c.close()


def test_full_lifecycle_through_c_abi(cabi, server):
    # manual stepping: no background loop racing the reads below
    fs = cabi.init(10.0, 10.0, resolution=275, background=False)
    assert fs > 1000

    walls = [(5.0, 2.5, 10.0, 1.0), (5.0, 7.5, 10.0, 1.0),
             (2.5, 5.0, 1.0, 10.0), (7.5, 5.0, 1.0, 10.0)]
    gids = [cabi.add_geometry(x, y, w, h, 0.969536) for x, y, w, h in walls]
    assert gids == list(range(4))

    cabi.set_listener_position(5.0, 0.0, 5.0)
    eid = cabi.emit(6.5, 0.0, 5.0)
    assert eid == 0
    assert cabi.step() >= 1

    out = cabi.get_output(eid)
    assert out is not None
    assert out["occlusion"] > 0 and out["rt60"] > 0.1
    assert out["direction"][0] > 0.9  # source is +x of the listener

    # cross-check against the Python client on the same engine
    py = EngineClient(*server.address)
    ref = py.call("get_output", id=eid)
    py.close()
    np.testing.assert_allclose(out["occlusion"], ref["occlusion"], rtol=1e-6)
    np.testing.assert_allclose(out["rt60"], ref["rt60"], rtol=1e-6)
    np.testing.assert_allclose(out["direction"], ref["direction"], rtol=1e-5)

    # geometry update/remove + emission lifecycle through the C ABI
    cabi.update_geometry(gids[0], 5.0, 2.0, 10.0, 1.0, 0.9)
    cabi.remove_geometry(gids[1])
    cabi.update_emission(eid, 4.0, 0.0, 5.0)
    assert cabi.step() >= 2
    out2 = cabi.get_output(eid)
    assert out2 is not None and out2["direction"][0] < -0.9  # now -x side
    cabi.end_emission(eid)
    assert cabi.get_output(eid) is None  # ended emitter -> invalid sentinel
    cabi.exit()


def test_invalid_before_init_and_unknown_ids(cabi):
    assert cabi.step() == -1          # not initialized
    fs = cabi.init(10.0, 10.0, background=False)
    assert fs > 0
    assert cabi.get_output(12345) is None


def test_connect_refused():
    from planeverb.native import NativeEngineClient

    with pytest.raises(ConnectionError):
        NativeEngineClient("127.0.0.1", 1)  # nothing listens on port 1


def test_background_loop_with_wait_iteration(cabi):
    fs = cabi.init(10.0, 10.0, resolution=275, background=True)
    assert fs > 1000
    cabi.set_listener_position(5.0, 0.0, 5.0)
    eid = cabi.emit(6.5, 0.0, 5.0)
    # wait for a full iteration that started after the listener update
    assert cabi.wait_iteration(2, timeout_s=120.0)
    out = cabi.get_output(eid)
    assert out is not None and out["occlusion"] > 0
    cabi.exit()


def test_emit_ex_carries_attributes(cabi, server):
    """PlaneverbEmitEx forwards the emit-time attributes (forward, volume,
    directivity pattern) across the C ABI into the engine's emission
    registry (PlaneverbEmitter.cs:21-24,89-96)."""
    cabi.init(10.0, 10.0, resolution=275, background=False)
    eid = cabi.emit_ex(6.0, 0.0, 5.0, forward=(0.0, 0.0, -1.0),
                       volume_db=-6.0, pattern=1)
    assert eid >= 0
    em = server._ctx.emissions.get_emission(eid)
    assert em.position == (6.0, 0.0, 5.0)
    assert em.forward == (0.0, 0.0, -1.0)
    assert em.volume_db == -6.0 and em.pattern == 1
    assert em.volume_gain == pytest.approx(10 ** (-6.0 / 20.0))


def test_batched_get_outputs_fifty_emitters(cabi, server):
    """PlaneverbGetOutputs: 50 emitters polled in ONE round-trip (the
    reference polls each emitter per frame, PlaneverbAudioSource.cs:171-183;
    over a socket that is 50 round-trips — the batch is one). Rows must
    match the per-id GetOutput path bit-for-bit, invalid ids get None."""
    cabi.init(10.0, 10.0, resolution=275, background=False)
    cabi.set_listener_position(5.0, 0.0, 5.0)
    ids = []
    for i in range(50):
        x = 1.0 + 8.0 * (i % 10) / 9.0
        z = 1.0 + 8.0 * (i // 10) / 4.0
        ids.append(cabi.emit(x, 0.0, z))
    cabi.step()

    batch = cabi.get_outputs(ids + [777])   # one unknown id at the end
    assert len(batch) == 51
    assert batch[-1] is None                # unknown id -> invalid sentinel
    n_valid = sum(o is not None for o in batch[:-1])
    assert n_valid == 50
    for eid, row in zip(ids[:7], batch[:7]):   # spot-check vs per-id path
        single = cabi.get_output(eid)
        assert single is not None
        for k in ("occlusion", "wet_gain", "rt60", "lowpass"):
            assert row[k] == single[k]
        assert row["direction"] == single["direction"]
    cabi.exit()


def test_add_geometry_material_through_c_abi(cabi, server):
    """PlaneverbAddGeometryMaterial resolves the name server-side."""
    from planeverb.config import MATERIALS

    cabi.init(10.0, 10.0, resolution=275, background=False)
    gid = cabi.add_geometry(5.0, 5.0, 2.0, 2.0, "WOOD_PANEL")
    assert gid >= 0
    box = server._ctx.geometry.get(gid)
    assert box.absorption == MATERIALS.WOOD_PANEL
    # update preserving a named material (PlaneverbUpdateGeometryMaterial)
    cabi.update_geometry(gid, 4.0, 4.0, 2.0, 2.0, "CONCRETE_ROUGH")
    box = server._ctx.geometry.get(gid)
    assert box.x == 4.0 and box.absorption == MATERIALS.CONCRETE_ROUGH
    # quotes/backslashes in a material name must cross as well-formed JSON
    # (json_escape) and resolve to a clean unknown-material error, not a
    # protocol failure that kills the connection
    assert cabi.add_geometry(1.0, 1.0, 1.0, 1.0, 'BO"G\\US') == -1
    assert cabi.add_geometry(1.0, 1.0, 1.0, 1.0, "BOGUS") == -1
    cabi.exit()


def test_c_demo_compiles_and_runs(server, tmp_path):
    """examples/engine_client_demo.c is a real, compiling, running program:
    build it with gcc against libpvengine and drive it against a live
    server — including the 50-emitter single-call batched poll."""
    import os
    import subprocess

    from planeverb.native import build_engine_client_library

    lib = build_engine_client_library()
    demo = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "engine_client_demo.c")
    exe = tmp_path / "pv_demo"
    subprocess.run(["gcc", demo, "-o", str(exe), lib,
                    f"-Wl,-rpath,{os.path.dirname(lib)}"],
                   check=True, capture_output=True)
    host, port = server.address
    r = subprocess.run([str(exe), host, str(port)], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "occlusion" in r.stdout
    assert "batched poll: 50/50 emitters valid in one call" in r.stdout


def test_multi_listener_through_c_abi(cabi, server):
    """PlaneverbSetListenerPositions + PlaneverbGetOutputsEx: split-screen
    views over the C ABI; each view's batched rows match the Python
    client's per-view get_output."""
    cabi.init(10.0, 10.0, resolution=275, background=False)
    walls = [(5.0, 2.5, 10.0, 1.0), (5.0, 7.5, 10.0, 1.0),
             (2.5, 5.0, 1.0, 10.0), (7.5, 5.0, 1.0, 10.0)]
    for x, y, w, h in walls:
        cabi.add_geometry(x, y, w, h, 0.969536)
    with pytest.raises(ValueError, match="triples"):
        cabi.set_listener_positions([(1.0, 2.0)])   # guards the C-side read
    assert cabi.set_listener_positions([(5.0, 0.0, 5.0), (4.0, 0.0, 6.0)])
    eid = cabi.emit(6.5, 0.0, 5.0)
    cabi.step()

    v0 = cabi.get_outputs([eid], listener=0)[0]
    v1 = cabi.get_outputs([eid], listener=1)[0]
    assert v0 is not None and v1 is not None
    assert v0["occlusion"] != v1["occlusion"]
    # out-of-range view: invalid sentinel, not a protocol error
    assert cabi.get_outputs([eid], listener=9)[0] is None

    py = EngineClient(*server.address)
    ref = py.call("get_output", id=eid, listener=1)
    py.close()
    np.testing.assert_allclose(v1["occlusion"], ref["occlusion"], rtol=1e-6)
    np.testing.assert_allclose(v1["rt60"], ref["rt60"], rtol=1e-6)
    cabi.exit()
