"""Engine-state checkpoint/resume (planeverb.session)."""

import io
import re

import numpy as np
import pytest

import planeverb as pv


CFG = pv.PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0,
                         grid_resolution=275)


def _build_context():
    ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    ctx.set_listener_position(5.0, 0.0, 5.0)
    extra = ctx.geometry.add(pv.AABB(4.0, 4.0, 0.5, 0.5, 0.5))
    hole = ctx.geometry.add(pv.AABB(6.0, 6.0, 0.5, 0.5, 0.5))
    ctx.geometry.remove(hole)            # free-list hole to round-trip
    e0 = ctx.emissions.emit(6.5, 0.0, 5.0)
    e1 = ctx.emissions.emit(3.0, 0.0, 5.0)
    ctx.emissions.end(e0)                # emitter hole too
    return ctx, extra, hole, e1


class TestSessionRoundtrip:
    def test_state_survives_roundtrip(self):
        ctx, extra, hole, e1 = _build_context()
        buf = io.StringIO()
        pv.save_session(ctx, buf)
        buf.seek(0)
        ctx2 = pv.load_session(buf)

        assert ctx2.config == ctx.config
        assert ctx2.get_listener_position() == (5.0, 0.0, 5.0)
        assert ctx2.geometry.items() == ctx.geometry.items()
        assert ctx2.geometry.get(extra) is not None
        assert ctx2.geometry.get(hole) is None
        assert ctx2.emissions.snapshot() == ctx.emissions.snapshot()
        assert ctx2.emissions.get(e1) == (3.0, 0.0, 5.0)

    def test_freed_ids_are_reused_after_restore(self):
        ctx, _, hole, _ = _build_context()
        buf = io.StringIO()
        pv.save_session(ctx, buf)
        buf.seek(0)
        ctx2 = pv.load_session(buf)
        assert ctx2.geometry.add(pv.AABB(1.0, 1.0, 0.5, 0.5, 0.5)) == hole
        assert ctx2.emissions.emit(1.0, 0.0, 1.0) == 0  # freed e0 slot

    def test_resumed_context_reproduces_results(self):
        ctx, _, _, e1 = _build_context()
        ctx.step()
        out = ctx.get_output(e1)
        assert out.valid

        buf = io.StringIO()
        pv.save_session(ctx, buf)
        buf.seek(0)
        ctx2 = pv.load_session(buf)
        ctx2.step()
        out2 = ctx2.get_output(e1)
        # same geometry + listener => identical analyzer results
        np.testing.assert_allclose(out2.occlusion, out.occlusion, rtol=1e-6)
        np.testing.assert_allclose(out2.rt60, out.rt60, rtol=1e-6)

    def test_rejects_foreign_documents(self):
        with pytest.raises(ValueError, match="not a"):
            pv.load_session(io.StringIO('{"format": "something-else"}'))

    def test_rejects_newer_versions(self):
        ctx, _, _, _ = _build_context()
        buf = io.StringIO()
        pv.save_session(ctx, buf)
        doc = re.sub(r'"version": \d+', '"version": 99', buf.getvalue())
        with pytest.raises(ValueError, match="newer"):
            pv.load_session(io.StringIO(doc))

    def test_file_roundtrip(self, tmp_path):
        ctx, _, _, _ = _build_context()
        path = str(tmp_path / "session.json")
        pv.save_session(ctx, path)
        ctx2 = pv.load_session(path)
        assert ctx2.geometry.items() == ctx.geometry.items()

    def test_free_list_order_matches_live_session(self):
        ctx = pv.Context(CFG)
        ids = [ctx.geometry.add(pv.AABB(float(i), 1.0, 0.5, 0.5, 0.5))
               for i in range(4)]
        ctx.geometry.remove(ids[3])
        ctx.geometry.remove(ids[1])   # live free stack: [3, 1]
        e = [ctx.emissions.emit(float(i), 0.0, 1.0) for i in range(3)]
        ctx.emissions.end(e[2])
        ctx.emissions.end(e[0])       # live free stack: [2, 0]

        buf = io.StringIO()
        pv.save_session(ctx, buf)
        buf.seek(0)
        ctx2 = pv.load_session(buf)
        # id reuse order after resume == uncheckpointed order (LIFO)
        assert ctx2.geometry.add(pv.AABB(9.0, 9.0, 0.5, 0.5, 0.5)) == ids[1]
        assert ctx2.geometry.add(pv.AABB(9.0, 8.0, 0.5, 0.5, 0.5)) == ids[3]
        assert ctx2.emissions.emit(9.0, 0.0, 9.0) == e[0]
        assert ctx2.emissions.emit(9.0, 0.0, 8.0) == e[2]


def test_multi_listener_survives_roundtrip():
    """v3 sessions carry the split-screen listener list; restore returns a
    context in multi-listener mode with every view queryable."""
    from planeverb.session import load_session, save_session

    positions = [(3.0, 0.0, 3.0), (7.0, 0.0, 6.0)]
    ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    ctx.set_listener_positions(positions)
    ctx.emissions.emit(6.0, 0.0, 5.0)
    buf = io.StringIO()
    save_session(ctx, buf)
    buf.seek(0)
    ctx2 = load_session(buf)
    assert ctx2.get_listener_positions() == positions
    ctx2.step()
    a = ctx2.result_at(6.0, 5.0, listener=1)
    assert a.valid
    ctx.step()
    b = ctx.result_at(6.0, 5.0, listener=1)
    assert a.occlusion == pytest.approx(b.occlusion, rel=1e-6)
