"""Context orchestration + module-level API facade tests."""

import numpy as np
import pytest

import planeverb as pv
from planeverb import api
from planeverb.types import INVALID_DRY_GAIN

CFG = pv.PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0,
                         grid_resolution=275)


def test_context_end_to_end():
    ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    ctx.set_listener_position(5.0, 0.0, 5.0)
    ctx.step()
    out = ctx.result_at(6.0, 5.0)
    assert out.valid
    assert out.occlusion > 0.1
    assert out.rt60 > 0.0
    assert 20.0 < out.lowpass <= 20000.0
    nrm = np.hypot(out.direction.x, out.direction.y)
    assert abs(nrm - 1.0) < 1e-4

    # out-of-grid source position is invalid
    assert not ctx.result_at(-5.0, 5.0).valid

    ir = ctx.get_impulse_response(6.0, 5.0)
    assert ir.shape == (ctx.params.response_length,)
    assert np.abs(ir).max() > 0


def test_geometry_updates_change_results():
    ctx = pv.Context(CFG)
    ctx.set_listener_position(2.0, 0.0, 5.0)
    ctx.step()
    before = ctx.result_at(8.0, 5.0).occlusion

    gid = ctx.geometry.add(pv.AABB(5.0, 5.0, 0.75, 8.0, 0.98))
    ctx.step()
    blocked = ctx.result_at(8.0, 5.0).occlusion
    assert blocked < 0.6 * before, (blocked, before)

    ctx.geometry.remove(gid)
    ctx.step()
    after = ctx.result_at(8.0, 5.0).occlusion
    assert abs(after - before) < 1e-5 * max(abs(before), 1.0)


def test_emission_lifecycle():
    ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    ctx.set_listener_position(5.0, 0.0, 5.0)
    ctx.step()
    e1 = ctx.emissions.emit(6.0, 0.0, 5.0)
    e2 = ctx.emissions.emit(4.0, 0.0, 5.0)
    assert e1 != e2
    assert ctx.get_output(e1).valid
    ctx.emissions.end(e1)
    assert ctx.get_output(e1).occlusion == INVALID_DRY_GAIN
    # free-list id reuse
    e3 = ctx.emissions.emit(5.5, 0.0, 5.0)
    assert e3 == e1
    ctx.emissions.update(e2, 4.5, 0.0, 5.0)
    assert ctx.emissions.get(e2) == (4.5, 0.0, 5.0)


def test_background_thread():
    ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    ctx.set_listener_position(5.0, 0.0, 5.0)
    ctx.start()
    try:
        assert ctx.wait_for_iteration(2, timeout=120.0)
    finally:
        ctx.stop()
    assert ctx.iteration >= 2
    assert ctx.result_at(6.0, 5.0).valid
    prof = ctx.profile_summary()
    assert "simulate+analyze" in prof


def test_concurrent_steps_serialize():
    """Manual step() racing the background loop must never interleave:
    iterations are lock-serialized, so N threads x K steps + a live
    background loop still count every iteration exactly once."""
    import threading

    ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    ctx.set_listener_position(5.0, 0.0, 5.0)
    ctx.step()  # compile once before the stampede

    n_threads, k = 4, 3
    errors = []

    def stepper():
        try:
            for _ in range(k):
                ctx.step()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ctx.start()
    threads = [threading.Thread(target=stepper) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ctx.wait_for_iteration(ctx.iteration + 1, timeout=120.0)
    ctx.stop()

    assert not errors
    assert ctx.error is None
    # every manual step plus >= the two witnessed loop iterations landed
    assert ctx.iteration >= n_threads * k + 2
    assert ctx.result_at(6.0, 5.0).valid


def test_api_facade():
    api.init(CFG, scene=pv.demo_scene("SmallRoom"), background=False)
    try:
        api.set_listener_position(5.0, 0.0, 5.0)
        api.get_context().step()
        eid = api.emit(6.0, 0.0, 5.0)
        out = api.get_output(eid)
        assert out.valid
        gid = api.add_geometry(pv.AABB(5.5, 5.0, 0.4, 3.0, 0.9))
        api.update_geometry(gid, pv.AABB(5.5, 5.0, 0.5, 3.0, 0.9))
        api.remove_geometry(gid)
        api.update_emission(eid, 6.5, 0.0, 5.0)
        api.end_emission(eid)
        ir = api.get_impulse_response(6.0, 5.0)
        assert ir.size > 0
    finally:
        api.exit()
    assert api.get_output(0).occlusion == INVALID_DRY_GAIN


def test_change_settings_full_reinit():
    """ChangeSettings = full teardown + re-init (PvContext.cpp:45-49)."""
    import dataclasses

    api.init(CFG, background=False)
    try:
        first = api.get_context()
        cfg2 = dataclasses.replace(CFG, grid_size_x=6.0, grid_size_y=6.0)
        ctx2 = api.change_settings(cfg2)
        assert ctx2 is not first
        assert ctx2.params.grid_size_x == 6.0
        assert api.get_context() is ctx2
        # the new context is functional
        ctx2.set_listener_position(3.0, 0.0, 3.0)
        ctx2.step()
        assert ctx2.result_at(4.0, 3.0).valid
    finally:
        api.exit()


def test_lazy_directions_context_matches_default():
    ctx_a = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    ctx_b = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"),
                       lazy_directions=True)
    for ctx in (ctx_a, ctx_b):
        ctx.set_listener_position(5.0, 0.0, 5.0)
        ctx.step()
    a = ctx_a.result_at(6.5, 5.0)
    b = ctx_b.result_at(6.5, 5.0)
    assert a.occlusion == b.occlusion
    assert abs(a.direction.x - b.direction.x) < 1e-4
    assert abs(a.direction.y - b.direction.y) < 1e-4


def test_impulse_response_honors_grid_offset():
    """Regression: the IR probe must map world->cell through world_to_cell
    (grid offsets included) like every other accessor, and signal invalid
    (empty array) out of grid bounds instead of clamping (FDTD.cpp:60-70)."""
    import dataclasses

    cfg = dataclasses.replace(CFG, grid_offset_x=20.0, grid_offset_y=-4.0)
    ctx = pv.Context(cfg, scene=pv.demo_scene("SmallRoom"))
    # world x in [-20, -10), world z in [4, 14)
    ctx.set_listener_position(-15.0, 0.0, 9.0)
    ctx.step()

    ir = ctx.get_impulse_response(-14.0, 9.0)
    assert ir.shape == (ctx.params.response_length,)
    assert np.abs(ir).max() > 0
    # the probed cell is exactly the world_to_cell one (the published
    # recording is uncropped [T_pad, ...] — kept as the kernel output
    # buffer to avoid a per-step full-recording copy; the accessor crops)
    cx, cy = ctx.params.world_to_cell(-14.0, 9.0)
    np.testing.assert_array_equal(
        ir, ctx._published["pressure"][:ctx.params.response_length, cx, cy])

    # out of bounds -> empty, not edge-clamped
    assert ctx.get_impulse_response(5.0, 9.0).size == 0
    assert ctx.get_impulse_response(-15.0, 50.0).size == 0


def test_emit_time_attributes_flow_to_dsp():
    """Emit-time volume (dB->gain) and directivity pattern travel with the
    emission and reach the DSP side via Context.sync_dsp — the engine->DSP
    handoff of PlaneverbEmitter.cs:39-121."""
    from planeverb.core.emissions import Emission
    from planeverb.dsp import DSPContext, DirectivityPattern
    from planeverb.config import PlaneverbDSPConfig

    ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    ctx.set_listener_position(5.0, 0.0, 5.0)
    eid = ctx.emissions.emit(6.5, 0.0, 5.0, forward=(0.0, 0.0, 1.0),
                             volume_db=-6.0,
                             pattern=DirectivityPattern.CARDIOID)
    em = ctx.emissions.get_emission(eid)
    assert isinstance(em, Emission)
    assert em.volume_gain == pytest.approx(10 ** (-6.0 / 20.0))
    assert em.pattern == DirectivityPattern.CARDIOID

    # attribute-preserving position update; explicit attr updates stick
    ctx.emissions.update(eid, 6.0, 0.0, 5.0)
    em = ctx.emissions.get_emission(eid)
    assert em.position == (6.0, 0.0, 5.0) and em.volume_db == -6.0
    ctx.emissions.update(eid, 6.0, 0.0, 5.0, volume_db=+3.0)
    assert ctx.emissions.get_emission(eid).volume_db == 3.0

    ctx.step()
    dsp = DSPContext(PlaneverbDSPConfig())
    dsp.set_listener_transform((5.0, 0.0, 5.0), (1.0, 0.0, 0.0))
    synced = ctx.sync_dsp(dsp)
    out, gain = synced[eid]
    assert out.valid and gain == pytest.approx(10 ** (3.0 / 20.0))
    # the DSP target map now carries the emitter's transform + pattern
    tgt = dsp._target[eid]
    assert tgt.pattern == DirectivityPattern.CARDIOID
    assert tgt.position == (6.0, 5.0)


def test_session_roundtrip_keeps_emitter_attributes(tmp_path):
    from planeverb.session import save_session, load_session

    ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    ctx.set_listener_position(5.0, 0.0, 5.0)
    eid = ctx.emissions.emit(6.5, 0.0, 5.0, forward=(0.0, 0.0, -1.0),
                             volume_db=-12.0, pattern=1)
    p = tmp_path / "s.json"
    save_session(ctx, p)
    ctx2 = load_session(p)
    em = ctx2.emissions.get_emission(eid)
    assert em.position == (6.5, 0.0, 5.0)
    assert em.forward == (0.0, 0.0, -1.0)
    assert em.volume_db == -12.0 and em.pattern == 1


def test_cells_publish_mode_matches_grids():
    """publish='cells' (per-emitter row fetch, grid kept on device) must
    answer emitter queries and arbitrary probes identically to the default
    full-grid publish."""
    ctx_g = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"),
                       lazy_directions=False)
    ctx_c = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"),
                       publish="cells")
    eids = []
    for ctx in (ctx_g, ctx_c):
        ctx.set_listener_position(5.0, 0.0, 5.0)
        eids.append([ctx.emissions.emit(6.5, 0.0, 5.0),
                     ctx.emissions.emit(4.0, 0.0, 5.0)])
        ctx.step()
    for e_g, e_c in zip(*eids):
        a, b = ctx_g.get_output(e_g), ctx_c.get_output(e_c)
        assert a.valid and b.valid
        for f in ("occlusion", "wet_gain", "rt60", "lowpass"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-6), f
        assert a.direction.x == pytest.approx(b.direction.x, abs=1e-6)
    # arbitrary probe falls back to an on-demand single-row fetch
    a = ctx_g.result_at(5.5, 6.0)
    b = ctx_c.result_at(5.5, 6.0)
    assert b.valid and a.occlusion == pytest.approx(b.occlusion, rel=1e-6)
    # and is memoized in the snapshot cache
    cx, cy = ctx_c.params.world_to_cell(5.5, 6.0)
    assert (cx, cy) in ctx_c._published["cells"]
    # out-of-grid still invalid; IR accessor still works on device pressure
    assert not ctx_c.result_at(500.0, 500.0).valid
    ir = ctx_c.get_impulse_response(6.5, 5.0)
    assert ir.size == ctx_c.params.response_length and np.abs(ir).max() > 0
    # lazy directions are incompatible by construction
    with pytest.raises(ValueError, match="cells"):
        pv.Context(CFG, publish="cells", lazy_directions=True)
    with pytest.raises(ValueError, match="publish"):
        pv.Context(CFG, publish="nope")


def test_mesh_context_matches_single_device():
    """The multi-device engine: a Context constructed with a 2x4 device mesh
    routes step() through the sharded pipeline
    (parallel.pipeline_sharded) and must publish grids identical (within
    f32 reduction order) to the single-device Context on the same scene.

    This is the product-surface counterpart of
    tests/test_parallel.py::test_pipeline_sharded_matches_single_chip —
    the engine runtime itself spanning chips, not just the solver library.
    """
    import jax

    from planeverb.parallel import grid_mesh

    mesh = grid_mesh(jax.devices(), (2, 4))
    ctx_m = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"), mesh=mesh)
    ctx_1 = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    for ctx in (ctx_m, ctx_1):
        ctx.set_listener_position(5.0, 0.0, 5.0)
        ctx.step()
    a, b = ctx_m._published, ctx_1._published
    for key in ("occlusion", "wet_gain", "rt60", "lowpass",
                "direction", "source_directivity", "delay_samples"):
        np.testing.assert_allclose(a[key], b[key], rtol=2e-4, atol=1e-5,
                                   err_msg=key)
    # queries work identically through the public surface
    out_m, out_1 = ctx_m.result_at(6.0, 5.0), ctx_1.result_at(6.0, 5.0)
    assert out_m.valid
    assert out_m.occlusion == pytest.approx(out_1.occlusion, rel=1e-4)
    # IR accessor reads the sharded [T, nx_pad, ny_pad] recording
    ir_m = ctx_m.get_impulse_response(6.0, 5.0)
    ir_1 = ctx_1.get_impulse_response(6.0, 5.0)
    assert ir_m.shape == ir_1.shape
    np.testing.assert_allclose(ir_m, ir_1, atol=1e-6)
    # geometry edits re-shard the fields and change results
    gid = ctx_m.geometry.add(pv.AABB(5.5, 5.0, 0.4, 2.0, 0.9))
    ctx_m.step()
    assert ctx_m.result_at(6.0, 5.0).occlusion < out_m.occlusion
    ctx_m.geometry.remove(gid)


def test_mesh_context_cells_publish():
    """publish='cells' on a mesh Context: per-emitter rows come off the
    sharded packed grid in one gather."""
    import jax

    from planeverb.parallel import grid_mesh

    mesh = grid_mesh(jax.devices(), (2, 4))
    ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"), mesh=mesh,
                     publish="cells")
    ref = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"),
                     lazy_directions=False)
    for c in (ctx, ref):
        c.set_listener_position(5.0, 0.0, 5.0)
    eid = ctx.emissions.emit(6.5, 0.0, 5.0)
    for c in (ctx, ref):
        c.step()
    out = ctx.get_output(eid)
    want = ref.result_at(6.5, 5.0)
    assert out.valid
    for f in ("occlusion", "wet_gain", "rt60", "lowpass"):
        assert getattr(out, f) == pytest.approx(getattr(want, f),
                                                rel=2e-4), f
    # on-demand probe row off the device-resident sharded grid
    probe = ctx.result_at(4.0, 5.0)
    assert probe.valid
    assert probe.occlusion == pytest.approx(ref.result_at(4.0, 5.0).occlusion,
                                            rel=2e-4)


def test_mesh_context_validation():
    """Bad mesh axes / halo sizes fail fast at construction."""
    import jax
    from jax.sharding import Mesh

    from planeverb.parallel import grid_mesh

    mesh = grid_mesh(jax.devices(), (2, 4))
    with pytest.raises(ValueError, match="halo"):
        pv.Context(CFG, mesh=mesh, halo=1000)
    bad = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("a", "b"))
    with pytest.raises(ValueError, match="axes"):
        pv.Context(CFG, mesh=bad)


def test_multi_listener_mode():
    """Split-screen engine mode: B listeners batch in one step and each
    view's published grids match a single-listener Context at that
    position (core/context.py::_pipeline_packed_multi)."""
    positions = [(3.0, 0.0, 3.0), (7.0, 0.0, 6.0)]
    multi = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    multi.set_listener_positions(positions)
    assert multi.get_listener_positions() == positions
    multi.step()

    for i, (lx, ly, lz) in enumerate(positions):
        solo = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
        solo.set_listener_position(lx, ly, lz)
        solo.step()
        a = multi.result_at(6.0, 5.0, listener=i)
        b = solo.result_at(6.0, 5.0)
        assert a.valid and b.valid
        assert a.occlusion == pytest.approx(b.occlusion, rel=1e-6)
        assert a.rt60 == pytest.approx(b.rt60, rel=1e-6)
        assert a.direction.x == pytest.approx(b.direction.x, abs=1e-6)
        assert a.source_directivity.y == pytest.approx(
            b.source_directivity.y, abs=1e-6)

    # the two views genuinely differ (different listener -> different IR)
    v0 = multi.result_at(6.0, 5.0, listener=0)
    v1 = multi.result_at(6.0, 5.0, listener=1)
    assert abs(v0.occlusion - v1.occlusion) > 1e-4

    # emitter query per view; out-of-range view -> sentinel
    eid = multi.emissions.emit(6.0, 0.0, 5.0)
    assert multi.get_output(eid, listener=1).valid
    assert not multi.result_at(6.0, 5.0, listener=2).valid
    assert not multi.result_at(6.0, 5.0, listener=-1).valid
    # multi snapshots drop the recordings -> IR accessor signals empty
    assert multi.get_impulse_response(6.0, 5.0).size == 0

    # returning to one listener restores the single-listener path
    multi.set_listener_position(5.0, 0.0, 5.0)
    multi.step()
    assert multi.get_impulse_response(6.0, 5.0).size > 0
    assert not multi.result_at(6.0, 5.0, listener=1).valid


def test_multi_listener_validation():
    ctx = pv.Context(CFG)
    with pytest.raises(ValueError, match="at least one"):
        ctx.set_listener_positions([])
    with pytest.raises(ValueError, match="triples"):
        ctx.set_listener_positions([(1.0, 2.0)])
    # a single-element list is just the ordinary listener
    ctx.set_listener_positions([(4.0, 0.0, 4.0)])
    assert ctx.get_listener_position() == (4.0, 0.0, 4.0)
    assert ctx.get_listener_positions() == [(4.0, 0.0, 4.0)]


def test_multi_listener_on_mesh():
    """Split-screen on a mesh-sharded Context: every view rides the sharded
    pipeline (core/context.py::_pipeline_packed_multi_sharded) and matches
    the single-device multi-listener Context view for view."""
    import jax

    from planeverb.parallel import grid_mesh

    positions = [(3.0, 0.0, 3.0), (7.0, 0.0, 6.0)]
    mesh_ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"),
                          mesh=grid_mesh(jax.devices(), (2, 4)))
    ref_ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    for c in (mesh_ctx, ref_ctx):
        c.set_listener_positions(positions)
        c.step()
    for i in range(2):
        a = mesh_ctx.result_at(6.0, 5.0, listener=i)
        b = ref_ctx.result_at(6.0, 5.0, listener=i)
        assert a.valid and b.valid
        assert a.occlusion == pytest.approx(b.occlusion, rel=1e-5)
        assert a.rt60 == pytest.approx(b.rt60, rel=1e-5)
        assert a.direction.x == pytest.approx(b.direction.x, abs=1e-5)

    # cells publish on the mesh: same rows as the grids publish
    cells_ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"),
                           mesh=grid_mesh(jax.devices(), (2, 4)),
                           publish="cells")
    cells_ctx.set_listener_positions(positions)
    cells_ctx.emissions.emit(6.0, 0.0, 5.0)
    cells_ctx.step()
    for i in range(2):
        a = cells_ctx.result_at(6.0, 5.0, listener=i)
        b = mesh_ctx.result_at(6.0, 5.0, listener=i)
        assert a.valid and a.occlusion == pytest.approx(b.occlusion,
                                                        rel=1e-6)


def test_multi_listener_cells_publish():
    """Split-screen in the cells publish: per-view per-emitter rows in one
    [B, Q, 9] fetch (core/context.py::_pipeline_cells_multi) must match
    the grids-publish multi context view for view."""
    positions = [(3.0, 0.0, 3.0), (7.0, 0.0, 6.0)]
    cells_ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"),
                           publish="cells")
    grids_ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    for c in (cells_ctx, grids_ctx):
        c.set_listener_positions(positions)
        c.emissions.emit(6.0, 0.0, 5.0)
        c.step()
    for i in range(2):
        a = cells_ctx.result_at(6.0, 5.0, listener=i)
        b = grids_ctx.result_at(6.0, 5.0, listener=i)
        assert a.valid and a.occlusion == pytest.approx(b.occlusion,
                                                        rel=1e-6)
        assert a.rt60 == pytest.approx(b.rt60, rel=1e-6)
        assert a.direction.x == pytest.approx(b.direction.x, abs=1e-6)
    # probe outside the emitter set: on-demand per-view row fetch
    probe = cells_ctx.result_at(4.0, 4.0, listener=1)
    ref = grids_ctx.result_at(4.0, 4.0, listener=1)
    assert probe.valid and probe.occlusion == pytest.approx(ref.occlusion,
                                                            rel=1e-6)
    assert not cells_ctx.result_at(6.0, 5.0, listener=3).valid


def test_multi_listener_sync_dsp_per_view():
    """Each split-screen player's DSP sync pulls that view's parameters
    (Context.sync_dsp(dsp, listener=i))."""
    from planeverb.config import PlaneverbDSPConfig
    from planeverb.dsp import DSPContext

    ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    ctx.set_listener_positions([(5.0, 0.0, 5.0), (4.0, 0.0, 6.0)])
    eid = ctx.emissions.emit(6.5, 0.0, 5.0)
    ctx.step()
    cfg = PlaneverbDSPConfig(max_callback_length=256)
    r0 = ctx.sync_dsp(DSPContext(cfg), listener=0)
    r1 = ctx.sync_dsp(DSPContext(cfg), listener=1)
    assert r0[eid][0].valid and r1[eid][0].valid
    assert r0[eid][0].occlusion != r1[eid][0].occlusion
    assert r0[eid][0].occlusion == ctx.get_output(eid, listener=0).occlusion
    assert r1[eid][0].occlusion == ctx.get_output(eid, listener=1).occlusion


def test_listener_coverage_warning():
    """A listener far enough off-center that the IR length cannot cover the
    opposite corner triggers one loud RuntimeWarning
    (Context._warn_if_uncovered); centered listeners stay silent."""
    import warnings

    cfg = pv.PlaneverbConfig(grid_size_x=40.0, grid_size_y=40.0,
                             grid_resolution=275)
    ctx = pv.Context(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # centered: no warning
        ctx.set_listener_position(20.0, 0.0, 20.0)
    with pytest.warns(RuntimeWarning, match="covers"):
        ctx.set_listener_position(1.0, 0.0, 1.0)
    with warnings.catch_warnings():           # warned once, then quiet
        warnings.simplefilter("error")
        ctx.set_listener_position(0.5, 0.0, 0.5)


def test_default_listener_coverage_warning_on_first_step():
    """A Context stepped with the never-set default listener ((0,0,0) — a
    grid corner, the coverage worst case) gets the coverage warning on its
    first step() (ADVICE r4: previously only set_listener_position*
    evaluated it, so the default listener silently published never-found
    sentinels for far cells)."""
    import warnings

    cfg = pv.PlaneverbConfig(grid_size_x=40.0, grid_size_y=40.0,
                             grid_resolution=275)
    ctx = pv.Context(cfg)
    with pytest.warns(RuntimeWarning, match="covers"):
        ctx.step()
    with warnings.catch_warnings():           # once per context
        warnings.simplefilter("error")
        ctx.step()


def test_lazy_doa_threshold_r4():
    """After the gather-free DOA rewrite, full direction grids publish on
    device by default up to ~1M cells (LAZY_DOA_CELLS raised 16x in r4);
    the host-walk fallback remains for truly huge grids and by request."""
    from planeverb.core.context import LAZY_DOA_CELLS

    assert LAZY_DOA_CELLS == 1 << 20
    # 95 m @ LOW -> ~266^2 = ~71k cells: lazy under the old 65k threshold,
    # device DOA now
    cfg = pv.PlaneverbConfig(grid_size_x=95.0, grid_size_y=95.0,
                             grid_resolution=275)
    ctx = pv.Context(cfg)
    assert not ctx._lazy_doa
    assert ctx.params.grid_x * ctx.params.grid_y > (1 << 16)
    # explicit opt-in still works
    assert pv.Context(cfg, lazy_directions=True)._lazy_doa
