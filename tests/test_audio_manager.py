"""Multi-source playback manager tests (sandbox/audio_manager.py).

PlaneverbAudioManager/AudioSource analog: clip block pulls with looping and
end-of-clip death, emission teardown on finish (PlaneverbEmitter.cs:61-66),
and the one-callback-drives-everything mix (PlaneverbReverb.cs:45-101).
"""

import numpy as np
import pytest

import planeverb as pv
from planeverb.config import PlaneverbDSPConfig
from planeverb.sandbox.audio_manager import (AudioSourceManager,
                                             PlayingSource)

CFG = pv.PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0,
                         grid_resolution=275)
RATE = 44100


@pytest.fixture(scope="module")
def ctx():
    c = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    c.set_listener_position(5.0, 0.0, 5.0)
    c.step()
    return c


def _mgr(ctx, native=True):
    cfg = PlaneverbDSPConfig(max_callback_length=512, sampling_rate=RATE)
    if native:
        from planeverb.native import NativeDSPContext, NativeReverb
        from planeverb.dsp.gains import T_ER_1, T_ER_2, T_ER_3

        return AudioSourceManager(
            ctx, NativeDSPContext(cfg),
            reverbs=[NativeReverb(r, RATE) for r in (T_ER_1, T_ER_2, T_ER_3)])
    from planeverb.dsp import DSPContext

    return AudioSourceManager(ctx, DSPContext(cfg))


def _tone(frames, freq=440.0):
    t = np.arange(frames) / RATE
    x = (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    return np.stack([x, x], axis=-1)


class TestPlayingSource:
    def test_blocks_then_death(self):
        clip = _tone(700)
        src = PlayingSource(eid=0, clip=clip, loop=False)
        b1 = src.next_block(512)
        np.testing.assert_array_equal(b1, clip[:512])
        b2 = src.next_block(512)  # 188 real + zero pad, then stops
        np.testing.assert_array_equal(b2[:188], clip[512:])
        assert not b2[188:].any()
        assert not src.playing

    def test_looping_wraps(self):
        clip = _tone(300)
        src = PlayingSource(eid=0, clip=clip, loop=True)
        b = src.next_block(512)
        np.testing.assert_array_equal(b[:300], clip)
        np.testing.assert_array_equal(b[300:], clip[:212])
        assert src.playing and src.read_index == 212


def test_two_sources_mix_and_finish(ctx):
    mgr = _mgr(ctx)
    e1 = ctx.emissions.emit(6.5, 0.0, 5.0)
    e2 = ctx.emissions.emit(4.0, 0.0, 5.0, volume_db=-6.0)
    s1 = mgr.play(e1, _tone(2048, 440.0))
    s2 = mgr.play(e2, _tone(700, 880.0))  # dies on block 2
    assert mgr.active_sources() == [s1, s2]

    m1 = mgr.process_block(512)
    assert m1.shape == (512, 2) and np.abs(m1).max() > 0
    mgr.process_block(512)  # second block finishes s2
    assert mgr.active_sources() == [s1]
    # the finished source's emission ended (PlaneverbEmitter.cs:61-66)
    assert ctx.emissions.get(e2) is None
    assert ctx.emissions.get(e1) is not None

    # drain s1 (2048 frames = 4 blocks total, two consumed)
    mgr.process_block(512)
    mgr.process_block(512)
    assert mgr.active_sources() == []
    assert ctx.emissions.get(e1) is None
    # no sources left: the reverb tails keep flushing every callback
    # (PlaneverbReverb runs regardless of live sources) and decay away
    tail0 = float(np.abs(mgr.process_block(512)).max())
    for _ in range(200):
        tail = float(np.abs(mgr.process_block(512)).max())
    assert tail < tail0 * 0.5 or tail0 == 0.0


def test_single_source_matches_realtime_player(ctx):
    """One source through the manager == the RealtimePlayer chain (same
    per-block drive), pinning the two surfaces to each other."""
    from planeverb.sandbox.realtime import RealtimePlayer

    audio = _tone(1536)
    eid = ctx.emissions.emit(6.5, 0.0, 5.0, volume_db=-3.0)
    try:
        mgr = _mgr(ctx)
        mgr.play(eid, audio)
        # keep the emission alive: the player below reuses it
        got = np.concatenate(
            [mgr.process_block(512, end_finished_emissions=False)
             for _ in range(3)], axis=0)

        player = RealtimePlayer(ctx, eid, audio, RATE, frames=512)
        report = player.run(realtime=False)
        player.close()
    finally:
        ctx.emissions.end(eid)
    np.testing.assert_allclose(got, report.output, atol=1e-6)


def test_python_dsp_path(ctx):
    mgr = _mgr(ctx, native=False)
    eid = ctx.emissions.emit(6.0, 0.0, 5.0)
    try:
        mgr.play(eid, _tone(512))
        m = mgr.process_block(512)
    finally:
        ctx.emissions.end(eid)
    assert m.shape == (512, 2) and np.abs(m).max() > 0


def test_eid_reuse_does_not_inherit_dsp_state(ctx):
    """Emission ids are free-list-reused; sync_dsp must drop the dead
    emitter's DSP interpolation state so the reused id starts fresh
    (a CARDIOID pattern or stale pan from the old sound must not apply)."""
    from planeverb.dsp import DSPContext, DirectivityPattern
    from planeverb.config import PlaneverbDSPConfig

    dsp = DSPContext(PlaneverbDSPConfig(max_callback_length=512))
    dsp.set_listener_transform((5.0, 0.0, 5.0), (1.0, 0.0, 0.0))

    e1 = ctx.emissions.emit(6.5, 0.0, 5.0,
                            pattern=DirectivityPattern.CARDIOID)
    ctx.sync_dsp(dsp)
    assert dsp._target[e1].pattern == DirectivityPattern.CARDIOID
    ctx.emissions.end(e1)
    ctx.sync_dsp(dsp)                     # the end is observed here
    assert e1 not in dsp._target and e1 not in dsp._current

    e2 = ctx.emissions.emit(4.0, 0.0, 5.0)   # free-list reuses e1's id
    assert e2 == e1
    ctx.sync_dsp(dsp)
    assert dsp._target[e2].pattern == DirectivityPattern.OMNI
    ctx.emissions.end(e2)
    ctx.sync_dsp(dsp)
