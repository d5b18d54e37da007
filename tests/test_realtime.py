"""Real-time playout harness tests (sandbox/realtime.py, AudioCore analog).

Pins the three properties the reference's PortAudio loop provides:
  - the A/B bypass toggle plays the raw source (AudioCore.cpp:98-143),
  - the processed path produces the dry+reverb mix block-for-block,
  - the full chain (engine output -> native DSP -> native reverbs) fits
    the 512-frame/44.1 kHz callback budget (Util.h:6-10) — the timing
    contract extended from tests/test_native_dsp.py to the whole chain.
"""

import numpy as np
import pytest

import planeverb as pv
from planeverb.sandbox.realtime import RealtimePlayer

CFG = pv.PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0,
                         grid_resolution=275)
RATE = 44100


@pytest.fixture(scope="module")
def ctx():
    c = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"))
    c.set_listener_position(5.0, 0.0, 5.0)
    c.step()
    return c


def _tone(seconds=0.25, freq=440.0, rate=RATE):
    t = np.arange(int(seconds * rate)) / rate
    x = (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    return np.stack([x, x], axis=-1)


def test_bypass_plays_raw_source_with_volume(ctx):
    audio = _tone()
    eid = ctx.emissions.emit(6.5, 0.0, 5.0, volume_db=-6.0)
    try:
        player = RealtimePlayer(ctx, eid, audio, RATE, frames=512,
                                use_planeverb=False)
        report = player.run(realtime=False)
        player.close()
    finally:
        ctx.emissions.end(eid)
    gain = 10 ** (-6.0 / 20.0)
    np.testing.assert_allclose(report.output, audio * np.float32(gain),
                               atol=1e-6)
    assert report.blocks == -(-len(audio) // 512)
    assert report.output.shape == audio.shape


def test_processed_path_matches_offline_chain(ctx):
    """The paced pump must produce exactly what the native DSP + reverbs
    produce when driven block-by-block directly (same state carryover)."""
    from planeverb.config import PlaneverbDSPConfig
    from planeverb.native import NativeDSPContext, NativeReverb
    from planeverb.dsp.gains import T_ER_1, T_ER_2, T_ER_3

    audio = _tone()
    eid = ctx.emissions.emit(6.5, 0.0, 5.0)
    try:
        player = RealtimePlayer(ctx, eid, audio, RATE, frames=512)
        report = player.run(realtime=False)
        player.close()

        dsp = NativeDSPContext(PlaneverbDSPConfig(max_callback_length=512,
                                                  sampling_rate=RATE))
        revs = [NativeReverb(r, RATE) for r in (T_ER_1, T_ER_2, T_ER_3)]
        chunks = []
        for start in range(0, len(audio), 512):
            block = audio[start:start + 512]
            synced = ctx.sync_dsp(dsp)
            out, gain = synced[eid]
            dsp.submit_source(eid, out, block * np.float32(gain))
            dry, wa, wb, wc = dsp.get_output()
            m = len(block)
            mix = np.array(dry[:m], np.float32, copy=True)
            for rev, bus in zip(revs, (wa, wb, wc)):
                rev.process_add(np.asarray(bus[:m], np.float32), mix)
            chunks.append(mix)
        dsp.close()
        for rev in revs:
            rev.close()
    finally:
        ctx.emissions.end(eid)
    expected = np.concatenate(chunks, axis=0)
    np.testing.assert_allclose(report.output, expected, atol=1e-6)
    assert float(np.abs(report.output).max()) > 0


def test_full_chain_fits_callback_budget(ctx):
    """Mean per-block processing must fit the real-time budget with heavy
    margin (reference callback: 512 frames / 44.1 kHz = 11.6 ms)."""
    audio = _tone(seconds=1.0)
    eid = ctx.emissions.emit(6.0, 0.0, 5.0)
    try:
        player = RealtimePlayer(ctx, eid, audio, RATE, frames=512)
        report = player.run(realtime=False)
        player.close()
    finally:
        ctx.emissions.end(eid)
    assert report.blocks == -(-len(audio) // 512)
    # generous CI margin: mean must be under half the budget
    assert report.mean_process_ms < report.budget_ms / 2, report.summary()


def test_realtime_pacing_spans_clip_duration(ctx):
    """With pacing on, wall time must cover the audio duration (blocks are
    delivered at their deadlines, not as fast as possible)."""
    audio = _tone(seconds=0.2)
    eid = ctx.emissions.emit(6.0, 0.0, 5.0)
    try:
        player = RealtimePlayer(ctx, eid, audio, RATE, frames=512,
                                reverb=False)
        report = player.run(realtime=True)
        player.close()
    finally:
        ctx.emissions.end(eid)
    assert report.realtime
    assert report.wall_s >= report.duration_s * 0.9


def test_python_dsp_fallback_runs(ctx):
    audio = _tone(seconds=0.05)
    eid = ctx.emissions.emit(6.0, 0.0, 5.0)
    try:
        player = RealtimePlayer(ctx, eid, audio, RATE, frames=512,
                                native=False)
        report = player.run(realtime=False)
    finally:
        ctx.emissions.end(eid)
    assert float(np.abs(report.output).max()) > 0
    assert report.output.shape[0] == len(audio)


def test_audio_device_sink_guarded():
    """AudioDeviceSink is the optional live-output path (the reference's
    PortAudio stream, AudioCore.cpp:28-42). Without the optional
    `sounddevice` package it must fail loudly with install guidance, not
    ImportError-crash at import time."""
    import importlib.util

    from planeverb.sandbox.realtime import AudioDeviceSink

    if importlib.util.find_spec("sounddevice") is not None:
        pytest.skip("sounddevice installed; device behavior not testable "
                    "in CI (no audio hardware)")
    with pytest.raises(RuntimeError, match="sounddevice"):
        AudioDeviceSink(rate=44100)
