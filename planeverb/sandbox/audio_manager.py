"""Multi-source audio playback manager — PlaneverbAudioManager/Source analog.

The reference's Unity-side playback layer (/root/reference PlaneverbDSP/
PlaneverbDSPUnityPluginAPI/PlaneverbAudioManager.cs:26-49,
PlaneverbAudioSource.cs:116-183, PlaneverbReverb.cs:45-101) is a set of
components: a manager spawning one AudioSource per playing clip, each source
pulling its block from the clip (applying the emitter's volume gain, looping
or dying at clip end — a dead source ends its emission,
PlaneverbEmitter.cs:61-66), and the first reverb callback per audio frame
driving the whole DSP pipeline (collect every source -> SendSource each ->
ProcessOutput -> mix buses).

Here that layer is one host-side object: :class:`AudioSourceManager` tracks
playing clips keyed by source id, and ``process_block`` performs the
reference's per-callback drive — one engine->DSP sync, one SendSource per
live source, one GetOutput, one dry+reverb mix. It composes with
:class:`~planeverb.sandbox.realtime.RealtimePlayer`'s pacing by being the
block processor, and with a live background Context for moving emitters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["AudioSourceManager", "PlayingSource"]


@dataclasses.dataclass
class PlayingSource:
    """One playing clip bound to an emission (PlaneverbAudioSource state)."""

    eid: int
    clip: np.ndarray          # [N, 2] f32
    loop: bool
    read_index: int = 0
    playing: bool = True

    def next_block(self, frames: int) -> np.ndarray:
        """The next [frames, 2] block (PlaneverbAudioSource.GetSource):
        loops wrap, non-looping clips zero-pad their final block and stop."""
        n = len(self.clip)
        out = np.zeros((frames, 2), np.float32)
        got = 0
        while got < frames and self.playing:
            take = min(frames - got, n - self.read_index)
            out[got:got + take] = self.clip[self.read_index:
                                            self.read_index + take]
            got += take
            self.read_index += take
            if self.read_index >= n:
                if self.loop:
                    self.read_index = 0
                else:
                    self.playing = False
        return out


class AudioSourceManager:
    """Drives N playing sources through one DSP context per block.

    Args:
      ctx: live :class:`planeverb.Context`.
      dsp: a DSP context (``planeverb.dsp.DSPContext`` or
        ``planeverb.native.NativeDSPContext``).
      reverbs: optional sequence of per-bus reverbs with
        ``process_add(bus, mix)`` (e.g. ``NativeReverb`` for the three
        canonical decays); None mixes the dry bus only.
    """

    def __init__(self, ctx, dsp, reverbs=None):
        self.ctx = ctx
        self.dsp = dsp
        self.reverbs = list(reverbs) if reverbs else []
        self._sources: dict[int, PlayingSource] = {}
        self._next_sid = 0

    # -------------------------------------------------------------- control
    def play(self, eid: int, clip: np.ndarray, loop: bool = False) -> int:
        """Start a clip on emission ``eid`` (AudioManager.Play analog).
        Returns a source id. Multiple clips may share an emitter."""
        clip = np.asarray(clip, np.float32)
        if clip.ndim == 1:
            clip = np.stack([clip, clip], axis=-1)
        sid = self._next_sid
        self._next_sid += 1
        self._sources[sid] = PlayingSource(eid=eid, clip=clip, loop=loop)
        return sid

    def stop(self, sid: int, end_emission: bool = False) -> None:
        src = self._sources.pop(sid, None)
        if src is not None and end_emission:
            self.ctx.emissions.end(src.eid)

    def active_sources(self) -> list[int]:
        return sorted(self._sources)

    # ---------------------------------------------------------- audio frame
    def process_block(self, frames: int,
                      end_finished_emissions: bool = True) -> np.ndarray:
        """One audio callback (PlaneverbReverb.OnAudioFilterRead analog):
        sync the engine state into the DSP, submit every live source's next
        block, collect the buses, and mix dry + reverbs. Finished non-loop
        sources are removed; their emissions end like a dying
        PlaneverbAudioSource triggers OnEndEmission
        (PlaneverbEmitter.cs:61-66)."""
        synced = self.ctx.sync_dsp(self.dsp)
        finished = []
        for sid, src in self._sources.items():
            block = src.next_block(frames)
            if src.eid in synced:
                out, gain = synced[src.eid]
                self.dsp.submit_source(src.eid, out,
                                       block * np.float32(gain))
            if not src.playing:
                finished.append(sid)
        for sid in finished:
            src = self._sources.pop(sid)
            if end_finished_emissions:
                self.ctx.emissions.end(src.eid)

        # the buses and reverbs run EVERY callback regardless of live
        # sources (PlaneverbReverb.cs:45-101): the comb/allpass state holds
        # decaying tails that must keep flushing into the mix after the
        # last source ends, not freeze until the next one starts
        dry, wa, wb, wc = self.dsp.get_output()
        mix = np.array(dry[:frames], np.float32, copy=True)
        for rev, bus in zip(self.reverbs, (wa, wb, wc)):
            rev.process_add(np.asarray(bus[:frames], np.float32), mix)
        return mix
