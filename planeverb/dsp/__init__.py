"""DSP module — acoustic parameter renderer (PlaneverbDSP analog).

Three renderers share one gain/filter math core (dsp/gains.py, dsp/lowpass.py):

  - :class:`DSPContext` (dsp/context.py): streaming per-callback renderer,
    NumPy, mirrors the reference audio-thread pipeline semantics.
  - :func:`render_block` (dsp/ops.py): batched JAX renderer — all sources in
    one fused device call, for offline/bulk rendering on the device.
  - the native C ABI renderer (planeverb/native): real-time audio-thread
    path with no Python in the callback.
"""

from planeverb.dsp.context import DirectivityPattern, DSPContext, EmissionParams
from planeverb.dsp.ops import DSPState, SourceParams, init_state, render_block

__all__ = [
    "DSPContext", "DirectivityPattern", "EmissionParams",
    "DSPState", "SourceParams", "init_state", "render_block",
]
