"""2nd-order Butterworth lowpass (reference PlaneverbDSP/src/DSP/Lowpass.h).

Coefficient law (Lowpass.h:14-26): with T = 2*pi*cutoff / fs and
Y = 1/(1 + sqrt(2) T + T^2):

    y[n] = (T^2 Y) x[n] + (2 + sqrt(2) T) Y y[n-1] - Y y[n-2]

Three implementations share this law:
  - ``coefficients``: the pure coefficient function
  - ``process``:      streaming numpy biquad with persistent state
  - ``process_scan``: batched jax.lax.scan biquad over [S, N] blocks — the
    device path, vectorized across sources with the recurrence carried over N.
"""

from __future__ import annotations

import numpy as np

SQRT_2 = 1.4142136
PI = 3.141593

__all__ = ["coefficients", "LowpassState", "process", "process_scan"]


def coefficients(cutoff_hz, sampling_rate, xp=np):
    """Returns (cx, cy1, cy2) Butterworth coefficients (Lowpass.h:14-26)."""
    t = 2.0 * xp.float32(PI) * cutoff_hz / sampling_rate
    y = 1.0 / (1.0 + xp.float32(SQRT_2) * t + t * t)
    cx = t * t * y
    cy1 = (2.0 + xp.float32(SQRT_2) * t) * y
    cy2 = -1.0 * y
    return cx, cy1, cy2


class LowpassState:
    """Persistent filter memory for the streaming path (y[n-1], y[n-2])."""

    def __init__(self):
        self.y1 = np.float32(0.0)
        self.y2 = np.float32(0.0)


def process(x: np.ndarray, state: LowpassState, cutoff_hz: float,
            sampling_rate: float) -> np.ndarray:
    """Filter a mono block in place-semantics (returns new array), updating
    ``state``. Matches the reference's net behavior: coefficients are set
    directly from the submitted cutoff (SetCutoff before Process makes the
    reference's coefficient lerp a no-op — PvDSPContext.cpp:286,354).

    The recursion y[n] = cx*x[n] + cy1*y[n-1] + cy2*y[n-2] is evaluated with
    scipy's C lfilter (the same IIR with a = [1, -cy1, -cy2]) — a per-sample
    Python loop here would dominate every submit_source call.
    """
    from scipy.signal import lfilter

    cx, cy1, cy2 = coefficients(np.float32(cutoff_hz),
                                np.float32(sampling_rate))
    # direct-form II transposed initial conditions reproducing the carried
    # (y[-1], y[-2]) memory: z0 = cy1*y1 + cy2*y2, z1 = cy2*y1
    zi = np.array([cy1 * state.y1 + cy2 * state.y2, cy2 * state.y1],
                  np.float32)
    out, zf = lfilter(np.array([cx], np.float32),
                      np.array([1.0, -cy1, -cy2], np.float32),
                      np.asarray(x, np.float32), zi=zi)
    out = out.astype(np.float32)
    if len(x) >= 2:
        state.y1, state.y2 = np.float32(out[-1]), np.float32(out[-2])
    elif len(x) == 1:
        state.y1, state.y2 = np.float32(out[-1]), state.y1
    return out


def process_scan(x, y1, y2, cutoff_hz, sampling_rate):
    """Batched biquad over [S, N] via lax.scan.

    Args:
      x: [S, N] mono blocks.
      y1, y2: [S] carried filter memories.
      cutoff_hz: [S] per-source cutoffs.
    Returns (filtered [S, N], y1', y2').
    """
    import jax
    import jax.numpy as jnp

    cx, cy1, cy2 = coefficients(cutoff_hz.astype(jnp.float32),
                                jnp.float32(sampling_rate), xp=jnp)

    def step(carry, xt):
        y1, y2 = carry
        v = cx * xt + cy1 * y1 + cy2 * y2
        return (v, y1), v

    (y1f, y2f), ys = jax.lax.scan(step, (y1, y2), x.T)
    return ys.T, y1f, y2f
