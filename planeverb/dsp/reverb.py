"""Schroeder reverberators for the three canonical wet buses.

The reference *intends* in-engine reverb but never ships it: its Reverb.h is
a non-compiling sketch (4 parallel lowpass-comb filters at 29.7/37.1/41.1/
43.7 ms, 2 series allpass at 5.0/1.7 ms — /root/reference PlaneverbDSP/src/
DSP/Reverb.h:4-25), and the shipped system routes the wet buses into Unity's
built-in reverbs with fixed 0.5 s / 1 s / 3 s decays (README.md:14,
PvDSPTypes.h:13-15). This module completes that design so the framework is
standalone: a classic Schroeder/Freeverb-topology reverb with comb feedback
derived from the target RT60 (g = 10^(-3 D / rt60)).

Two equivalent implementations, cross-checked in tests:
  - :func:`reverb_scan`: JAX lax.scan over the sample axis — the device batch
    path (states are [B, ...] so many reverb lines run in one scan).
  - the native C++ streaming version (planeverb/native, pv_reverb) for
    real-time callbacks.

:func:`mix_output` renders the final audible stereo mix the way the
reference's Unity mixer graph does: dry + sum of the three reverbed wet
buses (PlaneverbReverb.cs:45-101).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["COMB_DELAYS_S", "ALLPASS_DELAYS_S", "ALLPASS_G", "DAMPING",
           "comb_feedback", "ReverbParams", "reverb_params", "ReverbState",
           "init_reverb_state", "reverb_scan", "mix_output"]

# Reverb.h:16-24 sketch constants (classic Schroeder numbers)
COMB_DELAYS_S = (0.0297, 0.0371, 0.0411, 0.0437)
ALLPASS_DELAYS_S = (0.005, 0.0017)
ALLPASS_G = 0.5
DAMPING = 0.2


def comb_feedback(delay_s: float, rt60: float) -> float:
    """Feedback gain so a D-second loop decays 60 dB in rt60 seconds."""
    return float(10.0 ** (-3.0 * delay_s / max(rt60, 1e-3)))


class ReverbParams(NamedTuple):
    comb_delays: tuple      # samples, per comb
    comb_feedback: tuple    # per comb
    allpass_delays: tuple   # samples
    sample_rate: int
    rt60: float


def reverb_params(rt60: float, sample_rate: int) -> ReverbParams:
    cd = tuple(max(1, int(d * sample_rate)) for d in COMB_DELAYS_S)
    ad = tuple(max(1, int(d * sample_rate)) for d in ALLPASS_DELAYS_S)
    fb = tuple(comb_feedback(d / sample_rate, rt60) for d in cd)
    return ReverbParams(comb_delays=cd, comb_feedback=fb, allpass_delays=ad,
                        sample_rate=sample_rate, rt60=rt60)


class ReverbState(NamedTuple):
    """Carried filter memories ([B, ...] batch leading axis).

    comb_buf:  [B, 4, Lc] circular comb delay lines
    comb_lp:   [B, 4] one-pole damping filter memories
    ap_buf:    [B, 2, La] allpass delay lines
    pos:       scalar int32 running sample counter (shared phase)
    """

    comb_buf: object
    comb_lp: object
    ap_buf: object
    pos: object


def init_reverb_state(params: ReverbParams, batch: int = 1) -> ReverbState:
    import jax.numpy as jnp

    lc = max(params.comb_delays)
    la = max(params.allpass_delays)
    return ReverbState(
        comb_buf=jnp.zeros((batch, 4, lc), jnp.float32),
        comb_lp=jnp.zeros((batch, 4), jnp.float32),
        ap_buf=jnp.zeros((batch, 2, la), jnp.float32),
        pos=jnp.int32(0))


def reverb_scan(x, state: ReverbState, params: ReverbParams):
    """Run the reverb over [B, N] mono blocks.

    Returns ([B, N] wet output, new state). Deterministic streaming:
    concatenating outputs of consecutive blocks equals one long block.
    """
    import jax
    import jax.numpy as jnp

    b = x.shape[0]
    lc = state.comb_buf.shape[-1]
    la = state.ap_buf.shape[-1]
    cd = jnp.asarray(params.comb_delays, jnp.int32)        # [4]
    fb = jnp.asarray(params.comb_feedback, jnp.float32)    # [4]
    ad = jnp.asarray(params.allpass_delays, jnp.int32)     # [2]
    damp = jnp.float32(DAMPING)
    g = jnp.float32(ALLPASS_G)

    def step(carry, xt):
        comb_buf, comb_lp, ap_buf, pos = carry
        # parallel lowpass-comb bank (Reverb.h:27-141 design)
        rd = jnp.mod(pos - cd, lc)                          # [4]
        y = jnp.take_along_axis(comb_buf, rd[None, :, None],
                                axis=2)[:, :, 0]            # [B, 4]
        comb_lp = y * (1.0 - damp) + comb_lp * damp
        wr = comb_buf.at[:, jnp.arange(4), jnp.mod(pos, lc)].set(
            xt[:, None] + comb_lp * fb[None, :])
        comb_out = jnp.sum(y, axis=1) * jnp.float32(0.25)   # [B]

        # two series allpass
        s = comb_out
        rd_a = jnp.mod(pos - ad, la)                        # [2]
        new_ap = ap_buf
        for k in range(2):
            buf_out = new_ap[:, k, rd_a[k]]
            new_ap = new_ap.at[:, k, jnp.mod(pos, la)].set(s + buf_out * g)
            s = buf_out - g * s
        # wrap pos at lcm(lc, la): both index phases stay continuous while
        # the int32 counter never overflows (it would after ~13.5 h at
        # 44.1 kHz, discontinuously jumping every ring phase)
        return (wr, comb_lp, new_ap, jnp.mod(pos + 1, wrap)), s

    import math

    wrap = jnp.int32(math.lcm(lc, la))
    (comb_buf, comb_lp, ap_buf, pos), ys = jax.lax.scan(
        step, (state.comb_buf, state.comb_lp, state.ap_buf, state.pos), x.T)
    return ys.T, ReverbState(comb_buf=comb_buf, comb_lp=comb_lp,
                             ap_buf=ap_buf, pos=pos)


def mix_output(dry, wet_a, wet_b, wet_c, sample_rate: int,
               states=None):
    """Final audible stereo mix: dry + reverb(wetX) for the three canonical
    decays (the reference's Unity mixer graph, PlaneverbReverb.cs:45-101).

    Args: [N, 2] buses. Returns ([N, 2] mix, states) where states is a dict
    keyed by rt60 carrying reverb state across calls (pass back in).
    """
    import jax.numpy as jnp

    from planeverb.dsp.gains import T_ER_1, T_ER_2, T_ER_3

    rt60s = (T_ER_1, T_ER_2, T_ER_3)
    buses = (wet_a, wet_b, wet_c)
    if states is None:
        states = {}
    mix = jnp.asarray(dry, jnp.float32)
    for rt60, bus in zip(rt60s, buses):
        params = reverb_params(rt60, sample_rate)
        # key by (rt60, sample_rate): the delay-line sizes depend on the
        # rate, and reusing a state across a rate change would read ring
        # buffers at silently wrong (aliased) delays
        key = (rt60, sample_rate)
        st = states.get(key)
        if st is None:
            st = init_reverb_state(params, batch=2)
        x = jnp.asarray(bus, jnp.float32).T       # [2, N] L/R as batch
        wet, st = reverb_scan(x, st, params)
        states[key] = st
        mix = mix + wet.T
    return mix, states
