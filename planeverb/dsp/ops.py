"""Batched JAX DSP renderer — many sources in one fused device call.

Vectorized device replacement for the reference's one-source-at-a-time audio-thread
loop (/root/reference PlaneverbDSP/src/PvDSPContext.cpp:250-425): all S
sources are rendered in parallel over a [S, N] block. Per-sample smoothing
recursions become closed-form geometric ramps (see dsp/gains.py); the only
true recurrence, the Butterworth biquad, runs as one lax.scan over the frame
axis carrying [S] filter memories. Output buses are summed over sources on
device.

Semantics match dsp/context.py (the streaming renderer) exactly; tests
cross-check the two block-for-block.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from planeverb.config import PlaneverbDSPConfig
from planeverb.dsp import gains
from planeverb.dsp.lowpass import process_scan

__all__ = ["SourceParams", "DSPState", "render_block", "init_state"]


class SourceParams(NamedTuple):
    """SoA per-source parameter set ([S] leading axis everywhere)."""

    occlusion: jax.Array       # [S]
    wet_gain: jax.Array        # [S]
    rt60: jax.Array            # [S]
    lowpass: jax.Array         # [S]
    direction: jax.Array       # [S, 2]
    position: jax.Array        # [S, 2]
    forward: jax.Array         # [S, 2]
    directivity: jax.Array     # [S, 2]
    pattern: jax.Array         # [S] int32 (0 omni, 1 cardioid)


class DSPState(NamedTuple):
    current: SourceParams
    lpf_y1: jax.Array          # [S]
    lpf_y2: jax.Array          # [S]


def init_state(num_sources: int) -> DSPState:
    """Default per-source state (EmissionData defaults,
    PlaneverbDSP EmissionManager.h:20-31)."""
    s = num_sources
    z2 = jnp.zeros((s, 2), jnp.float32)
    cur = SourceParams(
        occlusion=jnp.ones(s, jnp.float32),
        wet_gain=jnp.ones(s, jnp.float32),
        rt60=jnp.zeros(s, jnp.float32),
        lowpass=jnp.full(s, 20000.0, jnp.float32),
        direction=z2, position=z2, forward=z2, directivity=z2,
        pattern=jnp.ones(s, jnp.int32),
    )
    return DSPState(current=cur,
                    lpf_y1=jnp.zeros(s, jnp.float32),
                    lpf_y2=jnp.zeros(s, jnp.float32))


def _ramp(cur, tgt, factor, n):
    """[S] current/target -> [S, N] ramp + [S] final (shared gain math)."""
    return gains.lerp_ramp(cur, tgt, factor, n, xp=jnp)


@functools.partial(jax.jit, static_argnames=("config",))
def render_block(config: PlaneverbDSPConfig, audio, target: SourceParams,
                 state: DSPState, listener_pos, listener_fwd):
    """Render one block for all sources.

    Args:
      config: static DSP configuration.
      audio: [S, N, 2] stereo blocks (or [S, N] mono).
      target: latest per-source acoustic params.
      state: carried smoothing + filter state.
      listener_pos: [3], listener_fwd: [3].

    Returns:
      (buses, new_state) where buses = (dry, wetA, wetB, wetC), each [N, 2].
    """
    if audio.ndim == 2:
        mono_in = audio
    else:
        mono_in = (audio[..., 0] + audio[..., 1]) * 0.5
    s, n = mono_in.shape
    cur = state.current

    # input rejection (PvDSPContext.cpp:258-263): rejected sources render
    # silence and keep their current params/filters frozen
    valid = ((target.lowpass >= gains.MIN_AUDIBLE_FREQ)
             & (target.lowpass <= gains.MAX_AUDIBLE_FREQ)
             & (target.occlusion > 0.0)
             & ((target.direction[:, 0] != 0.0) | (target.direction[:, 1] != 0.0)))
    # extend the reference gate with finiteness: NaN passes every range
    # comparison above (NaN < x is false), and one non-finite param would
    # poison the cross-source bus sums for the whole batch
    valid = (valid
             & jnp.isfinite(target.occlusion) & jnp.isfinite(target.wet_gain)
             & jnp.isfinite(target.rt60) & jnp.isfinite(target.lowpass)
             & jnp.isfinite(target.direction).all(-1)
             & jnp.isfinite(target.position).all(-1)
             & jnp.isfinite(target.forward).all(-1)
             & jnp.isfinite(target.directivity).all(-1))

    # Sanitize rejected sources' params to their current values BEFORE any
    # math: a NaN/Inf param would otherwise flow through the filter/gain
    # chains, and NaN * 0 masking still poisons the cross-source bus sums
    # (the streaming renderer isolates invalid sources by early return).
    def _san(t, c):
        if t.ndim == 2:
            return jnp.where(valid[:, None], t, c)
        return jnp.where(valid, t, c)

    target = SourceParams(
        occlusion=_san(target.occlusion, cur.occlusion),
        wet_gain=_san(target.wet_gain, cur.wet_gain),
        rt60=_san(target.rt60, cur.rt60),
        lowpass=_san(target.lowpass, cur.lowpass),
        direction=_san(target.direction, cur.direction),
        position=_san(target.position, cur.position),
        forward=_san(target.forward, cur.forward),
        directivity=_san(target.directivity, cur.directivity),
        pattern=jnp.where(valid, target.pattern, cur.pattern))

    factor = jnp.float32(1.0 / (n * config.dsp_smoothing_factor))

    # wet-bus split
    tg = gains.find_wet_gains(target.rt60, target.wet_gain, xp=jnp)
    cg = gains.find_wet_gains(cur.rt60, cur.wet_gain, xp=jnp)

    # pan
    lfx = listener_fwd[0]
    lfz = listener_fwd[2]
    if config.use_spatialization:
        t_l, t_r = gains.pan_gains(target.direction[:, 0], target.direction[:, 1],
                                   lfx, lfz, xp=jnp)
        c_l, c_r = gains.pan_gains(cur.direction[:, 0], cur.direction[:, 1],
                                   lfx, lfz, xp=jnp)
    else:
        t_l = t_r = c_l = c_r = jnp.ones(s, jnp.float32)

    # source directivity (current map's pattern, target forward)
    def dir_gain(d, fwd):
        card = gains.cardioid(d[:, 0], d[:, 1], fwd[:, 0], fwd[:, 1], xp=jnp)
        return jnp.where(cur.pattern == 1, card, 1.0)

    t_dir = dir_gain(target.directivity, target.forward)
    c_dir = dir_gain(cur.directivity, target.forward)

    # distance attenuation
    lx = listener_pos[0]
    lz = listener_pos[2]
    t_dist = gains.distance_attenuation(lx, lz, target.position[:, 0],
                                        target.position[:, 1], xp=jnp)
    c_dist = gains.distance_attenuation(lx, lz, cur.position[:, 0],
                                        cur.position[:, 1], xp=jnp)

    t_dry = jnp.maximum(target.occlusion, gains.MIN_DRY_GAIN)
    c_dry = cur.occlusion

    # ---- lowpass all sources (one scan over the frame axis)
    mono_f, y1, y2 = process_scan(mono_in, state.lpf_y1, state.lpf_y2,
                                  target.lowpass, jnp.float32(config.sampling_rate))
    # frozen filters for rejected sources
    y1 = jnp.where(valid, y1, state.lpf_y1)
    y2 = jnp.where(valid, y2, state.lpf_y2)
    mono_f = jnp.where(valid[:, None], mono_f, 0.0)

    # ---- wet buses
    ratio = jnp.float32(config.wet_gain_ratio)
    wet_buses = []
    for cgi, tgi in zip(cg, tg):
        ramp, _ = _ramp(cgi, tgi, factor, n)
        wet = jnp.sum(mono_f * ramp, axis=0) * ratio       # [N]
        wet_buses.append(jnp.stack([wet, wet], axis=-1))   # [N, 2]

    # ---- dry chain
    dry_ramp, dry_final = _ramp(c_dry, t_dry, factor, n)
    dir_ramp, _ = _ramp(c_dir, t_dir, factor, n)
    dist_ramp, _ = _ramp(c_dist, t_dist, factor, n)
    dry = mono_f * (dry_ramp * dir_ramp * dist_ramp)       # [S, N]

    l_ramp, _ = _ramp(c_l, t_l, factor, n)
    r_ramp, _ = _ramp(c_r, t_r, factor, n)
    dry_bus = jnp.stack([jnp.sum(dry * l_ramp, axis=0),
                         jnp.sum(dry * r_ramp, axis=0)], axis=-1)

    # ---- settle current params toward targets (valid sources only)
    def settle(c, t):
        fin = gains.lerp_final(c, t, factor, n, xp=jnp)
        if c.ndim == 2:
            return jnp.where(valid[:, None], fin, c)
        return jnp.where(valid, fin, c)

    new_cur = SourceParams(
        occlusion=jnp.where(valid, dry_final, cur.occlusion),
        wet_gain=settle(cur.wet_gain, target.wet_gain),
        rt60=settle(cur.rt60, target.rt60),
        lowpass=jnp.where(valid, target.lowpass, cur.lowpass),
        direction=settle(cur.direction, target.direction),
        position=settle(cur.position, target.position),
        forward=settle(cur.forward, target.forward),
        directivity=settle(cur.directivity, target.directivity),
        pattern=jnp.where(valid, target.pattern, cur.pattern),
    )

    buses = (dry_bus, wet_buses[0], wet_buses[1], wet_buses[2])
    return buses, DSPState(current=new_cur, lpf_y1=y1, lpf_y2=y2)
