"""Smoke test of the engine on NVIDIA GPUs: the main path at full width.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the mesh engine only

One process drives the card(s) and spawns nothing that touches them. Each
phase prints one JSON line; the card's name and power limit (as
``nvidia-smi`` reports them) come before the phases, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

The script exits non-zero without that line when JAX finds no GPU (or
fewer than the cards asked for), when it runs outside a checkout, or when
any phase fails. Phases (one card):

  - kernels: the blocked Pallas kernels (ops/fdtd_blocked.py) against the
    plain lax.scan solver (at its fixed unroll, fdtd.SCAN_UNROLL) and jnp
    moments on the same card, at the 25 m (192^2 x 1187) and 60 m
    (459^2 x 1470) widths; medians of the plain pass, of the scan with the
    moments kernel, of the sim kernel with the jnp moments, and of both
    kernels — each kernel is kept only if it beats the pass without it;
  - server: EngineServer + EngineClient drive a HugeRoom session at
    25 m / 750 Hz; the published grids are checked against the same pass
    on the CPU in this process, and one 512-frame DSP block is rendered;
  - split_screen: B=4 listeners in one step equal four single steps;
  - large: one Context.step() each at 60 m and 126 m (964^2 x 2006,
    a 7.46 GB recording), with seconds and peak device memory;
  - compile: seconds spent compiling (shorter on a warm compile cache).

``--four``: Context(mesh=...) on 2x2 and 4x1 meshes at 60 m / 750 Hz
against the one-card Context, publish parity at rtol=2e-4, atol=1e-5, and
the seconds per step() of each.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAM_KEYS = ("occlusion", "wet_gain", "rt60", "lowpass", "direction",
              "source_directivity")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def world(size_m, resolution=750):
    from planeverb.config import PlaneverbConfig

    return PlaneverbConfig(grid_size_x=size_m, grid_size_y=size_m,
                           grid_resolution=resolution)


def listener_of(cfg):
    """The listener of every phase: the world's centre, moved 1 m off
    HugeRoom's interior divider (which runs through the 25 m centre)."""
    return cfg.grid_size_x / 2, cfg.grid_size_y / 2 + 1.0


def phase_kernels():
    """Blocked kernels vs lax.scan + jnp moments on the same card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from planeverb.config import compute_grid_params, gaussian_pulse
    from planeverb.ops import analyzer, fdtd, fdtd_blocked, pipeline, voxelize
    from planeverb.scene import demo_scene
    from planeverb.utils.profiling import time_block

    @functools.partial(jax.jit, static_argnums=0)
    def plain(p, beta, refl, pulse, cix, ciy):
        res = fdtd.simulate(p, beta, refl, pulse, cix, ciy)
        return res, analyzer.moments_from_pressure(p, res.pressure,
                                                   res.onset)

    @functools.partial(jax.jit, static_argnums=0)
    def scan_moments_kernel(p, beta, refl, pulse, cix, ciy):
        res = fdtd.simulate(p, beta, refl, pulse, cix, ciy)
        rec = res.pressure.reshape(p.response_length, 1, 1, p.nx, p.ny)
        return res, fdtd_blocked.moments_blocked(p, rec, res.onset[None])

    @functools.partial(jax.jit, static_argnums=0)
    def sim_kernel_jnp_moments(p, beta, refl, pulse, lc):
        res = pipeline.simulate_kernel(p, beta, refl, pulse, lc)
        return res, analyzer.moments_from_pressure(p, res.pressure[0],
                                                   res.onset[0])

    @functools.partial(jax.jit, static_argnums=0)
    def kernel(p, beta, refl, pulse, lc):
        rec, onset, fx, fy = fdtd_blocked.simulate_blocked(
            p, beta, refl, pulse, lc)
        return rec, onset, fx, fy, fdtd_blocked.moments_blocked(p, rec, onset)

    for size in (25.0, 60.0):
        p = compute_grid_params(world(size))
        b, r = voxelize.voxelize_np(p, demo_scene("HugeRoom").boxes)
        beta, refl = jnp.asarray(b), jnp.asarray(r)
        pulse = jnp.asarray(gaussian_pulse(p))
        cix, ciy = p.world_to_cell(*listener_of(p))
        lc = jnp.asarray([[cix, ciy]], jnp.int32)

        ref, mref = plain(p, beta, refl, pulse, cix, ciy)
        rec, onset, fx, fy, mom = kernel(p, beta, refl, pulse, lc)
        lay = fdtd_blocked.blocked_layout(p)
        o, T = lay.origin, p.response_length

        def crop(a):
            return np.asarray(a)[0, o:o + p.nx, o:o + p.ny]

        pk = np.asarray(rec)[:, 0].reshape(lay.t_pad, lay.nxp, lay.nyp)
        pk = pk[:T, o:o + p.nx, o:o + p.ny]
        pr = np.asarray(ref.pressure)
        peak = float(np.abs(pr).max())
        check(peak > 0, f"{size} m: silent recording")
        p_err = float(np.abs(pk - pr).max())
        check(p_err <= 1e-5 * peak,
              f"{size} m: pressure max|diff| {p_err} > 1e-5 * {peak}")
        # the GPU compilers may contract a*b+c into one FMA in one path and
        # not the other; that moves a threshold crossing by at most one
        # step on a few cells
        on_k, on_r = crop(onset), np.asarray(ref.onset)
        moved = on_k != on_r
        frac = float(moved.mean())
        check(frac <= 1e-3, f"{size} m: onset differs on {frac:.2%} cells")
        if moved.any():
            check(float(np.abs(on_k - on_r)[moved].max()) <= 1.0,
                  f"{size} m: onset moved by more than one step")
        for got, want, name in ((fx, ref.flux_x, "flux_x"),
                                (fy, ref.flux_y, "flux_y")):
            want = np.asarray(want)
            err = float(np.abs(crop(got) - want).max())
            check(err <= 1e-5 * float(np.abs(want).max()) + 1e-30,
                  f"{size} m: {name} max|diff| {err}")
        _, mscan = scan_moments_kernel(p, beta, refl, pulse, cix, ciy)
        for name in mom._fields:
            b_ = np.asarray(getattr(mref, name))
            for a, on in ((crop(getattr(mom, name)), ~moved),
                          (np.asarray(getattr(mscan, name))[0],
                           np.ones_like(moved))):
                ok = np.isclose(a, b_, rtol=1e-4,
                                atol=1e-7 * float(np.abs(b_).max()))
                check(ok[on].all(), f"{size} m: moment {name} off rtol 1e-4")

        t_kernel = time_block(
            lambda: kernel(p, beta, refl, pulse, lc))["median_s"]
        t_scan_mk = time_block(lambda: scan_moments_kernel(
            p, beta, refl, pulse, cix, ciy))["median_s"]
        t_sk_jnp = time_block(lambda: sim_kernel_jnp_moments(
            p, beta, refl, pulse, lc))["median_s"]
        t_plain = time_block(
            lambda: plain(p, beta, refl, pulse, cix, ciy))["median_s"]
        emit("kernels", grid=[p.nx, p.ny], T=T,
             kernel_median_s=t_kernel,
             scan_moments_kernel_median_s=t_scan_mk,
             sim_kernel_jnp_moments_median_s=t_sk_jnp,
             plain_median_s=t_plain, scan_unroll=fdtd.SCAN_UNROLL,
             pressure_max_abs_diff=p_err, pressure_peak=peak,
             onset_moved_fraction=frac,
             # the solver path has no matrix products, so TF32 never applies
             tf32="not applicable")


def _grids(ctx):
    """Published grids of a Context, in either publish mode."""
    import numpy as np

    from planeverb.core.context import _grids_dict

    pub = ctx._published
    if "packed_device" in pub:
        return _grids_dict(np.asarray(pub["packed_device"]))
    return {k: np.asarray(pub[k]) for k in PARAM_KEYS + ("delay_samples",)}


def compare_golden(got, ref):
    """Published grids vs the CPU reference, with the golden tolerances of
    tests/test_golden_scenes.py, on the cells whose onset agrees (see the
    FMA note in phase_kernels); returns the fraction of moved cells."""
    import numpy as np

    moved = got["delay_samples"] != ref["delay_samples"]
    frac = float(moved.mean())
    check(frac <= 1e-3, f"delay differs from the CPU on {frac:.2%} cells")
    keep = ~moved
    tol = {"occlusion": (2e-4, 1e-5), "wet_gain": (2e-4, 1e-5),
           "lowpass": (2e-4, 1e-2), "source_directivity": (1e-3, 1e-4)}
    for key, (rtol, atol) in tol.items():
        np.testing.assert_allclose(got[key][keep], ref[key][keep],
                                   rtol=rtol, atol=atol, err_msg=key)
    valid = keep & (ref["rt60"] > 0.01) & (ref["rt60"] < 100.0)
    check(valid.any(), "no cell with a defined RT60")
    np.testing.assert_allclose(got["rt60"][valid], ref["rt60"][valid],
                               rtol=5e-3, err_msg="rt60")
    return frac


def phase_server():
    """Main path through the server at 25 m / 750 Hz, checked on the CPU."""
    import jax
    import numpy as np

    from planeverb.config import PlaneverbDSPConfig
    from planeverb.core import free_grid
    from planeverb.core.context import Context
    from planeverb.dsp import DSPContext
    from planeverb.scene import demo_scene
    from planeverb.server import EngineClient, EngineServer
    from planeverb.types import PlaneverbOutput, vec2

    cfg = world(25.0)
    size = cfg.grid_size_x
    lx, lz = listener_of(cfg)
    srv = EngineServer(port=0)
    srv.start_background()
    cli = EngineClient(*srv.address)
    try:
        def call(cmd, **kw):
            resp = cli.call(cmd, **kw)
            check(resp.get("ok"), f"server {cmd}: {resp}")
            return resp

        call("init", grid_size_x=size, grid_size_y=size,
             grid_resolution=cfg.grid_resolution, background=False)
        boxes = demo_scene("HugeRoom").boxes
        for box in boxes:
            call("add_geometry", x=box.x, y=box.y, width=box.width,
                 height=box.height, absorption=box.absorption)
        call("set_listener_position", x=lx, y=0.0, z=lz)
        sources = [(lx + 0.14 * size, lz), (lx - 0.26 * size, lz + 0.2 * size),
                   (lx + 0.3 * size, lz - 0.3 * size)]
        ids = [call("emit", x=x, y=0.0, z=z)["id"] for x, z in sources]
        t0 = time.perf_counter()
        call("step")
        first_step_s = time.perf_counter() - t0
        outs = call("get_outputs")
        rows = np.asarray(outs["rows"], np.float64).reshape(-1, 9)
        check(outs["count"] == len(ids) and np.isfinite(rows).all()
              and (rows[:, 8] == 1.0).all(), f"invalid outputs {rows}")
        ir = np.asarray(call("get_impulse_response", x=sources[0][0],
                             z=sources[0][1])["ir"])
        T = srv._ctx.params.response_length
        check(ir.shape == (T,) and np.isfinite(ir).all()
              and np.abs(ir).max() > 0, "impulse response empty or bad")
        got = _grids(srv._ctx)

        # the same pass on the CPU, in this process: the plain reference,
        # free-field calibration included (EFree normalises occlusion and
        # wet gain, so the CPU must not reuse the card's cached value)
        free_grid.clear_cache()
        with jax.default_device(jax.devices("cpu")[0]):
            ref_ctx = Context(srv._ctx.config, scene=demo_scene("HugeRoom"))
            ref_ctx.set_listener_position(lx, 0.0, lz)
            ref_ctx.step()
            ref = _grids(ref_ctx)
        free_grid.clear_cache()
        efree, efree_cpu = srv._ctx.efree, ref_ctx.efree
        check(abs(efree - efree_cpu) <= 2e-4 * abs(efree_cpu),
              f"EFree {efree} differs from the CPU's {efree_cpu}")
        moved = compare_golden(got, ref)

        # one 512-frame DSP block from the served parameters
        dsp = DSPContext(PlaneverbDSPConfig(max_callback_length=512))
        fs = dsp.config.sampling_rate
        dsp.set_listener_transform((lx, 0.0, lz), (1.0, 0.0, 0.0))
        tone = (0.5 * np.sin(2 * np.pi * 440 * np.arange(512) / fs)
                ).astype(np.float32)
        for eid, (x, z), row in zip(ids, sources, rows):
            out = PlaneverbOutput(
                occlusion=row[0], wet_gain=row[1], rt60=row[2],
                lowpass=row[3], direction=vec2(row[4], row[5]),
                source_directivity=vec2(row[6], row[7]))
            dsp.update_emitter(eid, (x, 0.0, z), (-1.0, 0.0, 0.0))
            dsp.submit_source(eid, out, np.stack([tone, tone], -1))
        buses = dsp.get_output()
        check(all(np.isfinite(bus).all() for bus in buses)
              and max(float(np.abs(bus).max()) for bus in buses) > 0,
              "DSP block silent or not finite")
        call("bye")
    finally:
        cli.close()
        srv.shutdown()
    emit("server", grid=list(got["occlusion"].shape),
         emitters=len(ids), first_step_s=first_step_s,
         cpu_reference="same pass on jax.devices('cpu')",
         efree=efree, efree_cpu=efree_cpu,
         delay_moved_fraction=moved, dsp_block_frames=512)


def phase_split_screen():
    import numpy as np

    from planeverb.core.context import Context
    from planeverb.scene import demo_scene

    cfg = world(25.0)
    lx, lz = listener_of(cfg)
    views = [(lx, 0.0, lz), (lx - 2.5, 0.0, lz + 1.5),
             (lx + 1.5, 0.0, lz + 2.5), (lx - 1.0, 0.0, lz - 3.5)]
    ctx = Context(cfg, scene=demo_scene("HugeRoom"))
    ctx.set_listener_positions(views)
    ctx.step()
    multi = _grids(ctx)
    for i, view in enumerate(views):
        ctx.set_listener_position(*view)
        ctx.step()
        one = _grids(ctx)
        for key in PARAM_KEYS + ("delay_samples",):
            np.testing.assert_allclose(multi[key][i], one[key], rtol=1e-5,
                                       atol=1e-6, err_msg=f"view {i} {key}")
    emit("split_screen", listeners=len(views), grid=list(one["rt60"].shape),
         parity="rtol=1e-5, atol=1e-6 vs single-listener steps")


def phase_large():
    import jax
    import numpy as np

    from planeverb.core.context import Context
    from planeverb.scene import demo_scene

    dev = jax.devices()[0]
    for size in (60.0, 126.0):
        cfg = world(size)
        ctx = Context(cfg, scene=demo_scene("HugeRoom"))
        lx, lz = listener_of(cfg)
        ctx.set_listener_position(lx, 0.0, lz)
        t0 = time.perf_counter()
        ctx.step()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        ctx.step()
        second = time.perf_counter() - t0
        g = _grids(ctx)
        found = np.isfinite(g["delay_samples"]) & (
            g["delay_samples"] < np.finfo(np.float32).max)
        check(found.mean() > 0.5, f"{size} m: few cells reached")
        for key in PARAM_KEYS:
            check(np.isfinite(g[key]).all(), f"{size} m: {key} not finite")
        check(ctx.result_at(lx + 2.0, lz).valid, f"{size} m: probe invalid")
        p = ctx.params
        emit("large", world_m=size, grid=[p.nx, p.ny], T=p.response_length,
             recording_bytes=p.nx * p.ny * p.response_length * 4,
             first_step_s=first, step_s=second,
             peak_bytes_in_use=dev.memory_stats()["peak_bytes_in_use"])
        del ctx, g
        gc.collect()


def phase_four():
    """Mesh Context on 2x2 and 4x1 against the one-card Context."""
    import jax
    import numpy as np

    from planeverb.core.context import Context
    from planeverb.parallel import grid_mesh
    from planeverb.scene import demo_scene

    cfg = world(60.0)
    lx, lz = listener_of(cfg)
    devs = jax.devices()[:4]

    def run(mesh):
        ctx = Context(cfg, scene=demo_scene("HugeRoom"), mesh=mesh)
        ctx.set_listener_position(lx, 0.0, lz)
        ctx.step()                       # compiles
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ctx.step()
            times.append(time.perf_counter() - t0)
        return ctx, float(np.median(times))

    one, t_one = run(None)
    ref = _grids(one)
    emit("four", mesh="one card", step_s=t_one, grid=[one.params.nx,
                                                      one.params.ny])
    for shape in ((2, 2), (4, 1)):
        ctx, t = run(grid_mesh(devs, shape))
        got = _grids(ctx)
        for key in PARAM_KEYS:
            np.testing.assert_allclose(got[key], ref[key], rtol=2e-4,
                                       atol=1e-5, err_msg=f"{shape} {key}")
        emit("four", mesh=list(shape), step_s=t, halo=ctx._halo,
             parity="rtol=2e-4, atol=1e-5 vs one card")
        del ctx
        gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card mesh phase (and nothing else)")
    args = ap.parse_args(argv)
    need = 4 if args.four else 1

    if not os.path.isdir(os.path.join(ROOT, "planeverb")):
        print("chip_smoke: run me from the root of a planeverb checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from planeverb.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    import jax

    compile_s = [0.0]

    def on_duration(event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            compile_s[0] += secs

    jax.monitoring.register_event_duration_secs_listener(on_duration)

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found {len(devs)} "
              f"{devs[0].platform} device(s)", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr}",
              file=sys.stderr)
        return 2
    print(smi.stdout.strip(), flush=True)
    emit("device", platform=devs[0].platform, kind=devs[0].device_kind,
         count=len(devs), jax=jax.__version__, compile_cache=cache_dir)

    phases = ([phase_four] if args.four else
              [phase_kernels, phase_server, phase_split_screen, phase_large])
    try:
        for phase in phases:
            phase()
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke: {phase.__name__} failed: {e}", file=sys.stderr)
        return 1
    emit("compile", compile_s=compile_s[0], cache_dir=cache_dir)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": need}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
