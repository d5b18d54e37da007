"""The one place that picks the solver path (ops/pipeline.py::solver_path),
and the persistent compile cache (utils/compile_cache.py)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import oracle
from planeverb.config import PlaneverbConfig, compute_grid_params
from planeverb.ops import pipeline, voxelize
from planeverb.parallel import grid_mesh
from planeverb.scene import demo_scene

CFG = PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0, grid_resolution=275)


def test_cpu_picks_plain_scan():
    assert pipeline.solver_path() == "scan"
    with jax.default_device(jax.devices("cpu")[1]):
        assert pipeline.solver_path() == "scan"


def test_gpu_picks_kernel_without_interpret(monkeypatch):
    """On a GPU every routed entry point runs the blocked kernel, and none
    asks for the interpreter."""
    class FakeGpu:
        platform = "gpu"

    monkeypatch.setattr(pipeline.jax, "devices", lambda *a: [FakeGpu()])
    assert pipeline.solver_path() == "kernel"

    from planeverb.ops import fdtd_blocked

    calls = []
    real_sim, real_mom = (fdtd_blocked.simulate_blocked,
                          fdtd_blocked.moments_blocked)

    def sim(*args, interpret=False, **kw):
        calls.append(("sim", interpret))
        return real_sim(*args, interpret=True, **kw)

    def mom(*args, interpret=False, **kw):
        calls.append(("moments", interpret))
        return real_mom(*args, interpret=True, **kw)

    monkeypatch.setattr(fdtd_blocked, "simulate_blocked", sim)
    monkeypatch.setattr(fdtd_blocked, "moments_blocked", mom)
    p = dataclasses.replace(compute_grid_params(CFG), response_length=24)
    beta, refl = voxelize.voxelize_np(p, demo_scene("SmallRoom").boxes)
    args = (p, jnp.asarray(beta), jnp.asarray(refl),
            jnp.asarray(oracle.gaussian_pulse(p)[:24]))
    lcells = jnp.asarray([[14, 14], [10, 20]], jnp.int32)
    lpos = jnp.asarray([[5.0, 5.0], [3.5, 7.0]], jnp.float32)
    # the jitted kernel entry points must trace anew with the spies in
    # place, and must not keep those traces for other tests
    jitted = (pipeline.simulate_kernel, pipeline.pipeline_kernel)
    for fn in jitted:
        fn.clear_cache()
    try:
        res = pipeline.simulate_auto(*args, 14, 14)
        _, out = pipeline.pipeline_auto_batch(*args, lcells,
                                              jnp.float32(0.03), lpos)
    finally:
        for fn in jitted:
            fn.clear_cache()
    assert res.pressure.shape == (24, p.nx, p.ny)
    assert out.occlusion.shape == (2, p.grid_x, p.grid_y)
    assert sorted(set(calls)) == [("moments", False), ("sim", False)]


def test_mesh_picks_sharded_plain_path(monkeypatch):
    """A mesh Context asks solver_path, and its step runs the plain
    sharded pipeline: no blocked kernel, no interpreter."""
    from planeverb import parallel
    from planeverb.core import context
    from planeverb.ops import fdtd_blocked

    mesh = grid_mesh(jax.devices()[:4], (2, 2))
    assert pipeline.solver_path(mesh=mesh) == "sharded"
    asked, halos = [], []
    real_path, real_sharded = context.solver_path, parallel.pipeline_sharded

    def path(m=None):
        asked.append(m)
        return real_path(m)

    def sharded(*args, **kw):
        halos.append(kw["halo"])
        return real_sharded(*args, **kw)

    def no_kernel(*args, **kw):
        raise AssertionError("a mesh step ran the blocked kernel")

    monkeypatch.setattr(context, "solver_path", path)
    monkeypatch.setattr(parallel, "pipeline_sharded", sharded)
    monkeypatch.setattr(fdtd_blocked, "simulate_blocked", no_kernel)
    cfg = PlaneverbConfig(grid_size_x=6.0, grid_size_y=6.0,
                          grid_resolution=275)
    ctx = context.Context(cfg, scene=demo_scene("SmallRoom"), mesh=mesh,
                          halo=2)
    assert asked == [mesh]
    # the jitted step must trace anew with the spy in place, and must not
    # keep that trace for other tests
    context._pipeline_packed_sharded.clear_cache()
    try:
        ctx.set_listener_position(3.0, 0.0, 3.0)
        ctx.step()
    finally:
        context._pipeline_packed_sharded.clear_cache()
    assert halos == [2]
    assert ctx.result_at(4.0, 3.0).valid


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from planeverb.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # nothing set: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from planeverb.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.enable_compile_cache() == path   # fixed path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
