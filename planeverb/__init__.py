"""planeverb — real-time wave-based game acoustics on accelerators (JAX).

A from-scratch JAX/XLA/Pallas framework with the capabilities of Planeverb
(Rosen, Godin, Raghuvanshi, SCA 2020; reference C++ at /root/reference):
a 2D FDTD acoustic simulation of a horizontal world slice encodes impulse
responses into per-source perceptual parameters (obstruction, wet gain,
RT60, lowpass cutoff, direction, directivity), and a DSP module renders
those parameters onto audio.

Quick start::

    import planeverb as pv

    ctx = pv.Context(pv.PlaneverbConfig(grid_size_x=10, grid_size_y=10),
                     scene=pv.demo_scene("SmallRoom"))
    ctx.set_listener_position(5.0, 0.0, 5.0)
    ctx.step()                       # or ctx.start() for continuous updates
    out = ctx.result_at(6.0, 5.0)    # acoustic params at a source position
"""

from planeverb.config import (CONSTANTS, MATERIALS, BoundaryType,
                              PlaneverbConfig, PlaneverbDSPConfig,
                              Resolution, compute_grid_params,
                              material_r)
from planeverb.core.context import Context
from planeverb.core.objects import ObjectManager
from planeverb.scene import (AABB, AABB3D, Scene, demo_scene, load_pv,
                             merge_bounds, save_pv)
from planeverb.session import load_session, save_session
from planeverb.types import PlaneverbOutput

__version__ = "0.1.0"

__all__ = [
    "AABB", "AABB3D", "BoundaryType", "CONSTANTS", "Context", "MATERIALS",
    "ObjectManager", "PlaneverbConfig", "PlaneverbDSPConfig",
    "PlaneverbOutput", "Resolution", "Scene", "compute_grid_params",
    "demo_scene", "load_pv", "material_r", "merge_bounds", "save_pv",
    "load_session", "save_session", "__version__",
]
