"""Multi-device execution: device mesh + spatially sharded FDTD solver.

The reference is single-process shared-memory C++ with no distributed story
(SURVEY.md §2 parallelism inventory). Here the solver grid is sharded over a
2D ``jax.sharding.Mesh``, halos are exchanged via ``ppermute`` inside
``shard_map``, and the analyzer runs under the same sharding with XLA
inserting the few collectives it needs.
"""

from planeverb.parallel.mesh import (grid_mesh, mesh_from_count,
                                     pad_to_mesh)
from planeverb.parallel.multihost import (init_distributed,
                                          multihost_grid_mesh)
from planeverb.parallel.solver import (pipeline_sharded,
                                       simulate_moments_sharded,
                                       simulate_sharded,
                                       simulate_sharded_wide)

__all__ = ["grid_mesh", "mesh_from_count", "pad_to_mesh", "simulate_sharded",
           "simulate_sharded_wide", "simulate_moments_sharded",
           "pipeline_sharded", "init_distributed", "multihost_grid_mesh"]
