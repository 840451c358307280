"""Element- and row-sharded energies and solvers on ``torch.distributed``
(port of ``hidenn_fem_tpu/parallel``): ``sharding`` (the element-sharded
gather and banded routes, and the counted collectives), ``sharded_slab``
(the lattice stencil kernels over row windows), ``sharded_lattice`` (the
plain lattice route over row blocks) and ``multihost`` (joining the process
group); ``sharded_aux`` (auxiliary-space PCG over the sharded matvecs) and
``sharded_mg`` (multigrid-PCG with row-sharded levels)."""

from .multihost import initialize_multihost, is_multihost, process_summary
from .sharded_aux import aux_pcg_solve_sharded
from .sharded_lattice import sharded_lattice_energy
from .sharded_mg import mg_pcg_solve_sharded
from .sharded_slab import shard_map_lattice_slab
from .sharding import (ELEM_AXIS, DeviceMesh, device_mesh, pad_mesh,
                       reband_for_shards, replicate, shard_map_banded_energy,
                       shard_map_energy, shard_mesh)
