"""Data and tensor parallelism of the port over ``torch.distributed``
(counterpart of the JAX ``parallel/`` package): :mod:`.mesh` (the mesh and
the sharding policy), :mod:`.comm` (the collectives GSPMD inserts in JAX),
:mod:`.steps`, :mod:`.multihost`, :mod:`.spatial`, :mod:`.scaling_bench`.
"""

from cnns_slfp_quantization_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
)
