"""Data and tensor parallelism of the port: process groups, meshes, DDP,
FSDP and the model axis.

Counterpart of ``acr_wsss_tpu/parallel`` on its data and model axes.
Sequence and pipeline parallelism (``seq_axis``, ``make_train_step_pp``)
are not ported.
"""

from acr_wsss_tpu_torch.parallel.mesh import (  # noqa: F401
    make_data_mesh_for_batch,
    make_mesh,
)
from acr_wsss_tpu_torch.parallel.sharding import (  # noqa: F401
    apply_fsdp,
    apply_tensor_parallel,
    wrap_ddp,
)
