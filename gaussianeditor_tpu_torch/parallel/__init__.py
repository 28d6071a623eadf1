"""Multi-device training over `torch.distributed`: meshes, the
view-sharded step, tile-row strips, row halos and the 2-D step.
Counterpart of `gaussianeditor_tpu/parallel/`."""

from gaussianeditor_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
    make_mesh_2d,
)
from gaussianeditor_tpu_torch.parallel.sharded_step import (  # noqa: F401
    make_sharded_train_step,
)
