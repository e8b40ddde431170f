"""Multi-process helpers of the port (counterpart of
``svt_speechbrain_tpu.parallel``): process groups, device meshes over the
ranks, FSDP2, tensor and pipeline parallelism."""

from svt_speechbrain_tpu_torch.parallel.distributed import (  # noqa: F401
    ddp_barrier, ddp_init_group, if_main_process, main_process_only,
    run_on_main)
from svt_speechbrain_tpu_torch.parallel.fsdp import (  # noqa: F401
    apply_fsdp, fsdp_shardings)
from svt_speechbrain_tpu_torch.parallel.mesh import (  # noqa: F401
    data_parallel_sharding, make_mesh, replicate, shard_batch)
