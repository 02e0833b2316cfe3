"""Multi-device fusion and eval on torch.distributed: one process per
device, a DeviceMesh over the process group (see mesh.py, comm.py)."""

from otslam_tpu_torch.distributed.mesh import make_mesh  # noqa: F401
from otslam_tpu_torch.distributed.sharding import (  # noqa: F401
    fuse_frames_data_parallel,
    fuse_frames_2d_sharded,
    fuse_frames_hierarchical,
    fuse_objects_parallel,
    reconstruct_all_sharded,
    chamfer_data_parallel,
)
from otslam_tpu_torch.distributed.sparse import (  # noqa: F401
    extract_meshes_sharded,
    fuse_frames_sparse_data_parallel,
    fuse_objects_sparse_parallel,
    reconstruct_all_sharded_sparse,
)
