"""Camera model, SE(3)/frame conventions, point clouds, the occupancy grid,
file io (PLY, capture datasets, PGM/YAML maps), mesh assets and volume io."""

from otslam_tpu_torch.core.camera import PinholeIntrinsics  # noqa: F401
from otslam_tpu_torch.core.se3 import (  # noqa: F401
    T_FIX_OPTICAL,
    T_FIX_GT,
    quat_to_matrix,
    yaw_to_matrix2d,
    matrix_to_yaw,
    invert_se3,
    transform_points,
    euler_xyz_to_matrix,
)
from otslam_tpu_torch.core.pointcloud import PointCloud  # noqa: F401
from otslam_tpu_torch.core.grid import OccupancyGrid2D  # noqa: F401
from otslam_tpu_torch.core.mesh_io import (  # noqa: F401
    TriMesh,
    load_mesh,
    read_obj,
    read_stl,
    read_dae,
    sample_mesh_surface,
)
