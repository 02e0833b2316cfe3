"""SE(3) utilities and the OTSLAM frame conventions.

The reference stores per-frame poses as 4x4 "map -> camera body" matrices
written from TF (scanner_node.cpp:283-298) and converts the ROS body frame
(X forward, Z up) to the optical frame (Z forward, Y down) with a constant
right-multiplied fix matrix. Two variants exist in the reference:

* ``T_FIX_OPTICAL`` — reconstruct_rgbd.py:29-34 / reconstruct_rgbd_filter.py:31-37
  (used for scanner_node captures, where the TF target is already
  ``camera_rgb_optical_frame``-adjacent).
* ``T_FIX_GT`` — reconstruct_rgbd_gt.py:52-57 (used for ground-truth-odometry
  captures of the robot *body* frame).

Everything here is pure numpy; matrices are float64 on host for pose prep
and cast down when entering device pipelines.
"""

from __future__ import annotations

import numpy as np

# Optical fix used for scanner datasets: column-mapping
# cam_x <- -body_y, cam_y <- -body_z, cam_z <- body_x.
T_FIX_OPTICAL = np.array(
    [
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, -1.0, 0.0],
        [1.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)

# Ground-truth-odometry variant (body frame capture).
T_FIX_GT = np.array(
    [
        [0.0, 0.0, 1.0, 0.0],
        [-1.0, 0.0, 0.0, 0.0],
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def quat_to_matrix(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    """Quaternion -> 3x3 rotation matrix (ROS xyzw order)."""
    n = qx * qx + qy * qy + qz * qz + qw * qw
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * qw * qx, s * qw * qy, s * qw * qz
    xx, xy, xz = s * qx * qx, s * qx * qy, s * qx * qz
    yy, yz, zz = s * qy * qy, s * qy * qz, s * qz * qz
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def quat_yaw(qx: float, qy: float, qz: float, qw: float) -> float:
    """Yaw about +Z from a quaternion (diff_node.cpp:226-230 semantics)."""
    return float(
        np.arctan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
    )


def yaw_to_quat(yaw: float) -> tuple[float, float, float, float]:
    """Yaw -> quaternion (x, y, z, w), planar rotation about +Z."""
    return (0.0, 0.0, float(np.sin(yaw * 0.5)), float(np.cos(yaw * 0.5)))


def yaw_to_matrix2d(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s], [s, c]])


def matrix_to_yaw(R: np.ndarray) -> float:
    return float(np.arctan2(R[1, 0], R[0, 0]))


def se3(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t).reshape(3)
    return T


def invert_se3(T) -> np.ndarray:
    """Closed-form inverse of a rigid transform (cheaper & exacter than inv)."""
    T = np.asarray(T)
    R = T[:3, :3]
    t = T[:3, 3]
    out = np.eye(4, dtype=T.dtype)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def transform_points(T, pts):
    """Apply a 4x4 transform to (..., 3) points. Works for numpy and torch."""
    R = T[:3, :3]
    t = T[:3, 3]
    return pts @ R.T + t


def euler_xyz_to_matrix(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rotation from XYZ Euler angles (radians), matching
    Open3D's get_rotation_matrix_from_xyz used at eval_table_chair.py:84."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


def pose_to_extrinsic(pose_ros: np.ndarray, t_fix: np.ndarray = T_FIX_OPTICAL) -> np.ndarray:
    """Map->body pose matrix -> world->optical extrinsic.

    Mirrors reconstruct_rgbd.py:93-96: extrinsic = inv(pose @ T_fix).
    """
    return invert_se3(np.asarray(pose_ros) @ t_fix)
