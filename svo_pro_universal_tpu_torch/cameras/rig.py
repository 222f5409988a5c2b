"""Multi-camera rig, IMU parameters, and the rig-calibration YAML.

Counterpart of ``svo_pro_universal_tpu/cameras/rig.py`` (reference NCamera /
CameraBundle, src/vikit/vikit_cameras/include/vikit/cameras/ncamera.h:21,42,
camera_yaml_serialization.cpp; IMU calibration imu_calibration.h:14-140).
Reads the same YAML schema: cameras[].camera.{type,intrinsics,distortion},
cameras[].T_B_C, imu_params, imu_initialization.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from svo_pro_universal_tpu_torch.cameras.projections import (
    Camera, DistortionModel, ProjectionModel)
from svo_pro_universal_tpu_torch.utils import yaml_lite
from svo_pro_universal_tpu_torch.utils.transform import SE3, matrix_to_quat

_DIST_NAMES = {
    "none": DistortionModel.NONE,
    "radial-tangential": DistortionModel.RADTAN,
    "radtan": DistortionModel.RADTAN,
    "equidistant": DistortionModel.EQUIDISTANT,
    "fisheye": DistortionModel.EQUIDISTANT,
    "atan": DistortionModel.ATAN,
    "fov": DistortionModel.ATAN,
}

_PROJ_NAMES = {
    "pinhole": ProjectionModel.PINHOLE,
    "fisheye": ProjectionModel.FISHEYE_EQUIDISTANT,
    "omni": ProjectionModel.OMNI,
}


@dataclass
class ImuParams:
    """IMU noise / rate parameters (reference: imu_calibration.h:14)."""
    delay_imu_cam: float = 0.0
    max_imu_delta_t: float = 0.01
    acc_max: float = 176.0
    omega_max: float = 17.0
    sigma_omega_c: float = 12e-4
    sigma_acc_c: float = 8e-3
    sigma_omega_bias_c: float = 0.03
    sigma_acc_bias_c: float = 0.1
    sigma_integration: float = 0.0
    g: float = 9.81
    imu_rate: float = 200.0


@dataclass
class ImuInitialization:
    """Initial state priors (reference: imu_calibration.h:85)."""
    velocity: tuple = (0.0, 0.0, 0.0)
    omega_bias: tuple = (0.0, 0.0, 0.0)
    acc_bias: tuple = (0.0, 0.0, 0.0)
    velocity_sigma: float = 2.0
    omega_bias_sigma: float = 0.01
    acc_bias_sigma: float = 0.1


@dataclass
class CameraRig:
    """Calibrated rig: cameras + body(IMU)-to-camera extrinsics."""
    cameras: list[Camera]
    T_body_cam: list[SE3]           # T_B_C per camera
    label: str = "rig"
    imu_params: Optional[ImuParams] = None
    imu_init: Optional[ImuInitialization] = None
    extras: dict = field(default_factory=dict)
    # T_B_C [4×4] float64 of each camera as the file gives it
    T_B_C_matrices: list = field(default_factory=list)

    def __len__(self):
        return len(self.cameras)

    def T_cam_body(self, i: int) -> SE3:
        return self.T_body_cam[i].inverse()

    @property
    def stereo_baseline(self) -> float:
        """Metric distance between cam0 and cam1 (stereo rigs)."""
        if len(self.cameras) < 2:
            return 0.0
        d = self.T_body_cam[0].t - self.T_body_cam[1].t
        return float(torch.linalg.norm(d))


def _parse_camera(node: dict[str, Any], device) -> Camera:
    cam = node["camera"]
    proj = _PROJ_NAMES[str(cam["type"]).lower()]
    intr = np.asarray(cam["intrinsics"]["data"], dtype=np.float64)
    dist_node = cam.get("distortion")
    if dist_node is None:
        dist, dp = DistortionModel.NONE, [0.0]
    else:
        dist = _DIST_NAMES[str(dist_node["type"]).lower().strip()]
        dp = list(np.asarray(dist_node["parameters"]["data"],
                             dtype=np.float64))
    return Camera(proj, dist, intr.astype(np.float32),
                  np.asarray(dp, np.float32), int(cam["image_width"]),
                  int(cam["image_height"]),
                  label=str(cam.get("label", "cam")), device=device)


def load_rig_yaml(path: str, device=None) -> CameraRig:
    """Load a rig calibration YAML in the reference's schema
    (reference: examples/param/calib/euroc_mono.yaml), read by
    ``utils.yaml_lite`` (no YAML library)."""
    return parse_rig(yaml_lite.load_file(path), device=device)


def parse_rig(doc: dict[str, Any], device=None) -> CameraRig:
    cameras, extrinsics, matrices = [], [], []
    for node in doc["cameras"]:
        cameras.append(_parse_camera(node, device))
        T = np.asarray(node["T_B_C"]["data"], dtype=np.float64).reshape(4, 4)
        matrices.append(T)
        Tt = torch.as_tensor(T.astype(np.float32), device=device)
        extrinsics.append(SE3(matrix_to_quat(Tt[:3, :3]), Tt[:3, 3]))

    imu_params = None
    if "imu_params" in doc:
        known = set(ImuParams.__dataclass_fields__)
        imu_params = ImuParams(**{k: v for k, v in doc["imu_params"].items()
                                  if k in known})
    imu_init = None
    if "imu_initialization" in doc:
        d = doc["imu_initialization"]
        imu_init = ImuInitialization(
            velocity=tuple(d.get("velocity", (0, 0, 0))),
            omega_bias=tuple(d.get("omega_bias", (0, 0, 0))),
            acc_bias=tuple(d.get("acc_bias", (0, 0, 0))),
            velocity_sigma=float(d.get("velocity_sigma", 2.0)),
            omega_bias_sigma=float(d.get("omega_bias_sigma", 0.01)),
            acc_bias_sigma=float(d.get("acc_bias_sigma", 0.1)),
        )
    return CameraRig(cameras, extrinsics, label=str(doc.get("label", "rig")),
                     imu_params=imu_params, imu_init=imu_init,
                     T_B_C_matrices=matrices)
