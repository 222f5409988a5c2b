"""Batched camera projection models.

Counterpart of ``svo_pro_universal_tpu/cameras/projections.py`` (the
reference's vikit camera zoo, src/vikit/vikit_cameras/include/vikit/cameras/
camera_geometry_base.h:81-131 — pinhole × {No, Atan, Equidistant, RadTan}
distortion, plus equidistant fisheye and Mei omni). Intrinsics are tensors on
the camera's device; the model enums and the image size are plain Python.
Distortion inversion uses fixed-iteration Newton / fixed-point loops.
"""

from __future__ import annotations

import enum

import torch


class ProjectionModel(enum.IntEnum):
    PINHOLE = 0
    FISHEYE_EQUIDISTANT = 1
    OMNI = 2


class DistortionModel(enum.IntEnum):
    NONE = 0
    RADTAN = 1        # [k1, k2, p1, p2]
    EQUIDISTANT = 2   # [k1, k2, k3, k4] on theta
    ATAN = 3          # [s] FOV model


_MAX_DIST_PARAMS = 5


class Camera:
    """One camera: intrinsics [fx, fy, cx, cy] and dist_params [5] tensors."""

    def __init__(self, projection: ProjectionModel,
                 distortion: DistortionModel, intrinsics, dist_params,
                 width: int, height: int, label: str = "cam", device=None):
        self.projection = ProjectionModel(projection)
        self.distortion = DistortionModel(distortion)
        self.intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32,
                                          device=device)
        dp = torch.atleast_1d(torch.as_tensor(dist_params,
                                              dtype=torch.float32,
                                              device=device))
        pad = _MAX_DIST_PARAMS - dp.shape[-1]
        if pad > 0:
            dp = torch.cat([dp, dp.new_zeros(dp.shape[:-1] + (pad,))], -1)
        self.dist_params = dp
        self.width = int(width)
        self.height = int(height)
        self.label = label

    @property
    def device(self) -> torch.device:
        return self.intrinsics.device

    def to(self, device) -> "Camera":
        return Camera(self.projection, self.distortion,
                      self.intrinsics.to(device), self.dist_params.to(device),
                      self.width, self.height, self.label)

    def __repr__(self):
        return (f"Camera({self.label}, {self.projection.name}/"
                f"{self.distortion.name}, {self.width}x{self.height})")

    @property
    def focal_length(self) -> torch.Tensor:
        """Mean of |fx|, |fy| (reference: frame.h getErrorMultiplier)."""
        return 0.5 * (torch.abs(self.intrinsics[0])
                      + torch.abs(self.intrinsics[1]))

    @classmethod
    def pinhole(cls, fx, fy, cx, cy, width, height,
                distortion=DistortionModel.NONE, dist_params=(), label="cam",
                device=None):
        dp = list(dist_params) or [0.0]
        return cls(ProjectionModel.PINHOLE, distortion, [fx, fy, cx, cy], dp,
                   width, height, label, device=device)


# ---------------------------------------------------------------------------
# Distortion on the unit plane: (x, y) -> distorted (xd, yd)
# ---------------------------------------------------------------------------

def _distort_radtan(p, k):
    k1, k2, p1, p2 = k[0], k[1], k[2], k[3]
    x, y = p[..., 0], p[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x2)
    yd = y * radial + 2.0 * p2 * xy + p1 * (r2 + 2.0 * y2)
    return torch.stack([xd, yd], dim=-1)


def _undistort_radtan(pd, k, iters: int = 8):
    k1, k2, p1, p2 = k[0], k[1], k[2], k[3]
    p = pd
    for _ in range(iters):
        x, y = p[..., 0], p[..., 1]
        x2, y2, xy = x * x, y * y, x * y
        r2 = x2 + y2
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * xy + p2 * (r2 + 2.0 * x2)
        dy = 2.0 * p2 * xy + p1 * (r2 + 2.0 * y2)
        p = torch.stack([(pd[..., 0] - dx) / radial,
                         (pd[..., 1] - dy) / radial], dim=-1)
    return p


def _distort_equidistant(p, k):
    k1, k2, k3, k4 = k[0], k[1], k[2], k[3]
    r = torch.linalg.norm(p, dim=-1, keepdim=True)
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-8), 1.0)
    return p * scale


def _undistort_equidistant(pd, k, iters: int = 8):
    k1, k2, k3, k4 = k[0], k[1], k[2], k[3]
    theta_d = torch.linalg.norm(pd, dim=-1, keepdim=True)
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) \
            - theta_d
        df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = theta - f / torch.clamp(df, min=1e-6)
    scale = torch.where(theta_d > 1e-8,
                        torch.tan(theta) / torch.clamp(theta_d, min=1e-8),
                        1.0)
    return pd * scale


def _distort_atan(p, k):
    s = k[0]
    r = torch.linalg.norm(p, dim=-1, keepdim=True)
    factor = torch.where(
        r > 1e-8,
        torch.atan(r * 2.0 * torch.tan(s / 2.0)) / torch.clamp(s * r,
                                                               min=1e-8),
        2.0 * torch.tan(s / 2.0) / torch.clamp(s, min=1e-8))
    return p * factor


def _undistort_atan(pd, k):
    s = k[0]
    rd = torch.linalg.norm(pd, dim=-1, keepdim=True)
    factor = torch.where(
        rd > 1e-8,
        torch.tan(rd * s) / torch.clamp(rd * 2.0 * torch.tan(s / 2.0),
                                        min=1e-8),
        s / torch.clamp(2.0 * torch.tan(s / 2.0), min=1e-8))
    return pd * factor


def _apply_distortion(cam: Camera, p):
    if cam.distortion == DistortionModel.NONE:
        return p
    if cam.distortion == DistortionModel.RADTAN:
        return _distort_radtan(p, cam.dist_params)
    if cam.distortion == DistortionModel.EQUIDISTANT:
        return _distort_equidistant(p, cam.dist_params)
    if cam.distortion == DistortionModel.ATAN:
        return _distort_atan(p, cam.dist_params)
    raise ValueError(cam.distortion)


def _remove_distortion(cam: Camera, pd):
    if cam.distortion == DistortionModel.NONE:
        return pd
    if cam.distortion == DistortionModel.RADTAN:
        return _undistort_radtan(pd, cam.dist_params)
    if cam.distortion == DistortionModel.EQUIDISTANT:
        return _undistort_equidistant(pd, cam.dist_params)
    if cam.distortion == DistortionModel.ATAN:
        return _undistort_atan(pd, cam.dist_params)
    raise ValueError(cam.distortion)


# ---------------------------------------------------------------------------
# Project / backproject
# ---------------------------------------------------------------------------

def project(cam: Camera, xyz: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """3D point(s) in camera frame → pixel coords (uv [..2], valid [..])."""
    fx, fy, cx, cy = cam.intrinsics.unbind(0)
    z = xyz[..., 2]
    if cam.projection == ProjectionModel.PINHOLE:
        zi = 1.0 / torch.where(torch.abs(z) > 1e-8, z, 1e-8)
        p = xyz[..., 0:2] * zi[..., None]
        pd = _apply_distortion(cam, p)
        valid = z > 1e-6
    elif cam.projection == ProjectionModel.FISHEYE_EQUIDISTANT:
        r = torch.linalg.norm(xyz[..., 0:2], dim=-1)
        theta = torch.atan2(r, z)
        scale = torch.where(r > 1e-8, theta / torch.clamp(r, min=1e-8), 1.0)
        p = xyz[..., 0:2] * scale[..., None]
        pd = _apply_distortion(cam, p)
        valid = theta < torch.pi / 2.0
    elif cam.projection == ProjectionModel.OMNI:
        xi = cam.dist_params[4]
        n = torch.linalg.norm(xyz, dim=-1)
        denom = z + xi * n
        di = 1.0 / torch.where(torch.abs(denom) > 1e-8, denom, 1e-8)
        p = xyz[..., 0:2] * di[..., None]
        pd = _apply_distortion(cam, p)
        valid = denom > 1e-6
    else:
        raise NotImplementedError(cam.projection)
    uv = torch.stack([fx * pd[..., 0] + cx, fy * pd[..., 1] + cy], dim=-1)
    inside = ((uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
              & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height))
    return uv, valid & inside


def backproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixel coords → unit bearing vector in camera frame."""
    fx, fy, cx, cy = cam.intrinsics.unbind(0)
    pd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    p = _remove_distortion(cam, pd)
    if cam.projection == ProjectionModel.PINHOLE:
        f = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    elif cam.projection == ProjectionModel.FISHEYE_EQUIDISTANT:
        theta = torch.linalg.norm(p, dim=-1, keepdim=True)
        dir_xy = torch.where(theta > 1e-8, p / torch.clamp(theta, min=1e-8),
                             p)
        f = torch.cat([dir_xy * torch.sin(theta), torch.cos(theta)], dim=-1)
    elif cam.projection == ProjectionModel.OMNI:
        xi = cam.dist_params[4]
        r2 = torch.sum(p * p, dim=-1, keepdim=True)
        zc = (xi + torch.sqrt(torch.clamp(1.0 + (1.0 - xi * xi) * r2,
                                          min=0.0))) / (1.0 + r2)
        f = torch.cat([p * zc, zc - xi], dim=-1)
    else:
        raise NotImplementedError(cam.projection)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def project_jacobian(cam: Camera, xyz: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(xyz) [..., 2, 3] by forward-mode autodiff."""
    flat = xyz.reshape(-1, 3)

    def proj1(x):
        # one point as a [1, 3] batch: on 0-dim values torch.func turns
        # `python float + tensor` into float64
        return project(cam, x[None])[0][0]

    J = torch.func.vmap(torch.func.jacfwd(proj1))(flat)
    return J.reshape(xyz.shape[:-1] + (2, 3))


def pinhole_unit_plane_jacobian(xyz: torch.Tensor) -> torch.Tensor:
    """d(unit-plane uv)/d(xyz) = [[1/z, 0, -x/z²],[0, 1/z, -y/z²]]."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    zi = 1.0 / torch.where(torch.abs(z) > 1e-8, z, 1e-8)
    zi2 = zi * zi
    zero = torch.zeros_like(zi)
    row0 = torch.stack([zi, zero, -x * zi2], dim=-1)
    row1 = torch.stack([zero, zi, -y * zi2], dim=-1)
    return torch.stack([row0, row1], dim=-2)
