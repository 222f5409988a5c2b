"""Synthetic plane scenes rendered in numpy, for tests and the card smoke run.

The port's own copy of the plane renderer of
``svo_pro_universal_tpu/testing/synthetic.py`` (textured_image,
render_plane_view), written in numpy so it needs neither JAX nor a card, plus
``render_textured_plane``: an infinite fronto-parallel plane whose texture
is a function of the plane point, so a camera can travel any distance
without running off the texture, seen through a pinhole or through any
camera model of the port; ``align_problem``, a sparse-alignment input
built from two such views; and ``rotation_gap`` to compare poses.
"""

from __future__ import annotations

import numpy as np
import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.ops import sparse_img_align as sia
from svo_pro_universal_tpu_torch.ops.pyramid import (
    build_pyramid, image_to_float)
from svo_pro_universal_tpu_torch.utils.transform import SE3, matrix_to_quat

H, W = 120, 160
INTRINSICS = (150.0, 150.0, W / 2, H / 2)     # fx, fy, cx, cy
PLANE_Z = 2.0


def _texture(x: np.ndarray, y: np.ndarray, seed: int) -> np.ndarray:
    p = seed * 1.7
    return (120.0 + 40 * np.sin(x / 7.0 + p) * np.cos(y / 5.0)
            + 30 * np.sin((x + y) / 11.0)
            + 20 * np.cos(x / 3.0 + y / 13.0 + p))


def textured_image(h: int = H, w: int = W, seed: int = 0) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return _texture(x, y, seed).astype(np.float32)


def _bearings(fx, fy, cx, cy, h, w) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    uv = np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float64)
    f = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                  np.ones(len(uv))], -1)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def _bilinear(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    h, w = img.shape
    u, v = uv[:, 0], uv[:, 1]
    u0, v0 = np.floor(u), np.floor(v)
    fu, fv = u - u0, v - v0
    inb = (u >= 0) & (v >= 0) & (u <= w - 1 - 1e-6) & (v <= h - 1 - 1e-6)
    x0 = np.clip(u0.astype(np.int64), 0, w - 2)
    y0 = np.clip(v0.astype(np.int64), 0, h - 2)
    val = ((1 - fu) * (1 - fv) * img[y0, x0] + fu * (1 - fv) * img[y0, x0 + 1]
           + (1 - fu) * fv * img[y0 + 1, x0] + fu * fv * img[y0 + 1, x0 + 1])
    return np.where(inb, val, 0.0)


def render_plane_view(img_ref: np.ndarray, T_cur_ref: np.ndarray,
                      intrinsics=INTRINSICS, plane_z: float = PLANE_Z
                      ) -> np.ndarray:
    """Cur view (4×4 ``T_cur_ref``) of the fronto-parallel plane z=plane_z
    textured by ``img_ref``, the identity-pose view. Pixels whose ray leaves
    the reference image are 0."""
    fx, fy, cx, cy = intrinsics
    h, w = img_ref.shape
    T_ref_cur = np.linalg.inv(np.asarray(T_cur_ref, np.float64))
    d = _bearings(fx, fy, cx, cy, h, w) @ T_ref_cur[:3, :3].T
    lam = (plane_z - T_ref_cur[2, 3]) / np.maximum(d[:, 2], 1e-9)
    p_ref = T_ref_cur[:3, 3][None] + lam[:, None] * d
    uv_ref = np.stack([fx * p_ref[:, 0] / p_ref[:, 2] + cx,
                       fy * p_ref[:, 1] / p_ref[:, 2] + cy], -1)
    return _bilinear(img_ref.astype(np.float64), uv_ref).reshape(
        h, w).astype(np.float32)


def camera_bearings(cam: proj.Camera) -> np.ndarray:
    """[H·W, 3] unit bearing of every pixel of ``cam`` (row-major)."""
    yy, xx = np.mgrid[0:cam.height, 0:cam.width]
    uv = np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float32)
    f = proj.backproject(cam.to("cpu"), torch.from_numpy(uv))
    return f.numpy().astype(np.float64)


def render_textured_plane(T_cam_world: np.ndarray, intrinsics, width: int,
                          height: int, plane_z: float, seed: int = 0,
                          bearings: np.ndarray | None = None) -> np.ndarray:
    """uint8 view of the infinite plane z=plane_z (world frame) from
    ``T_cam_world``. The texture is ``textured_image``'s, continued over the
    whole plane, plus a coarse checker whose crossings are FAST corners.
    The view is the pinhole ``intrinsics``', or, given ``bearings``
    ([H·W, 3], from ``camera_bearings``), that camera's; the texture's
    scale is set by ``intrinsics`` either way."""
    fx, fy, cx, cy = intrinsics
    T_world_cam = np.linalg.inv(np.asarray(T_cam_world, np.float64))
    if bearings is None:
        bearings = _bearings(fx, fy, cx, cy, height, width)
    d = bearings @ T_world_cam[:3, :3].T
    o = T_world_cam[:3, 3]
    lam = (plane_z - o[2]) / np.maximum(d[:, 2], 1e-9)
    p = o[None] + lam[:, None] * d
    # plane coordinates in "reference pixels" of a camera at the origin
    x = fx * p[:, 0] / plane_z + cx
    y = fy * p[:, 1] / plane_z + cy
    checker = np.sign(np.sin(x / 9.0) * np.sin(y / 8.0))
    img = 0.8 * _texture(x, y, seed) + 30.0 * checker
    return np.clip(img, 0, 255).reshape(height, width).astype(np.uint8)


def pose(tx: float, ty: float, tz: float, rx: float = 0.0, ry: float = 0.0,
         rz: float = 0.0) -> np.ndarray:
    """4×4 T_cam_world from a translation and a rotation vector (rad)."""
    w = np.array([rx, ry, rz], np.float64)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        R = np.eye(3) + K
    else:
        R = (np.eye(3) + np.sin(th) / th * K
             + (1 - np.cos(th)) / th ** 2 * K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = (tx, ty, tz)
    return T


def align_problem(cam: proj.Camera, T_ref_body: np.ndarray,
                  T_cur_body: np.ndarray, intrinsics, plane_z: float,
                  n_levels: int, grid: tuple[int, int] = (24, 15),
                  margin: int = 48, gain: float = 1.0, offset: float = 0.0,
                  T_cam_body: np.ndarray | None = None,
                  device=None) -> sia.CameraInput:
    """Sparse-alignment input for one camera: the plane rendered through
    ``cam`` from the two body poses (4×4 T_body_world each; the cur view as
    ``gain``·I + ``offset``), the camera mounted at ``T_cam_body`` (4×4,
    default the identity), and grid[0]·grid[1] reference features on a
    regular grid inside ``margin`` px of the border, with their bearings
    and the distance along each to the plane."""
    dev = torch.device("cpu" if device is None else device)
    W, H = cam.width, cam.height
    Tcb = np.eye(4) if T_cam_body is None else np.asarray(T_cam_body,
                                                          np.float64)
    T_ref_cam = Tcb @ np.asarray(T_ref_body, np.float64)    # T_cam_world
    T_cur_cam = Tcb @ np.asarray(T_cur_body, np.float64)
    bearings = camera_bearings(cam)
    imgs = []
    for T, a, b in ((T_ref_cam, 1.0, 0.0), (T_cur_cam, gain, offset)):
        img = render_textured_plane(T, intrinsics, W, H, plane_z,
                                    bearings=bearings).astype(np.float64)
        imgs.append(np.clip(np.rint(img * a + b), 0, 255).astype(np.uint8))
    gu = np.linspace(margin, W - 1 - margin, grid[0])
    gv = np.linspace(margin, H - 1 - margin, grid[1])
    px = np.stack(np.meshgrid(gu, gv), -1).reshape(-1, 2).astype(np.float32)
    pxt = torch.from_numpy(px)
    f = proj.backproject(cam.to("cpu"), pxt)
    # distance along each bearing from the ref camera to the plane
    T_world_ref = np.linalg.inv(T_ref_cam)
    d = f.numpy().astype(np.float64) @ T_world_ref[:3, :3].T
    depth = (plane_z - T_world_ref[2, 3]) / np.maximum(d[:, 2], 1e-9)
    pyrs = [build_pyramid(image_to_float(torch.from_numpy(i), dev), n_levels)
            for i in imgs]
    Tcb_t = torch.from_numpy(Tcb.astype(np.float32))
    return sia.CameraInput(
        pyr_ref=pyrs[0], pyr_cur=pyrs[1], px_ref=pxt.to(dev), f_ref=f.to(dev),
        depth_ref=torch.from_numpy(depth.astype(np.float32)).to(dev),
        valid=torch.ones(px.shape[0], dtype=torch.bool, device=dev),
        T_cam_body=SE3(matrix_to_quat(Tcb_t[:3, :3]).to(dev),
                       Tcb_t[:3, 3].to(dev)),
        cam=cam.to(dev))


def rotation_gap(qa, qb) -> float:
    """Angle (rad) between two unit quaternions [w, x, y, z] (tensors or
    arrays), in float64 and by atan2, which keeps its precision near 0
    (the arccos of a float32 dot loses ~3e-4 rad there)."""
    a, b = (np.asarray(torch.as_tensor(q).detach().cpu(), np.float64)
            for q in (qa, qb))
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    w = a[0] * b[0] + a[1:] @ b[1:]                 # conj(a) * b
    v = a[0] * b[1:] - b[0] * a[1:] - np.cross(a[1:], b[1:])
    return float(2.0 * np.arctan2(np.linalg.norm(v), abs(w)))
