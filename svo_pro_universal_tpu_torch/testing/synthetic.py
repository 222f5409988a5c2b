"""Synthetic plane scenes rendered in numpy, for tests and the card smoke run.

The port's own copy of the plane renderer of
``svo_pro_universal_tpu/testing/synthetic.py`` (textured_image,
render_plane_view), written in numpy so it needs neither JAX nor a card, plus
``render_textured_plane``: an infinite fronto-parallel plane whose texture
is a function of the plane point, so a camera can travel any distance
without running off the texture, seen through a pinhole or through any
camera model of the port; ``align_problem``, a sparse-alignment input
built from two such views; ``rotation_gap`` to compare poses; and
``tile_case`` and ``tile_gather_mismatches``, which hold the tile
gathers (origin arithmetic included) to their plain versions; bench.py's
mono-VIO input (``bench_sequence``: its sphere+plane scene along its
``twist`` trajectory, ``degrade_sequence``, the 200 Hz IMU stream); and the
same scene seen by a camera rig (``rig_sequence``), with the EuRoC stereo
rig of examples/param/euroc_stereo.yaml (``euroc_stereo_rig``); the
JAX toolkit's ``grid_features`` and ``synthetic_ba_window`` (bench.py's
backend window).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import imu_factor as imf
from svo_pro_universal_tpu_torch.backend import window_ba as wba
from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.cameras.rig import load_rig_yaml
from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuWindow
from svo_pro_universal_tpu_torch.ops import cuda_tiles
from svo_pro_universal_tpu_torch.ops import sparse_img_align as sia
from svo_pro_universal_tpu_torch.ops.pyramid import (
    build_pyramid, image_to_float)
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, matrix_to_quat, quat_conjugate, quat_rotate)

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


# ---------------------------------------------------------------------------
# bench.py's mono-VIO scene: a textured sphere before a slanted plane, the
# `twist` trajectory, photometric degradation and a 200 Hz IMU stream
# ---------------------------------------------------------------------------

BENCH_W, BENCH_H = 752, 480
BENCH_INTRINSICS = (460.0, 460.0, 376.0, 240.0)
SPHERE_CENTER = (0.0, 0.0, 2.8)
SPHERE_RADIUS = 1.4
BG_PLANE_N = (0.2, -0.1, 1.0)      # background plane n·x = BG_PLANE_D
BG_PLANE_D = 4.5
CAM_DT = 0.05                      # 20 Hz camera
IMU_RATE = 200.0
GRAVITY_W = np.array([0.0, 0.0, -9.81])


def se3_exp_np(twist) -> np.ndarray:
    """4×4 exp of a twist [v(3), w(3)] (translation first), in float64."""
    tw = np.asarray(twist, np.float64)
    v, w = tw[:3], tw[3:]
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        R, V = np.eye(3) + K, np.eye(3) + 0.5 * K
    else:
        R = (np.eye(3) + np.sin(th) / th * K
             + (1 - np.cos(th)) / th ** 2 * K @ K)
        V = (np.eye(3) + (1 - np.cos(th)) / th ** 2 * K
             + (th - np.sin(th)) / th ** 3 * K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def bench_twist(t: float) -> np.ndarray:
    """bench.py's `twist` (bench.py:189-214): twist of T_cam_world at frame
    time ``t`` (frames), a slow drift plus an excitation wobble of ±2 cm at
    ~1.2 Hz during the first 2.5 s, faded out by 3.5 s."""
    tt = min(t, 60.0)
    ph = t * 0.11
    ts = t * CAM_DT
    env = (1.0 if ts < 2.5 else
           0.5 * (1.0 + np.cos(np.pi * (ts - 2.5))) if ts < 3.5 else 0.0)
    wob = env * np.array([0.018 * np.sin(7.5 * ts),
                          0.015 * np.sin(9.1 * ts + 1.0),
                          0.012 * np.sin(8.3 * ts + 2.1)])
    return np.array([0.02 * tt * np.cos(ph * 0.15) + wob[0],
                     0.01 * np.sin(ph * 0.9) + wob[1],
                     0.003 * tt * 0.2 + wob[2],
                     0.002 * np.sin(ph * 0.6), 0.0003 * tt,
                     0.001 * tt], np.float32)


LOOP_PERIOD = 64                   # frames per lap (3.2 s at 20 Hz)
LOOP_RADIUS = 0.35                 # m
LOOP_FRAMES = 160                  # ~2.5 laps
LOOP_DEGRADE_SEED = 11


def loop_twist(t: float) -> np.ndarray:
    """bench.py's `loop_twist` (bench.py:300-309), the closed loop of its
    SLAM section: T_cam_world's twist at frame time ``t`` (frames), a lap
    of ``LOOP_PERIOD`` frames that returns to the start."""
    a = 2.0 * np.pi * t / LOOP_PERIOD
    r = LOOP_RADIUS
    return np.array([r * np.sin(a), 0.05 * np.sin(2 * a),
                     0.5 * r * (1.0 - np.cos(a)),
                     0.02 * np.sin(a), 0.03 * np.sin(a), 0.0], np.float32)


def _sphere_texture(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p.unbind(-1)
    smooth = (115.0 + 35.0 * torch.sin(4.0 * x) * torch.cos(5.0 * y)
              + 25.0 * torch.sin(3.0 * (x + z)))
    checker = (25.0 * torch.sign(torch.sin(14.0 * x + 0.7))
               * torch.sign(torch.sin(14.0 * y + 0.3))
               * torch.sign(torch.sin(11.0 * z + 0.5)))
    return torch.clamp(smooth + checker, 0.0, 255.0)


def render_sphere_scene(T_cam_world: np.ndarray, cam: proj.Camera,
                        device=None) -> np.ndarray:
    """float32 [H, W] view of bench.py's sphere + background-plane scene
    (bench.py:53-85) from ``T_cam_world`` (4×4), rendered on ``device``:
    the nearest positive sphere hit, else the plane."""
    dev = torch.device("cpu" if device is None else device)
    cam = cam.to(dev)
    yy, xx = torch.meshgrid(torch.arange(cam.height, device=dev),
                            torch.arange(cam.width, device=dev),
                            indexing="ij")
    uv = torch.stack([xx, yy], -1).reshape(-1, 2).to(torch.float32)
    f = proj.backproject(cam, uv)
    Twc = torch.as_tensor(np.linalg.inv(T_cam_world).astype(np.float32),
                          device=dev)
    d = f @ Twc[:3, :3].T
    o = Twc[:3, 3]
    oc = o - torch.tensor(SPHERE_CENTER, device=dev)
    b = d @ oc
    c = oc @ oc - SPHERE_RADIUS ** 2
    disc = b * b - c
    hit = disc > 0
    ts = torch.where(hit, -b - torch.sqrt(torch.clamp(disc, min=0.0)), -1.0)
    n = torch.tensor(BG_PLANE_N, device=dev)
    denom = d @ n
    tp = (BG_PLANE_D - o @ n) / torch.where(torch.abs(denom) > 1e-9, denom,
                                            1e-9)
    t = torch.where(hit & (ts > 0), ts, tp)
    p = o[None] + t[:, None] * d
    return _sphere_texture(p).reshape(cam.height, cam.width).cpu().numpy()


def degrade_sequence(frames, seed=0, exposure_drift=0.25, vignette=0.35,
                     blur_px=1.5, noise_sigma=2.5) -> list:
    """Camera-realistic degradation of a rendered sequence (the port's copy
    of svo_pro_universal_tpu/testing/synthetic.py:206): mean-reverting
    exposure gain/offset walk, radial vignetting, a 3-tap motion blur along
    a random per-frame shift, Gaussian sensor noise, uint8 quantization."""
    rng = np.random.default_rng(seed)
    h, w = np.asarray(frames[0]).shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = (((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2)
    vig = 1.0 - vignette * r2 / 2.0
    out = []
    gain, offs = 1.0, 0.0
    prev = None
    for f in frames:
        img = np.asarray(f, np.float32)
        gain += rng.normal(0, 0.02) - 0.1 * (gain - 1.0)
        offs += rng.normal(0, 1.0) - 0.1 * offs
        gain = float(np.clip(gain, 1.0 - exposure_drift,
                             1.0 + exposure_drift))
        g = img * gain + offs
        if prev is not None and blur_px > 0:
            dy = rng.integers(-1, 2)
            dx = rng.integers(-2, 3)
            sh = np.roll(np.roll(g, dy, axis=0), dx, axis=1)
            g = (2.0 * g + sh) / 3.0
        prev = img
        g = g * vig
        g = g + rng.normal(0, noise_sigma, g.shape)
        out.append(np.clip(g, 0, 255).astype(np.uint8))
    return out


def bench_imu_stream(twist_fn, n_frames: int) -> list:
    """(t, gyro [3], acc [3]) at 200 Hz consistent with the trajectory
    (body = camera), by finite differences of the poses (bench.py:105-126):
    gyro from the rotation increment, specific force R_bwᵀ(a_w − g)."""
    imu_dt = 1.0 / IMU_RATE
    sub = int(IMU_RATE * CAM_DT)
    n_imu = n_frames * sub
    mats_wb = [np.linalg.inv(se3_exp_np(twist_fn(i / sub)))
               for i in range(n_imu + 2)]
    p_wb = np.stack([m[:3, 3] for m in mats_wb])
    meas = []
    for i in range(n_imu):
        R0, R1 = mats_wb[i][:3, :3], mats_wb[i + 1][:3, :3]
        dR = R0.T @ R1
        w_vec = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                          dR[1, 0] - dR[0, 1]]) * 0.5 / imu_dt
        a_w = (p_wb[i + 2] - 2 * p_wb[i + 1] + p_wb[i]) / imu_dt ** 2
        meas.append((i * imu_dt, w_vec.astype(np.float32),
                     (R0.T @ (a_w - GRAVITY_W)).astype(np.float32)))
    return meas


def bench_sequence(n_frames: int, degrade_seed: int = 7, device=None,
                   twist_fn=bench_twist) -> tuple[list, list, list]:
    """bench.py's mono-VIO input (bench.py:93-127, 216-217): the T_cam_world
    [4×4] of each frame, the degraded uint8 frames (rendered on
    ``device``), and the 200 Hz IMU stream."""
    cam = proj.Camera.pinhole(*BENCH_INTRINSICS, BENCH_W, BENCH_H)
    poses = [se3_exp_np(twist_fn(float(t))) for t in range(n_frames)]
    frames = [render_sphere_scene(T, cam, device).astype(np.uint8)
              for T in poses]
    return (poses, degrade_sequence(frames, seed=degrade_seed),
            bench_imu_stream(twist_fn, n_frames))


def rig_sequence(n_frames: int, cams: list, T_body_cams: list,
                 degrade_seeds: list, device=None, twist_fn=bench_twist
                 ) -> tuple[list, list, list]:
    """bench.py's scene along ``twist_fn`` seen by a rig whose body is cam0
    (``T_body_cams[0]`` the identity, so bench.py's IMU stream, whose body
    is the camera, stays valid): (T_cam0_world [4×4] of each frame, per
    frame the uint8 view of every camera, rendered through its own model
    from its own pose on ``device`` and degraded with its own seed, the
    200 Hz IMU stream)."""
    if not np.allclose(T_body_cams[0], np.eye(4)):
        raise ValueError("the rig's body must be cam0")
    poses = [se3_exp_np(twist_fn(float(t))) for t in range(n_frames)]
    views = []
    for cam, T_bc, seed in zip(cams, T_body_cams, degrade_seeds):
        T_cb = np.linalg.inv(np.asarray(T_bc, np.float64))
        views.append(degrade_sequence(
            [render_sphere_scene(T_cb @ T, cam, device).astype(np.uint8)
             for T in poses], seed=seed))
    return poses, [list(v) for v in zip(*views)], bench_imu_stream(
        twist_fn, n_frames)


EUROC_STEREO_YAML = (Path(__file__).resolve().parents[2] / "examples"
                     / "param" / "euroc_stereo.yaml")


def euroc_stereo_rig(path=EUROC_STEREO_YAML
                     ) -> tuple[list[proj.Camera], list[np.ndarray]]:
    """The EuRoC stereo rig with its body at cam0: both pinhole+radtan
    cameras and T_body_cam [4×4] = (I, T_B_C0⁻¹·T_B_C1), a 0.110 m
    baseline along cam0's x."""
    rig = load_rig_yaml(path, device="cpu")
    T0, T1 = rig.T_B_C_matrices
    return list(rig.cameras), [np.eye(4), np.linalg.inv(T0) @ T1]


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


# cases of tile_case; "nonfinite" is for the card only (the CPU's
# float -> int64 cast differs from the card's and from JAX's there)
TILE_CASES = ("spread", "half", "borders", "levels", "int32", "empty")
# tile sizes of tile_gather_mismatches: the path's 12, 24 and 40, and 10,
# whose rows are no multiple of 16 bytes (the plain-load route at any width)
TILE_SIZES = (10, 12, 24, 40)


def tile_case(rng: np.random.Generator, case: str, n: int, h: int, w: int,
              n_levels: int, n_kf: int, tile: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(level [n], ring slot [n], centres [n, 2] = (y, x) float32) of one
    case for ``extract_tiles`` / ``extract_tiles_ring`` on an [n_kf,
    n_levels, h, w] source with ``tile``² tiles:

    - spread: centres over and past the image, levels and slots in range;
    - half: exact .5 centres (round half to even);
    - borders: centres on and beyond every border of the image and of each
      level, and where the clip to the padded image starts;
    - levels: levels and ring slots -1, L (K), and further out;
    - int32: as spread, with int32 levels and slots (else int64);
    - empty: no feature;
    - nonfinite: NaN, ±inf and ±1e30 centres among spread ones, as an
      invalid feature (a point behind the camera) gives."""
    lvl = rng.integers(0, n_levels, n)
    kf = rng.integers(0, n_kf, n)
    cy = rng.uniform(-10, h + 10, n)
    cx = rng.uniform(-10, w + 10, n)
    half = tile // 2
    if case == "half":
        cy = rng.integers(-3, h + 3, n) + 0.5
        cx = rng.integers(-3, w + 3, n) + 0.5
    elif case == "borders":
        ys = [0, -1, h - 1, h, h + 50, -50, half, h - half, half - 0.5,
              h - half + 0.5] + [(h >> v) - 1 for v in range(n_levels)]
        xs = [0, -1, w - 1, w, w + 50, -50, half, w - half, half + 0.5,
              w - half - 0.5] + [w >> v for v in range(n_levels)]
        cy = np.resize(np.asarray(ys, np.float64), n)
        cx = np.resize(np.asarray(xs[::-1], np.float64), n)
    elif case == "levels":
        lvl = np.resize(np.array([-1, n_levels, -7, n_levels + 3, 0,
                                  n_levels - 1]), n)
        kf = np.resize(np.array([-1, n_kf, 0, n_kf - 1, -4, n_kf + 2, 1]), n)
    elif case == "nonfinite":
        bad = [np.nan, np.inf, -np.inf, 1e30, -1e30, 3e9, -3e9]
        cy[:len(bad)] = bad
        cx[:len(bad)] = bad[::-1]
        cy[len(bad):2 * len(bad)] = bad[3:] + bad[:3]
    elif case == "empty":
        lvl, kf, cy, cx = lvl[:0], kf[:0], cy[:0], cx[:0]
    elif case not in ("spread", "int32"):
        raise ValueError(f"unknown tile case {case!r}")
    idx = np.int32 if case == "int32" else np.int64
    return (lvl.astype(idx), kf.astype(idx),
            np.stack([cy, cx], -1).astype(np.float32))


def tile_gather_mismatches(pyr: torch.Tensor, ring: torch.Tensor,
                           rng: np.random.Generator,
                           tiles: tuple = TILE_SIZES, n: int = 300
                           ) -> list[tuple]:
    """Hold both gathers of ``ops.cuda_tiles``, in centres mode and with
    the origins given, against their plain versions on the device of
    ``pyr`` [L, H, W] and ``ring`` [K, L, H, W]: every case of
    :func:`tile_case`, "nonfinite" included, with the centres read by stride
    (columns of a wider array, or of its transpose), ``torch.equal`` on the
    tiles and all four origin vectors, and one launch of each kernel a
    call. Returns the (tile, case, output) that differ; [] when all agree."""
    K, L, h, w = ring.shape
    dev = pyr.device
    kernels = (cuda_tiles.GATHER_TILES, cuda_tiles.GATHER_TILES_RING)
    names = [f"{m} {o}" for m in ("pyramid", "ring")
             for o in ("tiles", "y0", "x0", "lh", "lw")]
    bad = []
    for R in tiles:
        for i, case in enumerate(TILE_CASES + ("nonfinite",)):
            lvl, kf, cyx = tile_case(rng, case, n, h, w, L, K, R)
            lvl, kf = (torch.from_numpy(a).to(dev) for a in (lvl, kf))
            wide = np.concatenate([cyx, cyx[:, :1]], 1)
            cyx = (torch.from_numpy(wide).to(dev)[:, :2] if i % 2 else
                   torch.from_numpy(wide.T.copy()).to(dev).T[:, :2])
            before = [k.launches for k in kernels]
            got = cuda_tiles.extract_tiles(pyr, lvl, cyx, R, R)
            got += cuda_tiles.extract_tiles_ring(ring, kf, lvl, cyx, R, R)
            step = int(lvl.shape[0] > 0)
            if [k.launches for k in kernels] != [b + step for b in before]:
                bad.append((R, case, "launches"))
            want = cuda_tiles.extract_tiles_plain(pyr, lvl, cyx, R, R)
            want += cuda_tiles.extract_tiles_ring_plain(ring, kf, lvl, cyx,
                                                        R, R)
            # origins given: the TPU kernels' own signature
            lc = lvl.clamp(0, L - 1)
            got += (cuda_tiles.gather_tiles(pyr, lc, want[1], want[2], R, R),
                    cuda_tiles.gather_tiles_ring(ring, kf.clamp(0, K - 1), lc,
                                                 want[6], want[7], R, R))
            want += (want[0], want[5])
            bad += [(R, case, name) for name, a, b in zip(
                names + ["pyramid given", "ring given"], got, want)
                if not torch.equal(a, b)]
    return bad


# ---------------------------------------------------------------------------
# tests/test_window_ba.py's visual-inertial states (the backend inputs of
# tests/test_backend_interface.py), in float64 numpy
# ---------------------------------------------------------------------------

def _quat_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _quat_rot_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qv = np.concatenate([[0.0], v])
    conj = q * np.array([1.0, -1.0, -1.0, -1.0])
    return _quat_mul_np(_quat_mul_np(q, qv), conj)[1:]


def vi_sequence(n_states: int = 5, state_dt: float = 0.2,
                rate: float = 200.0) -> tuple[dict, list]:
    """tests/test_window_ba.py's ``simulate_vi`` in float64: a body turning
    and accelerating (gravity −9.81 z) integrated at ``rate`` with four
    substeps. Returns (states {q [n, 4] wxyz T_world_body, p [n, 3],
    v [n, 3], t [n]} every ``state_dt``, the IMU stream [(t, gyro,
    specific force in the body frame)])."""
    g = np.array([0.0, 0.0, -9.81])
    dt = 1.0 / rate
    n_total = int(n_states * state_dt * rate) + 1
    q, v, p = np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3), np.zeros(3)
    qs, vs, ps, stream = [q], [v], [p], []
    for i in range(n_total):
        t = i * dt
        w = np.array([0.3 * np.sin(t), 0.2, -0.25 * np.cos(t)])
        a_w = np.array([0.6 * np.cos(t), -0.4, 0.3 * np.sin(2 * t)])
        conj = q * np.array([1.0, -1.0, -1.0, -1.0])
        stream.append((t, w.astype(np.float32),
                       _quat_rot_np(conj, a_w - g).astype(np.float32)))
        for _ in range(4):
            sdt = dt / 4
            p = p + v * sdt + 0.5 * a_w * sdt * sdt
            v = v + a_w * sdt
            th = w * sdt
            ang = np.linalg.norm(th)
            dq = np.concatenate([[np.cos(ang / 2)],
                                 np.sin(ang / 2) * th / max(ang, 1e-300)])
            q = _quat_mul_np(q, dq)
            q = q / np.linalg.norm(q)
        qs.append(q)
        vs.append(v)
        ps.append(p)
    per = int(state_dt * rate)
    idx = [k * per for k in range(n_states)]
    states = dict(q=np.stack([qs[i] for i in idx]),
                  p=np.stack([ps[i] for i in idx]),
                  v=np.stack([vs[i] for i in idx]),
                  t=np.array([i * dt for i in idx]))
    # the stream up to the last state, as the backend test feeds it
    return states, [m for m in stream if m[0] <= states["t"][-1] + 1e-9]


def quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """3×3 rotation of a unit quaternion (w, x, y, z), float64."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


# ---------------------------------------------------------------------------
# feature grids and the synthetic sliding-window BA problem
# ---------------------------------------------------------------------------

def grid_features(n_grid: int = 10, border: float = 20,
                  cam: proj.Camera | None = None, plane_z: float = PLANE_Z
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """An ``n_grid``² feature grid on the reference view of the plane
    ``z = plane_z`` with exact depths (distance along the ray): (px [N, 2],
    f [N, 3], depth [N]). ``cam`` defaults to the toolkit's pinhole."""
    if cam is None:
        cam = proj.Camera.pinhole(*INTRINSICS, W, H)
    us = np.linspace(border, cam.width - border, n_grid)
    vs = np.linspace(border, cam.height - border, n_grid)
    uu, vv = np.meshgrid(us, vs)
    px = torch.as_tensor(np.stack([uu.ravel(), vv.ravel()], -1)
                         .astype(np.float32), device=cam.device)
    f = proj.backproject(cam, px)
    return px, f, plane_z / f[:, 2]


def synthetic_ba_window(S: int = 8, n_landmarks: int = 200, L: int = 256,
                        No: int = 1024, obs_per_state: int = 120,
                        imu_rate: float = 200.0, state_dt: float = 0.2,
                        seed: int = 0, device=None):
    """A consistent VI window at the reference's backend shape
    (ceres_backend_interface.hpp:21-58: 5 keyframes + 3 IMU frames = 8
    states): forward motion at constant velocity, landmarks in a box ahead,
    exact unit-plane bearings (state s sees landmarks 7·s ... 7·s +
    ``obs_per_state`` − 1, wrapped), stationary-consistent IMU factors. The
    JAX toolkit's ``synthetic_ba_window``, bench.py's ``ba_iters_per_s``
    input."""
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    vel = torch.tensor([0.5, 0.0, 0.0])
    ts = torch.arange(S, dtype=f32) * state_dt
    p = ts[:, None] * vel[None]
    q = torch.tensor([1.0, 0.0, 0.0, 0.0]).repeat(S, 1)
    w = wba.make_window(S, L, No)
    w = w._replace(q=q, p=p, v=vel.repeat(S, 1),
                   state_valid=torch.ones((S,), dtype=torch.bool))

    lm = torch.as_tensor(rng.uniform([-2.5, -2.0, 2.0], [3.5, 2.0, 8.0],
                                     (n_landmarks, 3)).astype(np.float32))
    lm_pos, lm_valid = w.lm_pos.clone(), w.lm_valid.clone()
    lm_pos[:n_landmarks] = lm
    lm_valid[:n_landmarks] = True

    per = min(obs_per_state, n_landmarks, No // S)
    lm_idx = ((torch.arange(S)[:, None] * 7 + torch.arange(per)[None])
              % n_landmarks)                                   # [S, per]
    pb = quat_rotate(quat_conjugate(q)[:, None], lm[lm_idx] - p[:, None])
    f = pb / torch.linalg.norm(pb, dim=-1, keepdim=True)       # [S, per, 3]
    n_obs = S * per
    obs_state, obs_lm = w.obs_state.clone(), w.obs_lm.clone()
    obs_f, obs_valid = w.obs_f.clone(), w.obs_valid.clone()
    obs_state[:n_obs] = torch.arange(S).repeat_interleave(per)
    obs_lm[:n_obs] = lm_idx.reshape(-1)
    obs_f[:n_obs] = f.reshape(-1, 3)
    obs_valid[:n_obs] = True

    # IMU factors: constant-velocity segments (zero rotation, gravity-only
    # specific force), consistent with the states
    n_samp = int(imu_rate * state_dt) + 1
    t_seg = torch.linspace(0.0, state_dt, n_samp)
    win = ImuWindow(t_seg, torch.zeros((n_samp, 3)),
                    torch.tensor([0.0, 0.0, 9.81]).repeat(n_samp, 1),
                    torch.ones((n_samp,), dtype=torch.bool))
    factor = imf.preintegrate_with_cov(win, torch.zeros(3), torch.zeros(3),
                                       1e-3, 1e-2, range(n_samp - 1))
    info = imf.imu_information(factor, 1e-4, 1e-3)
    stacked = wba.tree_map(
        lambda x: x[None].repeat((S - 1,) + (1,) * x.ndim), factor)
    w = w._replace(lm_pos=lm_pos, lm_valid=lm_valid, obs_state=obs_state,
                   obs_lm=obs_lm, obs_f=obs_f, obs_valid=obs_valid,
                   imu=stacked, imu_info=info[None].repeat(S - 1, 1, 1),
                   imu_valid=torch.ones((S - 1,), dtype=torch.bool))
    return wba.tree_map(lambda x: x.to(device), w) if device else w
