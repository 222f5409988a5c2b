"""The benchmark's inputs: a frozen copy of the port's synthetic EuRoC-size
scene, rendered and degraded on the device from the seed.

Copied from ``svo_pro_universal_tpu_torch/testing/synthetic.py`` (the
sphere before a slanted plane, ``loop_twist``, ``bench_twist``,
``degrade_sequence``, ``bench_imu_stream``) and rewritten to work on whole
sequences at once: the benchmark owns this copy, so a later change to the
port's test helpers cannot move its inputs. It imports nothing of the
port.

The trajectory and the scene come from the traffic file and are the same
for every seed; the seed drives only the camera's noise (the exposure
gain and offset walk, the motion-blur shift, the sensor noise). The
bootstrap laps that the traffic names (``bootstrap``: the first laps, fed
in set-up, from which the port's FivePoint initialization builds its first
map) take their noise from the traffic's own fixed seed, so every seed
starts its window from the same initialized map. Images are
rendered and degraded on the device in a few large calls and handed to the
program as host uint8 arrays, as a camera driver hands them over.
"""

from __future__ import annotations

import numpy as np
import torch

GRAVITY_W = np.array([0.0, 0.0, -9.81])


# ---------------------------------------------------------------------------
# trajectories: twist of T_cam_world at frame time t (frames), float64
# ---------------------------------------------------------------------------

def loop_twist(t: np.ndarray, period: float, radius: float) -> np.ndarray:
    """bench.py's closed loop: a lap of ``period`` frames that returns to
    its start. [..., 6] = (v, w)."""
    a = 2.0 * np.pi * np.asarray(t, np.float64) / period
    r = radius
    z = np.zeros_like(a)
    return np.stack([r * np.sin(a), 0.05 * np.sin(2 * a),
                     0.5 * r * (1.0 - np.cos(a)), 0.02 * np.sin(a),
                     0.03 * np.sin(a), z], -1).astype(np.float32).astype(
                         np.float64)


TRAJECTORIES = {"loop": loop_twist}


def se3_exp(tw: np.ndarray) -> np.ndarray:
    """[..., 4, 4] exp of twists [..., 6] = (v, w), in float64."""
    tw = np.asarray(tw, np.float64)
    v, w = tw[..., :3], tw[..., 3:]
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    K = np.zeros(tw.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 0], K[..., 1, 2] = w[..., 2], -w[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -w[..., 1], w[..., 0]
    K2 = K @ K
    eye = np.broadcast_to(np.eye(3), K.shape)
    small = th < 1e-10
    ths = np.where(small, 1.0, th)
    A = np.where(small, 1.0, np.sin(ths) / ths)
    B = np.where(small, 0.5, (1 - np.cos(ths)) / ths ** 2)
    C = np.where(small, 0.0, (ths - np.sin(ths)) / ths ** 3)
    R = eye + A * K + B * K2
    V = eye + B * K + C * K2
    T = np.zeros(tw.shape[:-1] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = np.einsum("...ij,...j->...i", V, v)
    T[..., 3, 3] = 1.0
    return T


def poses(traffic: dict, frames: np.ndarray) -> np.ndarray:
    """T_cam_world [n, 4, 4] (float64) of the given frame indices."""
    tr = traffic["trajectory"]
    fn = TRAJECTORIES[tr["kind"]]
    return se3_exp(fn(np.asarray(frames, np.float64), tr["period_frames"],
                      tr["radius_m"]))


def imu_stream(traffic: dict, n_frames: int) -> tuple[np.ndarray, ...]:
    """(t [M], gyro [M, 3], acc [M, 3]) at the IMU rate, consistent with
    the trajectory (body = camera), by finite differences of the poses:
    gyro from the rotation increment, specific force R_bwᵀ(a_w − g). The
    same stream for every seed (bench.py's noise-free IMU)."""
    rate = float(traffic["imu_rate_hz"])
    cam_dt = 1.0 / float(traffic["camera_rate_hz"])
    sub = int(round(rate * cam_dt))
    n = n_frames * sub
    T_wb = np.linalg.inv(poses(traffic, np.arange(n + 2) / sub))
    R, p = T_wb[:, :3, :3], T_wb[:, :3, 3]
    dR = np.einsum("nji,njk->nik", R[:-1], R[1:])[:n]
    dt = 1.0 / rate
    gyro = np.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0],
                     dR[:, 1, 0] - dR[:, 0, 1]], -1) * 0.5 / dt
    a_w = (p[2:] - 2 * p[1:-1] + p[:-2]) / dt ** 2
    acc = np.einsum("nji,nj->ni", R[:n], a_w - GRAVITY_W)
    return (np.arange(n) * dt, gyro.astype(np.float32),
            acc.astype(np.float32))


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _texture(p: torch.Tensor) -> torch.Tensor:
    """Smooth sinusoids plus a hard 3D checker (corner-rich junctions)."""
    x, y, z = p.unbind(-1)
    smooth = (115.0 + 35.0 * torch.sin(4.0 * x) * torch.cos(5.0 * y)
              + 25.0 * torch.sin(3.0 * (x + z)))
    checker = (25.0 * torch.sign(torch.sin(14.0 * x + 0.7))
               * torch.sign(torch.sin(14.0 * y + 0.3))
               * torch.sign(torch.sin(11.0 * z + 0.5)))
    return torch.clamp(smooth + checker, 0.0, 255.0)


def bearings(camera: dict, device) -> torch.Tensor:
    """[H·W, 3] unit pinhole bearings of every pixel (float32)."""
    fx, fy, cx, cy = camera["intrinsics"]
    w, h = camera["width"], camera["height"]
    yy, xx = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    f = torch.stack([(xx.reshape(-1).float() - cx) / fx,
                     (yy.reshape(-1).float() - cy) / fy,
                     torch.ones(h * w, device=device)], -1)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def render(scene: dict, camera: dict, T_cam_world: np.ndarray, device
           ) -> torch.Tensor:
    """uint8 [n, H, W] views of the sphere + plane scene from the poses
    [n, 4, 4]: the nearest positive sphere hit, else the plane."""
    f = bearings(camera, device)
    Twc = torch.as_tensor(np.linalg.inv(T_cam_world).astype(np.float32),
                          device=device)
    c = torch.tensor(scene["sphere_center"], device=device)
    n = torch.tensor(scene["plane_normal"], device=device)
    out = []
    for T in Twc:
        d = f @ T[:3, :3].T
        o = T[:3, 3]
        oc = o - c
        b = d @ oc
        disc = b * b - (oc @ oc - scene["sphere_radius"] ** 2)
        hit = disc > 0
        ts = torch.where(hit, -b - torch.sqrt(torch.clamp(disc, min=0.0)),
                         -1.0)
        den = d @ n
        tp = (scene["plane_d"] - o @ n) / torch.where(torch.abs(den) > 1e-9,
                                                      den, 1e-9)
        t = torch.where(hit & (ts > 0), ts, tp)
        img = _texture(o[None] + t[:, None] * d)
        out.append(img.reshape(camera["height"], camera["width"]))
    return torch.stack(out).to(torch.uint8)


# ---------------------------------------------------------------------------
# camera degradation (seeded)
# ---------------------------------------------------------------------------

def _walk_draws(n: int, seed: int) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 2))
    dy = rng.integers(-1, 2, size=n)
    dx = rng.integers(-2, 3, size=n)
    return z, dy, dx


def exposure_walk(degrade: dict, n: int, seed: int, fixed: int = 0,
                  fixed_seed: int = 0) -> np.ndarray:
    """[n, 4] per frame (gain, offset, blur dy, blur dx): the
    mean-reverting exposure walk and the motion-blur shift, from ``seed``
    (a few hundred scalars, drawn on the host). The first ``fixed``
    frames draw theirs as ``fixed_seed`` does; the walk runs on from
    there."""
    z, dy, dx = _walk_draws(n, seed)
    if fixed:
        z0, dy0, dx0 = _walk_draws(n, fixed_seed)
        z[:fixed], dy[:fixed], dx[:fixed] = (z0[:fixed], dy0[:fixed],
                                             dx0[:fixed])
    lo, hi = 1.0 - degrade["exposure_drift"], 1.0 + degrade["exposure_drift"]
    out = np.zeros((n, 4))
    gain, offs = 1.0, 0.0
    for i in range(n):
        gain += degrade["gain_walk_sigma"] * z[i, 0] - 0.1 * (gain - 1.0)
        offs += degrade["offset_walk_sigma"] * z[i, 1] - 0.1 * offs
        gain = float(np.clip(gain, lo, hi))
        out[i] = gain, offs, dy[i], dx[i]
    return out


def degrade(clean: torch.Tensor, walk: np.ndarray, degrade_cfg: dict,
            gen: torch.Generator, first: int = 0) -> torch.Tensor:
    """Camera-realistic degradation of uint8 frames [n, H, W] on their
    device, frames ``first``.. of the sequence: the exposure gain and
    offset, a 3-tap motion blur along the frame's shift (not on the
    sequence's frame 0), radial vignetting, Gaussian sensor noise from
    ``gen``, uint8 quantization."""
    n, h, w = clean.shape
    dev = clean.device
    yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    r2 = ((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2
    vig = 1.0 - degrade_cfg["vignette"] * r2 / 2.0
    wk = torch.as_tensor(walk, dtype=torch.float32, device=dev)
    g = clean.float() * wk[:, 0, None, None] + wk[:, 1, None, None]
    if degrade_cfg["blur"]:
        out = [g[0]] if first == 0 else []
        for i in range(1 if first == 0 else 0, n):
            sh = torch.roll(g[i], (int(walk[i, 2]), int(walk[i, 3])), (0, 1))
            out.append((2.0 * g[i] + sh) / 3.0)
        g = torch.stack(out)
    noise = torch.randn(g.shape, generator=gen, device=dev)
    g = g * vig + degrade_cfg["noise_sigma"] * noise
    return torch.clamp(g, 0, 255).to(torch.uint8)


def make_frames(scene: dict, camera: dict, traffic: dict, n: int,
                seed: int, device) -> np.ndarray:
    """uint8 [n, H, W] frames 0..n-1 on the host: each lap's clean views
    rendered once on ``device``, degraded lap by lap with the seed's noise
    (the bootstrap laps' with the traffic's fixed seed), copied back in one
    pinned buffer."""
    period = int(traffic["trajectory"]["period_frames"])
    clean = render(scene, camera, poses(traffic, np.arange(period)), device)
    dg = traffic["degrade"]
    boot = traffic.get("bootstrap", {"laps": 0, "seed": 0})
    fixed = min(int(boot["laps"]) * period, n)
    walk = exposure_walk(dg, n, seed, fixed, int(boot["seed"]))
    gen, gen_boot = (torch.Generator(device=device),
                     torch.Generator(device=device))
    gen.manual_seed(seed % (1 << 63))
    gen_boot.manual_seed(int(boot["seed"]) % (1 << 63))
    h, w = camera["height"], camera["width"]
    host = torch.empty((n, h, w), dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")
    for i0 in range(0, n, period):
        idx = torch.arange(i0, min(i0 + period, n), device=device)
        part = degrade(clean[idx % period], walk[i0:i0 + period], dg,
                       gen_boot if i0 < fixed else gen, first=i0)
        host[i0:i0 + len(idx)].copy_(part, non_blocking=True)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return host.numpy()
