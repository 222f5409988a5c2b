"""Writing a sequence as an ASL (EuRoC MAV) folder, for the tests and the
card smoke run: cam0 (and cam1) PNGs named by their nanosecond stamps with
their data.csv, the IMU CSV, the ground-truth CSV, and a one-camera rig
calibration in the reference's schema. PNGs are written with the standard
library's zlib, one filter type a row (any of the five), in 8-bit gray or
any colour format ``native_loader`` reads.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from svo_pro_universal_tpu_torch.utils import yaml_lite
from svo_pro_universal_tpu_torch.utils.transform import matrix_to_quat

# EuRoC MH_01_easy's first camera stamp: sequences written at the dataset's
# epoch, where float32 seconds resolve 128 s
EUROC_T0_NS = 1403636579763555584


def _filtered(rows: np.ndarray, bpp: int, kind: int) -> bytes:
    """PNG scanlines with filter ``kind`` (0-4) on every row."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for r in rows.astype(np.int64):
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            f = r
        elif kind == 1:
            f = r - a
        elif kind == 2:
            f = r - prev
        elif kind == 3:
            f = r - (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            f = r - np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, prev, c))
        out.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def write_png(path, img: np.ndarray, filt: int = 0, color: int = 0,
              depth: int = 8, level: int = 6) -> None:
    """A PNG of ``img`` ([H, W] or [H, W, C], uint8, or uint16 at depth 16)
    with filter ``filt`` on every row; ``color`` is the PNG colour type."""
    h, w = img.shape[:2]
    if depth == 16:
        rows = img.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        rows = np.ascontiguousarray(img, np.uint8).reshape(h, -1)
    bpp = rows.shape[1] // w

    def chunk(tag, data):
        c = tag + data
        return (struct.pack(">I", len(data)) + c
                + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(_filtered(rows, bpp, filt),
                                             level)))
        f.write(chunk(b"IEND", b""))


def write_asl(root, frames, cam_ns, gt_T_world_body, imu=(), frames1=None,
              level: int = 6) -> None:
    """``root``/mav0: cam0 (and cam1) PNGs named by their integer ns stamp
    (frame k with filter k mod 5), the IMU CSV (t_ns, gyro, acc), and the
    ground truth (t_ns, p, q wxyz of each 4×4 T_world_body)."""
    mav = os.path.join(root, "mav0")
    for cam, imgs in (("cam0", frames), ("cam1", frames1)):
        if imgs is None:
            continue
        os.makedirs(os.path.join(mav, cam, "data"))
        with open(os.path.join(mav, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for k, (ns, img) in enumerate(zip(cam_ns, imgs)):
                write_png(os.path.join(mav, cam, "data", f"{ns}.png"),
                          np.asarray(img), filt=k % 5, level=level)
                f.write(f"{ns},{ns}.png\n")
    os.makedirs(os.path.join(mav, "imu0"))
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for ns, g, a in imu:
            f.write(f"{ns}," + ",".join(repr(float(v)) for v in (*g, *a))
                    + "\n")
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"))
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"),
              "w") as f:
        f.write("#timestamp, p_RS_R_x, p_RS_R_y, p_RS_R_z, q_RS_w, q_RS_x, "
                "q_RS_y, q_RS_z\n")
        for ns, T in zip(cam_ns, gt_T_world_body):
            T = np.asarray(T, np.float64)
            q = matrix_to_quat(torch.as_tensor(T[:3, :3],
                                               dtype=torch.float32)).numpy()
            f.write(f"{ns}," + ",".join(repr(float(v))
                                        for v in (*T[:3, 3], *q)) + "\n")


def write_calib(path, intrinsics, width: int, height: int,
                imu_params=None) -> None:
    """A one-camera pinhole rig calibration (no distortion, body at the
    camera) in the reference's schema; ``imu_params`` (a dataclass) adds
    its ``imu_params`` block."""
    fx, fy, cx, cy = (repr(float(np.float32(v))) for v in intrinsics)
    text = f"""label: synthetic
cameras:
- camera:
    label: cam0
    image_width: {width}
    image_height: {height}
    type: pinhole
    intrinsics:
      cols: 1
      rows: 4
      data: [{fx}, {fy}, {cx}, {cy}]
    distortion:
      type: none
      parameters: {{cols: 1, rows: 1, data: [0.0]}}
  T_B_C:
    cols: 4
    rows: 4
    data: [1, 0, 0, 0,  0, 1, 0, 0,  0, 0, 1, 0,  0, 0, 0, 1]
"""
    if imu_params is not None:
        text += yaml_lite.dump({"imu_params": {
            k: float(v) for k, v in vars(imu_params).items()}})
    with open(path, "w") as f:
        f.write(text)
