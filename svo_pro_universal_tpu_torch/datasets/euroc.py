"""EuRoC MAV (ASL folder format) dataset loader.

The port's own copy of ``svo_pro_universal_tpu/datasets/euroc.py`` (reference
examples/dataset/euroc.hpp:20-130: cam CSVs with nanosecond stamps and image
file names, the IMU CSV of gyro/acc rows, the ground-truth state CSV).
Layout: <root>/mav0/{cam0,cam1}/data.csv + data/*.png, imu0/data.csv,
state_groundtruth_estimate0/data.csv. Images are decoded by the PNG decoder
the dataset is given (``native_loader.decoder``: "native" or "numpy"); a
PGM (P5) is read directly. There is no PIL branch.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np

from svo_pro_universal_tpu_torch import native_loader


def read_pgm(data: bytes) -> np.ndarray:
    """8-bit binary PGM (P5) → [H, W] uint8."""
    fields, pos = [], 2
    if data[:2] != b"P5":
        raise ValueError("not a binary PGM")
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval > 255:
        raise ValueError("16-bit PGM is not supported")
    return np.frombuffer(data, np.uint8, w * h, pos + 1).reshape(h, w).copy()


def read_image(path: str, decode: Callable[[bytes], np.ndarray]
               ) -> np.ndarray:
    """An 8-bit grayscale image file (PNG through ``decode``, or PGM)."""
    with open(path, "rb") as f:
        data = f.read()
    if path.lower().endswith(".pgm"):
        return read_pgm(data)
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG and PGM images are read (no "
                         "image library is used)")
    return decode(data)


@dataclass
class ImageSample:
    timestamp: float          # seconds
    path: str
    decode: Callable[[bytes], np.ndarray]    # the dataset's PNG decoder

    def load_u8(self) -> np.ndarray:
        """The image, [H, W] uint8 (what the handlers upload)."""
        return read_image(self.path, self.decode)

    def load(self) -> np.ndarray:
        """The image as float32 [H, W] (the JAX package's ``load``)."""
        return self.load_u8().astype(np.float32)


@dataclass
class ImuSample:
    timestamp: float
    gyro: np.ndarray          # [3] rad/s
    acc: np.ndarray           # [3] m/s²


@dataclass
class GroundTruthSample:
    timestamp: float
    p: np.ndarray             # [3] position world
    q: np.ndarray             # [4] wxyz body→world


class EurocDataset:
    """An ASL folder; ``png_decoder`` names the decoder its images use
    ("native" builds the C++ library now and raises if it cannot)."""

    def __init__(self, root: str, png_decoder: str = "native"):
        self.root = root
        mav = os.path.join(root, "mav0")
        self.mav = mav if os.path.isdir(mav) else root
        self.png_decoder = png_decoder
        self._decode = native_loader.decoder(png_decoder)

    def _read_csv(self, rel: str) -> list[list[str]]:
        with open(os.path.join(self.mav, rel)) as f:
            return [r for r in csv.reader(f) if r and not r[0].startswith("#")]

    def images(self, cam: int = 0) -> list[ImageSample]:
        return [ImageSample(float(int(r[0])) * 1e-9,
                            os.path.join(self.mav, f"cam{cam}", "data",
                                         r[1].strip()), self._decode)
                for r in self._read_csv(f"cam{cam}/data.csv")]

    def imu(self) -> list[ImuSample]:
        return [ImuSample(float(int(r[0])) * 1e-9,
                          np.asarray([float(r[1]), float(r[2]), float(r[3])],
                                     np.float32),
                          np.asarray([float(r[4]), float(r[5]), float(r[6])],
                                     np.float32))
                for r in self._read_csv("imu0/data.csv")]

    def ground_truth(self) -> list[GroundTruthSample]:
        return [GroundTruthSample(
            float(int(r[0])) * 1e-9,
            np.asarray([float(x) for x in r[1:4]], np.float64),
            np.asarray([float(x) for x in r[4:8]], np.float64))
            for r in self._read_csv("state_groundtruth_estimate0/data.csv")]

    def synced_stream(self, use_cam1: bool = False,
                      t0: Optional[float] = None) -> Iterator[tuple]:
        """('imu', ImuSample) and ('image', ImageSample[, ImageSample])
        events in timestamp order, the feed of the reference's example
        mains (examples/euroc_mono_imu.cpp:41-65): every IMU sample up to
        an image's stamp before the image; with ``use_cam1`` only the cam0
        images that have a cam1 image at the same stamp (to 1 µs)."""
        imgs0 = self.images(0)
        img1_by_ts = ({round(s.timestamp, 6): s for s in self.images(1)}
                      if use_cam1 else {})
        imu = self.imu()
        i = 0
        for s0 in imgs0:
            t_img = s0.timestamp
            while i < len(imu) and imu[i].timestamp <= t_img:
                if t0 is None or imu[i].timestamp >= t0:
                    yield ("imu", imu[i])
                i += 1
            if t0 is not None and t_img < t0:
                continue
            if not use_cam1:
                yield ("image", s0)
            elif (pair := img1_by_ts.get(round(t_img, 6))) is not None:
                yield ("image", s0, pair)
