"""SO(3)/SE(3) on unit quaternions, batched, in PyTorch.

Counterpart of ``svo_pro_universal_tpu/utils/transform.py`` (the reference's
minkindr pose types, 3rd/minkindr/include/kindr/minimal/quat-transformation.h).
Quaternions are stored ``[w, x, y, z]``; twists are ``[v(3), w(3)]``
(translation first). Every function broadcasts over leading batch dims and
keeps the JAX package's operation order, so float32 results agree with it to
the last few ulps. Small-angle branches are Taylor expansions selected with
``torch.where``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_EPS = 1e-8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    # built on the device: a host list, or an item assignment of a Python
    # scalar, would be a host→device copy that synchronizes the stream
    return (torch.arange(4, device=device) == 0).to(dtype)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    uv = _cross(qv, v)
    return v + 2.0 * (qw * uv + _cross(qv, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → unit quaternion (wxyz), branch-free Shepperd."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    one = torch.ones_like(tr)

    def mk(w2, xw, yw, zw):
        return torch.stack([w2, xw, yw, zw], dim=-1)

    q0 = mk(one + tr, m21 - m12, m02 - m20, m10 - m01)
    q1 = mk(m21 - m12, one + m00 - m11 - m22, m01 + m10, m02 + m20)
    q2 = mk(m02 - m20, m01 + m10, one + m11 - m00 - m22, m12 + m21)
    q3 = mk(m10 - m01, m02 + m20, m12 + m21, one + m22 - m00 - m11)
    cands = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                         m22 - m00 - m11], dim=-1)
    best = torch.argmax(cands, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def matrix_to_quat_np(m) -> np.ndarray:
    """Host (numpy) rotation matrix → float32 wxyz quaternion, for the
    per-frame host paths (the gyro motion prior) that must not touch the
    card."""
    m = np.asarray(m, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    cands = [tr, m[0, 0] - m[1, 1] - m[2, 2],
             m[1, 1] - m[0, 0] - m[2, 2], m[2, 2] - m[0, 0] - m[1, 1]]
    i = int(np.argmax(cands))
    if i == 0:
        q = np.array([1.0 + tr, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                      m[1, 0] - m[0, 1]])
    elif i == 1:
        q = np.array([m[2, 1] - m[1, 2], 1.0 + m[0, 0] - m[1, 1] - m[2, 2],
                      m[0, 1] + m[1, 0], m[0, 2] + m[2, 0]])
    elif i == 2:
        q = np.array([m[0, 2] - m[2, 0], m[0, 1] + m[1, 0],
                      1.0 + m[1, 1] - m[0, 0] - m[2, 2],
                      m[1, 2] + m[2, 1]])
    else:
        q = np.array([m[1, 0] - m[0, 1], m[0, 2] + m[2, 0],
                      m[1, 2] + m[2, 1],
                      1.0 + m[2, 2] - m[0, 0] - m[1, 1]])
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    return q.astype(np.float32)


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


# ---------------------------------------------------------------------------
# SO(3) exp/log
# ---------------------------------------------------------------------------

def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector → quaternion (wxyz)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    half = 0.5 * theta
    small = theta2 < 1e-8
    k = torch.where(small, 0.5 - theta2 / 48.0,
                    torch.sin(half) / torch.clamp(theta, min=_EPS))
    qw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([qw, k * w], dim=-1))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (wxyz) → axis-angle vector."""
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    qw = torch.clamp(q[..., 0:1], -1.0, 1.0)
    qv = q[..., 1:4]
    sin_half = torch.sqrt(torch.sum(qv * qv, dim=-1, keepdim=True) + 1e-24)
    half = torch.atan2(sin_half, qw)
    small = sin_half < 1e-6
    k = torch.where(small, 2.0 + (2.0 * half) ** 2 / 12.0,
                    2.0 * half / torch.clamp(sin_half, min=_EPS))
    return k * qv


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    W = skew(w)
    W2 = W @ W
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return _eye_like(W) + a * W + b * W2


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

class SE3(NamedTuple):
    """Rigid transform T: x_out = R(q) x + t. Batched over leading dims."""

    q: torch.Tensor  # [..., 4] wxyz
    t: torch.Tensor  # [..., 3]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        q = quat_identity(dtype, device).expand(tuple(batch_shape) + (4,))
        t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        return SE3(q.clone(), t)

    @staticmethod
    def from_matrix(m: torch.Tensor) -> "SE3":
        return SE3(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])

    def rotation_matrix(self) -> torch.Tensor:
        return quat_to_matrix(self.q)

    def as_matrix(self) -> torch.Tensor:
        r = quat_to_matrix(self.q)
        top = torch.cat([r, self.t[..., :, None]], dim=-1)
        bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                             device=top.device)
        bottom[..., 3] = 1.0
        return torch.cat([top, bottom], dim=-2)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return quat_rotate(self.q, x) + self.t

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        return quat_rotate(self.q, x)

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: (self @ other)(x) = self(other(x))."""
        return SE3(quat_normalize(quat_multiply(self.q, other.q)),
                   quat_rotate(self.q, other.t) + self.t)

    def __matmul__(self, other):
        """``self @ other``: the composition for an ``SE3``, else the
        transform applied to the points ``other``."""
        if isinstance(other, SE3):
            return self.compose(other)
        return self.apply(other)

    def inverse(self) -> "SE3":
        qinv = quat_conjugate(self.q)
        return SE3(qinv, -quat_rotate(qinv, self.t))

    def normalized(self) -> "SE3":
        return SE3(quat_normalize(self.q), self.t)

    def index(self, idx) -> "SE3":
        """Leading-axis gather of both leaves."""
        return SE3(self.q[idx], self.t[idx])

    def where(self, cond: torch.Tensor, other: "SE3") -> "SE3":
        """Elementwise select: self where ``cond`` else ``other``."""
        return SE3(torch.where(cond[..., None], self.q, other.q),
                   torch.where(cond[..., None], self.t, other.t))


def se3_exp(twist: torch.Tensor) -> SE3:
    """Twist [v(3), w(3)] → SE3 (full exponential with V-matrix)."""
    v, w = twist[..., 0:3], twist[..., 3:6]
    q = so3_exp(w)
    V = so3_left_jacobian(w)
    t = torch.einsum("...ij,...j->...i", V, v)
    return SE3(q, t)


def se3_log(T: SE3) -> torch.Tensor:
    """SE3 → twist [v, w]."""
    w = so3_log(T.q)
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    W = skew(w)
    W2 = W @ W
    small = theta2 < 1e-8
    half = 0.5 * theta
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.clamp(torch.sin(half), min=_EPS)) / theta2)
    Vinv = _eye_like(W) - 0.5 * W + cot_term * W2
    v = torch.einsum("...ij,...j->...i", Vinv, T.t)
    return torch.cat([v, w], dim=-1)


def se3_boxplus(T: SE3, twist: torch.Tensor) -> SE3:
    """Left-multiplicative update: exp(twist) ∘ T (the GN solvers' rule)."""
    return se3_exp(twist).compose(T)


def se3_distance(a: SE3, b: SE3) -> tuple[torch.Tensor, torch.Tensor]:
    """(translation distance, rotation angle in radians) between poses."""
    dt = torch.linalg.norm(a.t - b.t, dim=-1)
    ang = torch.linalg.norm(so3_log(quat_multiply(quat_conjugate(a.q), b.q)),
                            dim=-1)
    return dt, ang


def se3_interpolate(a: SE3, b: SE3, alpha) -> SE3:
    """Geodesic interpolation a ∘ exp(alpha · log(a⁻¹ b))."""
    return a.compose(se3_exp(alpha * se3_log(a.inverse().compose(b))))
