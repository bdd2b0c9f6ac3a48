"""SO(3) / SE(3) operations on batched torch tensors.

Port of the parts of `orb_slam2_e_tpu/ops/lie.py` the RGB-D path reaches,
with the same conventions:
- rotations are (..., 3, 3) matrices; quaternions (..., 4) are (w, x, y, z);
- SE(3) tangents are (..., 6) = [omega, upsilon];
- poses are Tcw: x_cam = R @ x_world + t; the pool format is
  (..., 7) = [qw qx qy qz tx ty tz].

Small-angle branches are `torch.where` selections on quantities computed
before any sqrt, as in the reference, so both branches stay finite.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _stack33(rows):
    """Build (..., 3, 3) from a nested 3x3 list of (...,) tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return _stack33([[z, -wz, wy], [wz, z, -wx], [-wy, wx, z]])


def so3_vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula exp: so(3) -> SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-10
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = so3_hat(w)
    W2 = W @ W
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    return (_eye3(w, W.shape) + a[..., None, None] * W
            + b[..., None, None] * W2)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> so(3), safe near the identity and near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w_vee = so3_vee(R - R.transpose(-1, -2)) * 0.5
    sin2 = torch.sum(w_vee * w_vee, dim=-1)
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    near_pi = cos_t < -0.99
    small = (sin2 < 1e-12) & ~near_pi
    safe_cos = torch.where(small, torch.zeros_like(cos_t),
                           torch.clamp(cos_t, -0.9999999, 0.9999999))
    theta = torch.arccos(safe_cos)
    sin_t = torch.sqrt(torch.where(sin2 < 1e-12, torch.ones_like(sin2), sin2))
    scale = torch.where(small, 1.0 + (3.0 - trace) / 6.0, theta / sin_t)
    w = w_vee * scale[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    one = torch.ones_like(axis_abs[..., 0])
    sy = torch.where(R[..., 0, 1] + R[..., 1, 0] >= 0, one, -one)
    sz = torch.where(R[..., 0, 2] + R[..., 2, 0] >= 0, one, -one)
    axis_pi = axis_abs * torch.stack([one, sy, sz], dim=-1)
    axis_pi = axis_pi / torch.clamp(
        torch.linalg.norm(axis_pi, dim=-1, keepdim=True), min=_EPS)
    return torch.where(near_pi[..., None], axis_pi * theta[..., None], w)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3) (translation coupling of se3_exp)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-10
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = so3_hat(w)
    W2 = W @ W
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    return (_eye3(w, W.shape) + b[..., None, None] * W
            + c[..., None, None] * W2)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    return torch.where(q[..., :1] < 0, -q, q)


def mat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) (w,x,y,z) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return _stack33([
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ])


def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w,x,y,z), branch-free Shepperd:
    all four candidate constructions are built and the largest pivot wins
    (reference lie.py:168-198)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def piv(v):
        return torch.sqrt(torch.clamp(v, min=0.0)) * 0.5

    def den(v):
        return torch.clamp(4 * v, min=_EPS)

    qw = piv(1.0 + tr)
    q0 = torch.stack([qw, (m21 - m12) / den(qw), (m02 - m20) / den(qw),
                      (m10 - m01) / den(qw)], dim=-1)
    qx = piv(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / den(qx), qx, (m01 + m10) / den(qx),
                      (m02 + m20) / den(qx)], dim=-1)
    qy = piv(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / den(qy), (m01 + m10) / den(qy), qy,
                      (m12 + m21) / den(qy)], dim=-1)
    qz = piv(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / den(qz), (m02 + m20) / den(qz),
                      (m12 + m21) / den(qz), qz], dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)           # (..., 4, 4)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)                     # first max wins
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SE(3) as (R, t) pairs + packed (..., 7) pool format
# ---------------------------------------------------------------------------

def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum('...ij,...j->...i', M, v)


def se3_exp(xi: torch.Tensor):
    """Tangent (..., 6) [omega, upsilon] -> (R, t)."""
    w, v = xi[..., :3], xi[..., 3:]
    return so3_exp(w), _matvec(so3_left_jacobian(w), v)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)


def se3_compose(R1, t1, R2, t2):
    """T1 * T2: apply T2 first."""
    return R1 @ R2, _matvec(R1, t2) + t1


def se3_apply(R, t, p):
    """Transform points p (..., 3) (broadcasts over point batches)."""
    return _matvec(R, p) + t


def pose7_pack(R, t):
    return torch.cat([quat_from_mat(R), t], dim=-1)


def pose7_unpack(p7):
    return mat_from_quat(quat_normalize(p7[..., :4])), p7[..., 4:]


def pose7_identity(shape=(), *, device, dtype=torch.float32):
    p = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    p[..., 0] = 1.0
    return p
