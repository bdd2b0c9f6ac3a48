"""SO(3) / SE(3) / Sim(3) operations on batched torch tensors.

Port of `orb_slam2_e_tpu/ops/lie.py`, with the same conventions:
- rotations are (..., 3, 3) matrices; quaternions (..., 4) are (w, x, y, z);
- SE(3) tangents are (..., 6) = [omega, upsilon], Sim(3) tangents (..., 7)
  = [omega, upsilon, sigma];
- poses are Tcw: x_cam = R @ x_world + t; the pool formats are
  (..., 7) = [qw qx qy qz tx ty tz] and, for Sim(3),
  (..., 8) = [qw qx qy qz tx ty tz s].

Nothing here writes in place, so every function can be differentiated in
forward mode and batched (`torch.func.jacfwd`, `torch.func.vmap`), which
the pose graph and the Sim(3) refinement do.

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


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-10
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = so3_hat(w)
    W2 = W @ W
    half_t = theta * 0.5
    sin_half = torch.where(small, torch.ones_like(theta), torch.sin(half_t))
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_t * torch.cos(half_t) / sin_half) / theta2_safe)
    return (_eye3(w, W.shape) - 0.5 * W + cot_term[..., None, None] * W2)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


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


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> tangent (..., 6) [omega, upsilon]."""
    w = so3_log(R)
    return torch.cat([w, _matvec(so3_left_jacobian_inv(w), t)], dim=-1)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)


def se3_compose(R1, t1, R2, t2):
    """T1 * T2: apply T2 first."""
    return R1 @ R2, _matvec(R1, t2) + t1


def se3_apply(R, t, p):
    """Transform points p (..., 3) (broadcasts over point batches)."""
    return _matvec(R, p) + t


def se3_to_mat4(R, t):
    """(..., 3, 3), (..., 3) -> homogeneous (..., 4, 4)."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_from_mat4(T):
    return T[..., :3, :3], T[..., :3, 3]


def pose7_pack(R, t):
    return torch.cat([quat_from_mat(R), t], dim=-1)


def pose7_unpack(p7):
    return mat_from_quat(quat_normalize(p7[..., :4])), p7[..., 4:]


def pose7_identity(shape=(), *, device, dtype=torch.float32):
    p = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    p[..., 0] = 1.0
    return p


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def sim3_exp(xi: torch.Tensor):
    """Tangent (..., 7) [omega, upsilon, sigma] -> (R, t, s) (Strasdat's
    Sim3 exp: t = W(sigma, theta) upsilon). Every small-angle / small-scale
    case is a `torch.where` over branches that are all finite."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(w)
    s = torch.exp(sigma)
    theta2 = torch.sum(w * w, dim=-1)
    small_t = theta2 < 1e-10
    theta = torch.sqrt(torch.where(small_t, torch.ones_like(theta2), theta2))
    W = so3_hat(w)
    W2 = W @ W
    one = torch.ones_like(theta)

    small_s = torch.abs(sigma) < 1e-5
    sig = torch.where(small_s, one, sigma)

    A_ss = torch.where(small_t, 0.5 * one,
                       (1 - torch.cos(theta)) / theta ** 2)
    B_ss = torch.where(small_t, one / 6.0,
                       (theta - torch.sin(theta)) / theta ** 3)
    C_gen = torch.where(small_s, one, (s - 1.0) / sig)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c2 = theta ** 2 + sig ** 2
    A_gen = (a * sig + (1.0 - b) * theta) / (theta * c2)
    B_gen = (C_gen - ((b - 1.0) * sig + a * theta) / c2) / theta ** 2
    A_t0 = torch.where(small_s, 0.5 * one,
                       ((sig - 1.0) * s + 1.0) / sig ** 2)
    B_t0 = torch.where(small_s, one / 6.0,
                       (s * (0.5 * sig ** 2 - sig + 1.0) - 1.0) / sig ** 3)

    A = torch.where(small_s & small_t, 0.5 * one,
                    torch.where(small_s, A_ss,
                                torch.where(small_t, A_t0, A_gen)))
    B = torch.where(small_s & small_t, one / 6.0,
                    torch.where(small_s, B_ss,
                                torch.where(small_t, B_t0, B_gen)))
    C = torch.where(small_s, one, C_gen)

    Wmat = (C[..., None, None] * _eye3(xi, W.shape)
            + A[..., None, None] * W + B[..., None, None] * W2)
    return R, _matvec(Wmat, v), s


def _sim3_W(w, sigma):
    """W(sigma, theta) of sim3_exp, column by column: W e_i is the
    translation of exp([w, e_i, sigma])."""
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    cols = []
    for i in range(3):
        e = eye[i].expand(w.shape)
        cols.append(sim3_exp(torch.cat([w, e, sigma[..., None]], dim=-1))[1])
    return torch.stack(cols, dim=-1)


def _solve3x3(M, b):
    """M^-1 b for (..., 3, 3) systems in closed form (the rows' cross
    products over the determinant). `torch.linalg.solve` is avoided here:
    its forward-mode derivative under `torch.func.vmap` returned NaN for
    some batch elements."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = torch.linalg.cross(r1, r2)
    c1 = torch.linalg.cross(r2, r0)
    c2 = torch.linalg.cross(r0, r1)
    det = torch.sum(r0 * c0, dim=-1, keepdim=True)
    return (c0 * b[..., 0:1] + c1 * b[..., 1:2] + c2 * b[..., 2:3]) / det


def sim3_log(R, t, s):
    """(R, t, s) -> tangent (..., 7): inverts sim3_exp by solving
    W v = t."""
    w = so3_log(R)
    sigma = torch.log(s)
    v = _solve3x3(_sim3_W(w, sigma), t)
    return torch.cat([w, v, sigma[..., None]], dim=-1)


def sim3_apply(R, t, s, p):
    return s[..., None] * _matvec(R, p) + t


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * _matvec(Rt, t), s_inv


def sim3_compose(R1, t1, s1, R2, t2, s2):
    """S1 * S2 (apply S2 first): (s1 R1)(s2 R2 x + t2) + t1."""
    return R1 @ R2, s1[..., None] * _matvec(R1, t2) + t1, s1 * s2


def sim8_pack(R, t, s):
    return torch.cat([quat_from_mat(R), t, s[..., None]], dim=-1)


def sim8_unpack(p8):
    return (mat_from_quat(quat_normalize(p8[..., :4])), p8[..., 4:7],
            p8[..., 7])
