"""Two-view geometry: the linear triangulation local mapping uses.

Port of `orb_slam2_e_tpu/ops/twoview.py::triangulate_linear` only; the
monocular H/F initializer is not part of the RGB-D path.
"""

from __future__ import annotations

import torch


def triangulate_linear(P1: torch.Tensor, P2: torch.Tensor,
                       uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Batched affine DLT triangulation: (3, 4) projections (leading batch
    dims allowed), (..., N, 2) pixels -> (..., N, 3) world points, solving
    M X = -q through the 3x3 normal equations as the reference does."""
    def rows(P, uv):
        return [uv[..., 0, None] * P[..., None, 2, :] - P[..., None, 0, :],
                uv[..., 1, None] * P[..., None, 2, :] - P[..., None, 1, :]]

    A = torch.stack(rows(P1, uv1) + rows(P2, uv2), dim=-2)   # (..., N, 4, 4)
    M = A[..., :3]
    q = A[..., 3]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    MtM = torch.einsum('...ij,...ik->...jk', M, M) + 1e-9 * eye
    Mtq = torch.einsum('...ij,...i->...j', M, q)
    return -torch.linalg.solve_ex(MtM, Mtq[..., None])[0][..., 0]
