"""Finite-element model of the observed surface for deformable SLAM.

Port of `orb_slam2_e_tpu/ops/fem.py` (the reference's FEA2 engine): a
two-layer solid mesh over the tracked map points, linear-elastic element
stiffness (E = 3500 Pa, nu = 0.495, thickness h = 0.5), and, in every LM
trial of the non-rigid pose optimization, the strain energy of the current
landmark displacements.

- Meshing is host work (numpy), once per relocalization attempt: a 2.5D
  Delaunay triangulation in the image plane (`ops/geometry.py`, the one
  triangulator), prisms (C3D6) from the triangles or hexahedra (C3D8) from
  their tri2quad split, a second layer extruded along the vertex normals,
  all padded to a static capacity.
- Element stiffness is one batch of Gauss-point B^T D B products. The 3x3
  Jacobians are inverted in closed form (determinant and adjugate):
  `torch.linalg.inv` checks its `info` and can wait for the device.
- The global K is never formed: a^T K a and K a are computed per element and
  summed into the nodes by `scatter.segment_sum`, in ascending row order on
  every device (on the card the kernel `csrc/segment_sum.cu`, not atomics),
  so results repeat bit for bit. Padded element rows carry node 0 and add
  exactly 0: they go to the spare segment, not to node 0's.

The material is nearly incompressible (lambda ~1.2e5 against G ~1.2e3), so
a^T K a of a rigid motion is zero only up to float32 cancellation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import geometry, scatter

# Reference material constants (FEA2 ctor, Optimizer.cc:480)
YOUNG_E = 3500.0
POISSON_NU = 0.495
THICKNESS_H = 0.5
W_RE = 1.0          # reprojection weight (levenberg.cpp:189)
W_SE = 5.0          # strain-energy weight (levenberg.cpp:190; 2 on 1st trial)
W_SE_FIRST = 2.0    # defined and unused, here as in the reference


def elasticity_matrix(E: float = YOUNG_E,
                      nu: float = POISSON_NU) -> np.ndarray:
    """6x6 isotropic elasticity D from Lame constants (FEA2.cc:56-73)."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    G = E / (2 * (1 + nu))
    D = np.zeros((6, 6), np.float32)
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] = lam + 2 * G
    D[np.arange(3, 6), np.arange(3, 6)] = G
    return D


class FemMesh(NamedTuple):
    """Static-shape padded mesh.

    Node layout: layer-1 surface nodes [0, n_surf), layer-2 duplicates
    [M // 2, M // 2 + n_surf). Surface node i is either a tracked point
    (interp_parents[i] = [point_idx, -1, -1], w = [1, 0, 0]) or interpolated
    from tracked parents (edge midpoints, barycenters)."""
    u0: torch.Tensor              # (M, 3) reference node positions
    normals: torch.Tensor         # (M // 2, 3) extrusion normals (frozen)
    elements: torch.Tensor        # (Ne, 8) int32 node indices (C3D6 rows pad
                                  #  the last 2 with -1)
    elem_valid: torch.Tensor      # (Ne,) bool
    interp_parents: torch.Tensor  # (M // 2, 3) int32 indices into the tracked
                                  #  point array (-1 = unused)
    interp_weights: torch.Tensor  # (M // 2, 3)
    n_nodes_active: torch.Tensor  # () int32: 2 * n_surf (normalization)
    el_type: int                  # 1 = C3D6, 2 = C3D8
    h: float                      # layer offset


# ---------------------------------------------------------------------------
# Host-side mesh construction
# ---------------------------------------------------------------------------

def build_mesh(points: np.ndarray, uv: np.ndarray, el_type: int = 1,
               h: float = THICKNESS_H, max_nodes: int = 2048,
               max_elems: int = 2048, *, device) -> "FemMesh | None":
    """Triangulate tracked points (host, once per relocalization attempt)
    and put the padded mesh on `device`.

    points: (N, 3) world positions of tracked landmarks. uv: (N, 2) their
    image projections (the triangulation's domain). el_type 1: prisms from
    triangles (C3D6); 2: hexahedra from the tri2quad split (C3D8).
    None below 8 points, when only slivers remain, or over capacity."""
    N = len(points)
    if N < 8:
        return None
    simplices = geometry.delaunay(np.asarray(uv, np.float32))    # (T, 3)
    if len(simplices) == 0:
        return None
    # drop slivers (degenerate image-plane triangles, e.g. collinear
    # boundary points): anything below half a pixel^2 produces a singular
    # element Jacobian
    p = uv[simplices]
    area2 = np.abs((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
                   - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    simplices = simplices[area2 > 1.0]
    # also require non-degenerate 3D geometry (collinear world points give
    # a zero-volume prism whatever their projection)
    q = points[simplices].astype(np.float64)
    cr = np.cross(q[:, 1] - q[:, 0], q[:, 2] - q[:, 0])
    a3d = np.linalg.norm(cr, axis=1)
    scale2 = np.maximum(
        np.einsum('tij,tij->t', q - q[:, :1], q - q[:, :1]), 1e-12)
    simplices = simplices[a3d > 1e-6 * scale2]
    if len(simplices) == 0:
        return None

    # vertex normals from triangle normals (for the layer-2 extrusion)
    v_norm = np.zeros((N, 3), np.float64)
    a = points[simplices[:, 1]] - points[simplices[:, 0]]
    b = points[simplices[:, 2]] - points[simplices[:, 0]]
    fn = np.cross(a, b)
    for k in range(3):
        np.add.at(v_norm, simplices[:, k], fn)
    nrm = np.linalg.norm(v_norm, axis=1, keepdims=True)
    v_norm = v_norm / np.maximum(nrm, 1e-12)

    half = max_nodes // 2   # layer-2 nodes live at [half, half + n_surf)
    if el_type == 1:
        # C3D6: surface nodes = tracked points; prisms = extruded triangles
        surf_pos = points.astype(np.float64)
        parents = np.full((N, 3), -1, np.int64)
        parents[:, 0] = np.arange(N)
        weights = np.zeros((N, 3))
        weights[:, 0] = 1.0
        normals = v_norm
        n_surf = N
        elems = np.concatenate([
            simplices, simplices + half,
            np.full((len(simplices), 2), -1)], axis=1)   # (T, 8): 6 used
    else:
        # C3D8 via tri2quad: nodes = vertices + edge midpoints + barycenters
        edges = {}

        def edge_id(i, j):
            key = (min(i, j), max(i, j))
            if key not in edges:
                edges[key] = len(edges)
            return edges[key]

        tri_mid = np.zeros((len(simplices), 3), np.int64)
        for t, (i, j, k) in enumerate(simplices):
            tri_mid[t] = [edge_id(i, j), edge_id(j, k), edge_id(k, i)]
        n_edges = len(edges)
        n_surf = N + n_edges + len(simplices)
        surf_pos = np.zeros((n_surf, 3))
        parents = np.full((n_surf, 3), -1, np.int64)
        weights = np.zeros((n_surf, 3))
        surf_pos[:N] = points
        parents[:N, 0] = np.arange(N)
        weights[:N, 0] = 1.0
        for (i, j), e in edges.items():
            surf_pos[N + e] = 0.5 * (points[i] + points[j])
            parents[N + e, :2] = [i, j]
            weights[N + e, :2] = 0.5
        for t, (i, j, k) in enumerate(simplices):
            surf_pos[N + n_edges + t] = (points[i] + points[j] + points[k]) / 3
            parents[N + n_edges + t] = [i, j, k]
            weights[N + n_edges + t] = 1.0 / 3.0
        # vertex normals extended to midpoints/barycenters by parent average
        normals = np.zeros((n_surf, 3))
        normals[:N] = v_norm
        for (i, j), e in edges.items():
            normals[N + e] = v_norm[i] + v_norm[j]
        for t, (i, j, k) in enumerate(simplices):
            normals[N + n_edges + t] = v_norm[i] + v_norm[j] + v_norm[k]
        normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                              1e-12)
        # 3 quads per triangle: (v, m_ij, bary, m_ki) etc.
        quads = []
        for t, (i, j, k) in enumerate(simplices):
            mij, mjk, mki = (N + tri_mid[t, 0], N + tri_mid[t, 1],
                             N + tri_mid[t, 2])
            bc = N + n_edges + t
            quads += [(i, mij, bc, mki), (j, mjk, bc, mij), (k, mki, bc, mjk)]
        quads = np.asarray(quads, np.int64)
        elems = np.concatenate([quads, quads + half], axis=1)  # (3T, 8)

    if n_surf > half or len(elems) > max_elems:
        return None
    # layer-2 nodes: extruded along -normal, which keeps element volumes
    # positive for any surface orientation
    pos2 = surf_pos - h * normals

    # pad to static shapes: layer-1 at [0, half), layer-2 at [half, M)
    u0_p = np.zeros((max_nodes, 3), np.float32)
    u0_p[:n_surf] = surf_pos
    u0_p[half:half + n_surf] = pos2
    el_p = np.zeros((max_elems, 8), np.int64)
    ev = np.zeros(max_elems, bool)
    el_p[:len(elems)] = np.where(elems >= 0, elems, 0)
    if el_type == 1:
        el_p[:, 6:] = -1             # prism rows keep the -1 marker
    ev[:len(elems)] = True
    par_p = np.full((half, 3), -1, np.int64)
    par_p[:n_surf] = parents
    w_p = np.zeros((half, 3), np.float32)
    w_p[:n_surf] = weights
    nrm_p = np.zeros((half, 3), np.float32)
    nrm_p[:n_surf] = normals

    def put(a, dtype=None):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    return FemMesh(
        u0=put(u0_p), normals=put(nrm_p), elements=put(el_p, np.int32),
        elem_valid=put(ev), interp_parents=put(par_p, np.int32),
        interp_weights=put(w_p), n_nodes_active=put(2 * n_surf, np.int32),
        el_type=el_type, h=h)


# ---------------------------------------------------------------------------
# Element stiffness (batched Gauss quadrature)
# ---------------------------------------------------------------------------

_G = 1.0 / np.sqrt(3.0)   # reference fg = 0.57735 (Optimizer.cc:480)

# C3D8 natural coordinates of the 8 nodes
_HEX_XI = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                    [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64)
_HEX_GP = np.array([[sx * _G, sy * _G, sz * _G]
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])

# C3D6 (wedge): area coords (L1, L2, L3) x zeta; 3x2 Gauss points
_WEDGE_TRI_GP = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
_WEDGE_W = 1.0 / 6.0


def _hex_shape_grad(xi):
    """d N_i / d (xi, eta, zeta) for C3D8 at natural coords xi (3,) -> (8, 3)."""
    g = np.zeros((8, 3))
    for i in range(8):
        sx, sy, sz = _HEX_XI[i]
        g[i, 0] = 0.125 * sx * (1 + sy * xi[1]) * (1 + sz * xi[2])
        g[i, 1] = 0.125 * sy * (1 + sx * xi[0]) * (1 + sz * xi[2])
        g[i, 2] = 0.125 * sz * (1 + sx * xi[0]) * (1 + sy * xi[1])
    return g


def _wedge_shape_grad(r, s, z):
    """dN/d(r, s, z) for the 6-node wedge: N_i = L_i (1 -+ z)/2,
    L = (1-r-s, r, s)."""
    g = np.zeros((6, 3))
    dL = np.array([[-1, -1], [1, 0], [0, 1]], np.float64)   # dL_i/d(r, s)
    L = np.array([1 - r - s, r, s])
    for layer, zsgn in enumerate((-1, 1)):
        fz = (1 + zsgn * z) / 2
        for i in range(3):
            g[layer * 3 + i, 0] = dL[i, 0] * fz
            g[layer * 3 + i, 1] = dL[i, 1] * fz
            g[layer * 3 + i, 2] = L[i] * zsgn / 2
    return g


# shape gradients at all Gauss points, float32 as the reference's jnp arrays
_HEX_GRADS = np.stack([_hex_shape_grad(gp) for gp in _HEX_GP]).astype(
    np.float32)                                                   # (8, 8, 3)
_WEDGE_GRADS = np.stack([_wedge_shape_grad(r, s, z * _G)
                         for (r, s) in _WEDGE_TRI_GP
                         for z in (-1, 1)]).astype(np.float32)    # (6, 6, 3)
_WEDGE_GPW = np.full(6, _WEDGE_W, np.float32)

# strain rows from shape-function gradients: B[r, 3 n + j] = sum_c
# _STRAIN[r, j, c] * dN_n/dx_c (Voigt order xx, yy, zz, xy, yz, xz)
_STRAIN = np.zeros((6, 3, 3), np.float32)
for _r, _j, _c in ((0, 0, 0), (1, 1, 1), (2, 2, 2), (3, 0, 1), (3, 1, 0),
                   (4, 1, 2), (4, 2, 1), (5, 0, 2), (5, 2, 0)):
    _STRAIN[_r, _j, _c] = 1.0


def _det_adj3x3(J):
    """Closed-form determinant (...) and adjugate (..., 3, 3) of 3x3 blocks
    (inverse = adjugate / determinant)."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1)], -2)
    return det, adj


def _ke_from_grads(coords, grads, gp_w, D):
    """Ke of every element: coords (Ne, n, 3), grads (G, n, 3), gp_w (G,),
    D (6, 6) -> (Ne, 3n, 3n)."""
    Ne, n = coords.shape[:2]
    J = torch.einsum('gna,enb->egab', grads, coords)        # (Ne, G, 3, 3)
    det, adj = _det_adj3x3(J)
    # singular J (degenerate or padded element): contribute 0, never NaN
    ok = torch.abs(det) > 1e-12
    eye = torch.eye(3, dtype=J.dtype, device=J.device)
    inv = torch.where(ok[..., None, None],
                      adj / torch.where(ok, det, 1.0)[..., None, None], eye)
    det = torch.where(ok, det, 0.0)
    dNdx = torch.einsum('gna,egca->egnc', grads, inv)       # (Ne, G, n, 3)
    strain = torch.as_tensor(_STRAIN, device=J.device)
    B = torch.einsum('rjc,egnc->egrnj', strain, dNdx).reshape(
        Ne, -1, 6, 3 * n)
    Kes = (B.transpose(-1, -2) @ D) @ B                     # (Ne, G, 3n, 3n)
    return (Kes * (torch.abs(det) * gp_w)[..., None, None]).sum(1)


def element_stiffness_batch(mesh: FemMesh, D=None) -> torch.Tensor:
    """Ke for every element, padded to (Ne, 24, 24) (C3D6 blocks occupy the
    top-left 18x18). Reference ComputeKeiC3D8/C3D6 (FEA2.cc:1244-1376)."""
    dev = mesh.u0.device
    if D is None:
        D = torch.from_numpy(elasticity_matrix()).to(dev)
    coords_all = mesh.u0[torch.clamp(mesh.elements, min=0).long()]
    if mesh.el_type == 2:
        return _ke_from_grads(coords_all,
                              torch.as_tensor(_HEX_GRADS, device=dev),
                              torch.ones((8,), device=dev), D)
    ke18 = _ke_from_grads(coords_all[:, :6],
                          torch.as_tensor(_WEDGE_GRADS, device=dev),
                          torch.as_tensor(_WEDGE_GPW, device=dev), D)
    return torch.nn.functional.pad(ke18, (0, 6, 0, 6))


# ---------------------------------------------------------------------------
# Runtime: node positions, strain energy, forces
# ---------------------------------------------------------------------------

def node_positions(mesh: FemMesh, tracked_pts: torch.Tensor) -> torch.Tensor:
    """Rebuild all node positions from current tracked point positions
    (reference Set_uf, FEA2.cc:1732-1796): surface nodes interpolate their
    parents; layer-2 = layer-1 - h * normal (normals frozen at build)."""
    par = mesh.interp_parents
    pp = tracked_pts[torch.clamp(par, min=0).long()]         # (Ms, 3, 3)
    wv = torch.where(par >= 0, mesh.interp_weights, 0.0)
    surf = torch.sum(pp * wv[:, :, None], dim=1)
    return torch.cat([surf, surf - mesh.h * mesh.normals])


def _element_vectors(mesh: FemMesh, x: torch.Tensor):
    """Per-element copies of a nodal field: (mask (Ne, 24) of the slots
    that hold a node, xe (Ne, 24))."""
    idx = torch.clamp(mesh.elements, min=0).long()
    mask = torch.repeat_interleave(mesh.elements >= 0, 3, dim=1)
    return mask, torch.where(mask, x[idx].reshape(-1, 24), 0.0)


def _node_index(mesh: FemMesh) -> torch.Tensor:
    """(Ne * 8,) node of each element slot; the spare segment M where the
    slot holds no node or the element is padding (its values are 0)."""
    live = (mesh.elements >= 0) & mesh.elem_valid[:, None]
    return torch.where(live, mesh.elements.long(),
                       mesh.u0.shape[0]).reshape(-1)


def assembly_plan(mesh: FemMesh) -> scatter.SegmentPlan:
    """The plan of the node sums of `mesh`, for a solve that assembles many
    times over one mesh."""
    return scatter.segment_plan(_node_index(mesh), mesh.u0.shape[0])


def _assemble(mesh: FemMesh, vals, plan=None):
    """Sum per-element nodal values (Ne, 24), 0 in the slots of no node and
    of padded elements, into the nodes (M, 3)."""
    return scatter.segment_sum(mesh.u0.shape[0], _node_index(mesh),
                               vals.reshape(-1, 3), plan)


def strain_energy(mesh: FemMesh, ke_all: torch.Tensor,
                  node_pos: torch.Tensor) -> torch.Tensor:
    """sE = |a^T K a| via per-element quadratic forms, returned normalized:
    nsE = sE / n_nodes (reference ComputeStrainEnergy +
    NormalizeStrainEnergy, FEA2.cc:1877-1902)."""
    _, ae = _element_vectors(mesh, node_pos - mesh.u0)
    e = torch.einsum('ei,eij,ej->e', ae, ke_all, ae)
    sE = torch.abs(torch.sum(torch.where(mesh.elem_valid, e, 0.0)))
    return sE / torch.clamp(mesh.n_nodes_active.to(sE.dtype), min=1.0)


def stiffness_matvec(mesh: FemMesh, ke_all: torch.Tensor,
                     x: torch.Tensor, plan=None) -> torch.Tensor:
    """Matrix-free K @ x: per-element gather -> Ke -> scatter-add. The
    reference's FEA2 assembles a dense K and inverts it for its mode-2
    displacement propagation; the operator form is O(Ne * 24^2). `plan`:
    `assembly_plan(mesh)` (made here when None)."""
    mask, xe = _element_vectors(mesh, x)
    fe = torch.einsum('eij,ej->ei', ke_all, xe)
    fe = torch.where(mask & mesh.elem_valid[:, None], fe, 0.0)
    return _assemble(mesh, fe, plan)


def nodal_forces(mesh: FemMesh, ke_all: torch.Tensor,
                 node_pos: torch.Tensor) -> torch.Tensor:
    """f = K a assembled per element (reference ComputeForces,
    FEA2.cc:1811)."""
    return stiffness_matvec(mesh, ke_all, node_pos - mesh.u0)


def stiffness_diag(mesh: FemMesh, ke_all: torch.Tensor,
                   plan=None) -> torch.Tensor:
    """diag(K) (M, 3) assembled from element diagonals (the Jacobi
    preconditioner)."""
    mask = torch.repeat_interleave(mesh.elements >= 0, 3, dim=1)
    dke = torch.diagonal(ke_all, dim1=1, dim2=2)             # (Ne, 24)
    dke = torch.where(mask & mesh.elem_valid[:, None], dke, 0.0)
    return _assemble(mesh, dke, plan)


def solve_displacement(mesh: FemMesh, ke_all: torch.Tensor, f: torch.Tensor,
                       fixed_mask: torch.Tensor, iters: int = 64):
    """Solve K a = f for the free nodes with a fixed number of
    Jacobi-preconditioned CG steps; Dirichlet nodes (fixed_mask True) are
    pinned to zero displacement (reference ImposeDirichletEncastre,
    FEA2.cc:1628-1645). Replaces the reference's a2 = K^-1 f with a dense
    inverse (ComputeNewDisplacement, FEA2.cc:1914-1917). Nothing in the
    loop is read by the host. Returns a (M, 3)."""
    free = ~fixed_mask[:, None]                              # (M, 1)
    plan = assembly_plan(mesh)
    dK = torch.clamp(stiffness_diag(mesh, ke_all, plan), min=1e-8)

    def A(x):
        return torch.where(free, stiffness_matvec(mesh, ke_all, x, plan), x)

    b = torch.where(free, f, 0.0)
    x = torch.zeros_like(b)
    r = b - A(x)
    z = torch.where(free, r / dK, 0.0)
    p = z
    for _ in range(iters):
        Ap = A(p)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.where(free, r / dK, 0.0)
        beta = torch.sum(r * z) / torch.clamp(rz, min=1e-20)
        p = z + beta * p
    return torch.where(free, x, 0.0)
