"""Essential-graph optimization: Levenberg-Marquardt over Sim(3) keyframe
poses.

Port of `orb_slam2_e_tpu/ops/pose_graph.py` (reference
Optimizer::OptimizeEssentialGraph): Sim3 vertices per keyframe, Sim3 edges
over the spanning tree, strong covisibility and loop edges, then SE3
recovery [R, t/s].

The edge Jacobians are forward-mode derivatives of `_sim3_err`, batched
over the edges (`torch.func.vmap(torch.func.jacfwd(...))`), as the
reference's `jax.vmap(jax.jacfwd(...))`. The Hessian blocks and gradients
are summed by `scatter.segment_sum` over plans made once per solve, in one
fixed order on every device (ascending edge order, the four block kinds one
after the other), so a solve repeats bit for bit on the card. Invalid edges
(weight 0, the padding of the edge capacity) add exact zeros and go to the
spare segment instead of keyframe 0's. The dense path solves one (7K x 7K)
system per iteration with `linalg.solve_ex`, which does not wait for the
device.
"""

from __future__ import annotations

import torch

from . import lie, scatter


def _sim3_err(xi_i, xi_j, Si8, Sj8, Mij8):
    """Edge residual: log(Mij^-1 * (exp(xi_i) Si) * (exp(xi_j) Sj)^-1),
    with Mij the measured relative Sim3 Si * Sj^-1.

    A single edge ((7,) and (8,) arguments) is computed as a batch of one:
    under `torch.func.vmap` a Python scalar times a 0-d tensor is promoted
    to float64, so no intermediate may be 0-d."""
    if xi_i.dim() == 1:
        return _sim3_err(xi_i[None], xi_j[None], Si8[None], Sj8[None],
                         Mij8[None])[0]
    Ri, ti, si = lie.sim8_unpack(Si8)
    Rj, tj, sj = lie.sim8_unpack(Sj8)
    Ri, ti, si = lie.sim3_compose(*lie.sim3_exp(xi_i), Ri, ti, si)
    Rj, tj, sj = lie.sim3_compose(*lie.sim3_exp(xi_j), Rj, tj, sj)
    Rr, tr, sr = lie.sim3_compose(Ri, ti, si,
                                  *lie.sim3_inverse(Rj, tj, sj))
    Rm, tm, sm = lie.sim8_unpack(Mij8)
    return lie.sim3_log(*lie.sim3_compose(*lie.sim3_inverse(Rm, tm, sm),
                                          Rr, tr, sr))


def edge_errors(cur8, edges_i, edges_j, meas8):
    """(E, 7) residuals of every edge at the poses `cur8`."""
    zeros = cur8.new_zeros((edges_i.shape[0], 7))
    return _sim3_err(zeros, zeros, cur8[edges_i], cur8[edges_j], meas8)


def edge_jacobians(cur8, edges_i, edges_j, meas8):
    """(Ji, Jj), each (E, 7, 7): derivatives of every edge's residual in
    the left perturbations of its two endpoints, at zero."""
    zeros = cur8.new_zeros((edges_i.shape[0], 7))
    jac = torch.func.vmap(torch.func.jacfwd(_sim3_err, argnums=(0, 1)))
    return jac(zeros, zeros, cur8[edges_i], cur8[edges_j], meas8)


def _retract(cur8, dx):
    R, t, s = lie.sim8_unpack(cur8)
    return lie.sim8_pack(*lie.sim3_compose(*lie.sim3_exp(dx), R, t, s))


def _lm_loop(sim8, edges_i, edges_j, meas8, w, n_iters, solve_step):
    """The LM accept/reject loop both solvers share: `solve_step(r, Ji, Jj,
    lam)` returns the masked step (K, 7). Pure Gauss-Newton is unstable at
    the optimum (the gradient is float32 noise there), hence the damping."""
    cur8 = sim8
    lam = sim8.new_tensor(1e-6)
    costs = []
    for _ in range(n_iters):
        r = edge_errors(cur8, edges_i, edges_j, meas8)
        Ji, Jj = edge_jacobians(cur8, edges_i, edges_j, meas8)
        cand8 = _retract(cur8, solve_step(r, Ji, Jj, lam))
        cost_cur = torch.sum(r * r * w[:, None])
        r_new = edge_errors(cand8, edges_i, edges_j, meas8)
        accept = torch.sum(r_new * r_new * w[:, None]) < cost_cur
        cur8 = torch.where(accept, cand8, cur8)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-6),
                          torch.clamp(lam * 10.0, max=1e4))
        costs.append(cost_cur)
    return cur8, torch.stack(costs)


def optimize_pose_graph(sim8: torch.Tensor, kf_valid: torch.Tensor,
                        fixed: torch.Tensor, edges_i: torch.Tensor,
                        edges_j: torch.Tensor, meas8: torch.Tensor,
                        edge_valid: torch.Tensor, n_iters: int = 20):
    """LM on the Sim3 pose graph with a dense (K, K, 7, 7) Hessian.

    sim8: (K, 8) initial keyframe Sim3 (Scw); fixed: (K,) bool (the loop
    keyframe); edges_*: (E,) endpoints; meas8: (E, 8) relative measurements
    Si * Sj^-1. Returns (optimized (K, 8), costs (n_iters,))."""
    K = sim8.shape[0]
    dt, dev = sim8.dtype, sim8.device
    ei, ej = edges_i.long(), edges_j.long()
    w = edge_valid.to(dt)
    free = (kf_valid & ~fixed).to(dt)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    ar = torch.arange(K, device=dev)
    # the (a, b) blocks of the four kinds as one flat index a * K + b, and
    # the gradient's two ends, each summed in one pass
    live = edge_valid.bool()
    h_idx = torch.where(live.repeat(4), torch.cat(
        [ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]), K * K)
    g_idx = torch.where(live.repeat(2), torch.cat([ei, ej]), K)
    h_plan = scatter.segment_plan(h_idx, K * K)
    g_plan = scatter.segment_plan(g_idx, K)

    def solve_step(r, Ji, Jj, lam):
        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]
        H = scatter.segment_sum(K * K, h_idx, torch.cat([
            torch.einsum('eij,eik->ejk', wJa, Jb)
            for wJa, Jb in ((wJi, Ji), (wJj, Jj), (wJi, Jj), (wJj, Ji))]),
            h_plan).reshape(K, K, 7, 7)
        g = scatter.segment_sum(K, g_idx, torch.cat([
            torch.einsum('eij,ei->ej', wJi, r),
            torch.einsum('eij,ei->ej', wJj, r)]), g_plan)
        Hf = H * free[:, None, None, None] * free[None, :, None, None]
        Hf[ar, ar] += (1.0 - free)[:, None, None] * eye7 + lam * eye7
        gf = g * free[:, None]
        Hd = Hf.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        dx = torch.linalg.solve_ex(Hd, -gf.reshape(-1))[0].reshape(K, 7)
        return dx * free[:, None]

    return _lm_loop(sim8, ei, ej, meas8, w, n_iters, solve_step)


def optimize_pose_graph_cg(sim8: torch.Tensor, kf_valid: torch.Tensor,
                           fixed: torch.Tensor, edges_i: torch.Tensor,
                           edges_j: torch.Tensor, meas8: torch.Tensor,
                           edge_valid: torch.Tensor, n_iters: int = 20,
                           cg_iters: int = 40):
    """Matrix-free variant for large graphs: H x is computed edge by edge
    (two gathers and two scatter-adds) and the damped system is solved by
    block-Jacobi-preconditioned CG with a fixed iteration count."""
    K = sim8.shape[0]
    dt, dev = sim8.dtype, sim8.device
    ei, ej = edges_i.long(), edges_j.long()
    w = edge_valid.to(dt)
    free = (kf_valid & ~fixed).to(dt)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    both = torch.where(edge_valid.bool().repeat(2), torch.cat([ei, ej]), K)
    plan = scatter.segment_plan(both, K)

    def scatter2(vi, vj):
        """Sum of the rows of vi into ei and of vj into ej, in that order."""
        return scatter.segment_sum(K, both, torch.cat([vi, vj]), plan)

    def solve_step(r, Ji, Jj, lam):
        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]
        g = scatter2(torch.einsum('eij,ei->ej', wJi, r),
                     torch.einsum('eij,ei->ej', wJj, r)) * free[:, None]
        Hd = scatter2(torch.einsum('eij,eik->ejk', wJi, Ji),
                      torch.einsum('eij,eik->ejk', wJj, Jj))
        Minv = torch.linalg.inv_ex(
            Hd + (lam + 1e-8) * eye7
            + (1.0 - free)[:, None, None] * eye7)[0]

        def matvec(x):
            xf = x * free[:, None]
            u = (torch.einsum('eij,ej->ei', Ji, xf[ei])
                 + torch.einsum('eij,ej->ei', Jj, xf[ej])) * w[:, None]
            out = scatter2(torch.einsum('eij,ei->ej', Ji, u),
                           torch.einsum('eij,ei->ej', Jj, u))
            return (out * free[:, None] + lam * xf
                    + (1.0 - free)[:, None] * x)

        def prec(x):
            return torch.einsum('kij,kj->ki', Minv, x)

        x = torch.zeros((K, 7), dtype=dt, device=dev)
        rcg = -g - matvec(x)
        z = prec(rcg)
        p = z
        rz = torch.sum(rcg * z)
        for _ in range(cg_iters):
            Ap = matvec(p)
            denom = torch.sum(p * Ap)
            alpha = torch.where(torch.abs(denom) > 1e-18, rz / denom, zero)
            x = x + alpha * p
            rcg = rcg - alpha * Ap
            z = prec(rcg)
            rz2 = torch.sum(rcg * z)
            beta = torch.where(torch.abs(rz) > 1e-18, rz2 / rz, zero)
            p = z + beta * p
            rz = rz2
        return x * free[:, None]

    return _lm_loop(sim8, ei, ej, meas8, w, n_iters, solve_step)


# above this keyframe capacity the dense (K, K, 7, 7) Hessian is replaced
# by the matrix-free CG solver
DENSE_POSE_GRAPH_MAX_K = 256


def sim3_to_se3(sim8: torch.Tensor):
    """SE3 pose [R | t/s] of an optimized Sim3 (reference
    Optimizer.cc:1390-1400)."""
    R, t, s = lie.sim8_unpack(sim8)
    return lie.pose7_pack(R, t / s[..., None])


def build_relative_measurements(sim8_i, sim8_j):
    """Mij = Si * Sj^-1 for edge construction."""
    Ri, ti, si = lie.sim8_unpack(sim8_i)
    Rj, tj, sj = lie.sim8_unpack(sim8_j)
    return lie.sim8_pack(*lie.sim3_compose(Ri, ti, si,
                                           *lie.sim3_inverse(Rj, tj, sj)))
