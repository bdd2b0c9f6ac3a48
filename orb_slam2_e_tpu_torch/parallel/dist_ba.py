"""Distributed bundle adjustment over a `torch.distributed` process group.

Port of `orb_slam2_e_tpu/parallel/dist_ba.py`. Observations are sharded
across the ranks; each rank reduces its landmark and camera partial blocks
locally, and an all-reduce combines them: the Schur-complement reduction of
the reference's `shard_map` + `psum`.

  - per rank: residuals and Jacobians of its observation shard, partial Hpp
    (P, 3, 3), Hcc (C, 6, 6), gradients, and the two halves of the
    matrix-free Schur product S.x;
  - all-reduce (sum) over the group: the exact global normal equations;
  - every rank then runs the identical PCG + LM update (replicated state).

Observations reference landmarks and cameras by index and the scatters are
additive, so sharding the observation axis gives the single-rank solve up
to the order of the sums (the tests hold it to 5e-4 poses, 5e-3 points).

The caller starts the process group (`torch.distributed.init_process_group`
with its own address, world size and rank: NCCL with one card per rank, or
gloo on the CPU) before calling anything here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import ba
from ..ops.camera import Camera


def make_mesh(n_devices: int | None = None):
    """The process group the sharded functions run over: the default group
    (every rank of the started job), or a new group of its first
    `n_devices` ranks (every rank of the job must make the call)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "init_process_group first")
    if n_devices is None or n_devices == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(list(range(n_devices)))


def pad_problem(prob: ba.BAProblem, n_shards: int) -> ba.BAProblem:
    """Pad the observation axis to a multiple of the shard count."""
    O = prob.obs_cam.shape[0]
    pad = -(-O // n_shards) * n_shards - O
    if pad == 0:
        return prob

    def padded(x, fill=0):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    return prob._replace(
        obs_cam=padded(prob.obs_cam),
        obs_point=padded(prob.obs_point),
        obs_uvr=padded(prob.obs_uvr),
        obs_inv_sigma2=padded(prob.obs_inv_sigma2),
        obs_valid=padded(prob.obs_valid, False),
    )


_OBS_FIELDS = ("obs_cam", "obs_point", "obs_uvr", "obs_inv_sigma2",
               "obs_valid")


def distributed_ba(cam: Camera, prob: ba.BAProblem, group=None,
                   n_outer: int = 10, cg_iters: int = 30) -> ba.BAResult:
    """Run `ba_solve_pcg` with the observations sharded over `group` (the
    default group if None).

    Every rank passes the same full problem. Camera poses and landmark
    positions stay replicated; each rank solves with its contiguous
    O_pad / world_size slice of the observation arrays, and every partial
    sum goes through an all-reduce. Returns the replicated result, with
    `obs_inlier` gathered back to the full padded length."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    prob = pad_problem(prob, world)
    n = prob.obs_cam.shape[0] // world
    local = prob._replace(**{k: getattr(prob, k)[rank * n:(rank + 1) * n]
                             for k in _OBS_FIELDS})

    def psum(v):
        out = v.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    res = ba.ba_solve_pcg(cam, local, n_outer=n_outer, cg_iters=cg_iters,
                          psum=psum)
    shards = [torch.empty((n,), dtype=torch.uint8, device=prob.obs_cam.device)
              for _ in range(world)]
    dist.all_gather(shards, res.obs_inlier.to(torch.uint8), group=group)
    return res._replace(obs_inlier=torch.cat(shards).to(torch.bool))


def dryrun_problem(n_cams: int = 8, n_pts: int = 64, n_obs: int = 256,
                   device=None):
    """The tiny BA problem of `dryrun_training_step`, drawn with the
    reference's numpy seed: (cam, prob) on `device` (the card if None)."""
    device = torch.device("cuda" if device is None else device)
    rng = np.random.RandomState(0)
    cam = Camera.create(fx=300.0, fy=300.0, cx=128.0, cy=96.0, device=device)
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], (n_pts, 3)).astype(np.float32)
    pose7 = np.tile(np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32),
                    (n_cams, 1))
    pose7[:, 4] = np.linspace(0, 0.5, n_cams)
    obs_cam = rng.randint(0, n_cams, n_obs)
    obs_point = rng.randint(0, n_pts, n_obs)
    xc = pts[obs_point] + pose7[obs_cam][:, 4:7]
    uv = np.stack([300 * xc[:, 0] / xc[:, 2] + 128,
                   300 * xc[:, 1] / xc[:, 2] + 96,
                   np.full(n_obs, -1.0)], 1).astype(np.float32)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    prob = ba.BAProblem(
        cam_pose7=t(pose7), cam_free=t(np.arange(n_cams) > 0),
        points=t(pts), point_valid=torch.ones(n_pts, dtype=torch.bool,
                                              device=device),
        obs_cam=t(obs_cam, torch.int32), obs_point=t(obs_point, torch.int32),
        obs_uvr=t(uv), obs_inv_sigma2=torch.ones(n_obs, device=device),
        obs_valid=torch.ones(n_obs, dtype=torch.bool, device=device))
    return cam, prob


DRYRUN_SOLVE = dict(n_outer=2, cg_iters=5)


def dryrun_training_step(n_devices: int | None = None, n_cams: int = 8,
                         n_pts: int = 64, n_obs: int = 256, device=None):
    """A tiny distributed BA step over the first `n_devices` ranks of the
    started group (all of them if None): the multi-rank build-and-run check
    (`tools/dryrun_multichip.py`). Runs on the card unless `device` says
    otherwise. Returns the BAResult, synchronized."""
    cam, prob = dryrun_problem(n_cams, n_pts, n_obs, device)
    res = distributed_ba(cam, prob, make_mesh(n_devices), **DRYRUN_SOLVE)
    if prob.points.device.type == "cuda":
        torch.cuda.synchronize(prob.points.device)
    return res
