"""Multi-rank build-and-run check of the distributed modules: the twin of
the reference's `__graft_entry__.dryrun_multichip`.

    python3 -m orb_slam2_e_tpu_torch.tools.dryrun_multichip [--ranks N]
        [--device cuda|cpu]

starts N processes (default: one per visible card, or 2 on the CPU), each
rank on its own card with NCCL, or on the CPU with gloo (`--device cpu`),
joined through a rendezvous file in a temporary directory, and runs
`dryrun_multichip(N)` in each: a tiny distributed BA step
(`parallel.dist_ba.dryrun_training_step`) and the keyframe-sharded BoW query
(`parallel.dist_db.sharded_query`), whose results must be finite and equal
the single-process functions on the same inputs (the BA within 5e-4 poses,
5e-3 points; the query's slots exactly, its scores within 1e-6). Exits 1 if
any rank fails or hangs past the timeout.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 300


def dryrun_multichip(n_devices: int | None = None, device=None) -> None:
    """On the started process group: the distributed BA step over its first
    `n_devices` ranks (all if None) and the sharded query over all of them,
    on the card unless `device` says otherwise. Raises unless every result
    is finite and equals the single-process function's."""
    from ..models import kf_database as KFDB
    from ..ops import ba
    from ..parallel import dist_ba, dist_db
    device = torch.device("cuda" if device is None else device)
    res = dist_ba.dryrun_training_step(n_devices, device=device)
    if not bool(torch.isfinite(res.cam_pose7).all()):
        raise AssertionError("dryrun: distributed BA poses not finite")
    single = ba.ba_solve_pcg(*dist_ba.dryrun_problem(device=device),
                             **dist_ba.DRYRUN_SOLVE)
    dp = float((res.cam_pose7 - single.cam_pose7).abs().max())
    dx = float((res.points - single.points).abs().max())
    if not (dp <= 5e-4 and dx <= 5e-3):
        raise AssertionError(f"dryrun: distributed BA differs from the "
                             f"single solve by {dp} (poses), {dx} (points)")

    world = dist.get_world_size()
    rng = np.random.RandomState(0)
    vecs = rng.rand(8 * world, 64).astype(np.float32)
    vecs /= vecs.sum(1, keepdims=True)
    q = rng.rand(64).astype(np.float32)
    q /= q.sum()
    vecs, q = torch.as_tensor(vecs, device=device), torch.as_tensor(
        q, device=device)
    filled = torch.ones(8 * world, dtype=torch.bool, device=device)
    slots, scores = dist_db.sharded_query(None, vecs, filled, q, 5)
    want_i, want_s = KFDB.detect_relocalization_candidates(
        KFDB.BowDatabase(vecs=vecs, filled=filled), q, 5)
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError("dryrun: sharded query scores not finite")
    if not (torch.equal(slots, want_i)
            and float((scores - want_s).abs().max()) <= 1e-6):
        raise AssertionError(f"dryrun: sharded query {slots.tolist()} "
                             f"differs from the single {want_i.tolist()}")


def init_rank(rank: int, world: int, rendezvous: str, device: str):
    """Start this process's rank: NCCL on card `rank` for "cuda", gloo on
    the loopback interface for "cpu". Returns the rank's device."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank)
    return torch.device("cuda", rank) if device == "cuda" else \
        torch.device("cpu")


def spawn_ranks(target, world: int, args=(),
                timeout_s: float = RANK_TIMEOUT_S) -> list:
    """Run `target(rank, world, rendezvous, *args)` in `world` processes
    started with `spawn` (target must be importable by name), joined
    through a rendezvous file in a new temporary directory. A rank still
    running at the deadline is terminated. Returns the ranks that failed or
    hung."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target,
                             args=(r, world, os.path.join(tmp, "rdv"),
                                   *args)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    return [r for r, p in enumerate(procs) if p.exitcode != 0]


def _rank_main(rank: int, world: int, rendezvous: str, device: str):
    dev = init_rank(rank, world, rendezvous, device)
    try:
        dryrun_multichip(world, dev)
        print(f"rank {rank} of {world} on {dev}: finite, equal to the "
              f"single-process functions", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA device", file=sys.stderr)
        return 1
    world = args.ranks or (torch.cuda.device_count() if args.device == "cuda"
                           else 2)
    failed = spawn_ranks(_rank_main, world, (args.device,))
    print(f"dryrun_multichip: {world} ranks, failed or hung: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
