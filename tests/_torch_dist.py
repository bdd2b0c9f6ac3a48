"""Rank programs of the port's distributed tests (tests/test_torch_dist_*.py).

Each runs in a process of its own, started with `spawn` by
`tools.dryrun_multichip.spawn_ranks`, on the CPU with the gloo backend: it
reads its inputs from an npz file the test wrote, runs the port's sharded
function, and writes what it got to `<out>/rank<r>.npz` for the test to
hold against the single-process results. Imports no JAX."""

import numpy as np
import torch
import torch.distributed as dist

from orb_slam2_e_tpu_torch.parallel import dist_ba, dist_db
from orb_slam2_e_tpu_torch.tools import dryrun_multichip as dry
from orb_slam2_e_tpu_torch.utils import convert

# the solver settings of tests/test_parallel.py
MATCH = dict(n_outer=8, cg_iters=25)
CONVERGE = dict(n_outer=12, cg_iters=40)


def _run(rank, world, rendezvous, body):
    torch.set_num_threads(1)
    dry.init_rank(rank, world, rendezvous, "cpu")
    try:
        body()
    finally:
        dist.destroy_process_group()


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _prefixed(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def rank_ba(rank, world, rendezvous, inputs, out):
    """distributed_ba on the problems of seeds 7 (MATCH) and 8 (CONVERGE),
    then the dryrun."""
    def body():
        a = _load(inputs)
        got = {}
        for tag, kw in (("match", MATCH), ("converge", CONVERGE)):
            cam = convert.camera_from_numpy(_prefixed(a, f"{tag}.cam."),
                                            "cpu")
            prob = convert.ba_problem_from_numpy(
                _prefixed(a, f"{tag}.prob."), "cpu")
            res = dist_ba.distributed_ba(cam, prob, None, **kw)
            got.update({f"{tag}.{k}": v.numpy() for k, v in
                        res._asdict().items()})
        dry.dryrun_multichip(world, "cpu")
        got["dryrun_ok"] = np.asarray(True)
        np.savez(f"{out}/rank{rank}.npz", **got)
    _run(rank, world, rendezvous, body)


def rank_db(rank, world, rendezvous, inputs, out):
    """sharded_query on every case of the inputs: `<case>.vecs`,
    `.filled`, `.q`, `.n` and optionally `.exclude`."""
    def body():
        a = _load(inputs)
        got = {}
        for case in sorted({k.split(".")[0] for k in a}):
            c = _prefixed(a, f"{case}.")
            vecs, filled = dist_db.pad_rows(torch.from_numpy(c["vecs"]),
                                            torch.from_numpy(c["filled"]),
                                            world)
            excl = None
            if "exclude" in c:
                excl = torch.zeros(vecs.shape[0], dtype=torch.bool)
                excl[:len(c["exclude"])] = torch.from_numpy(c["exclude"])
            slots, scores = dist_db.sharded_query(
                None, vecs, filled, torch.from_numpy(c["q"]), int(c["n"]),
                exclude_mask=excl)
            got[f"{case}.slots"] = slots.numpy()
            got[f"{case}.scores"] = scores.numpy()
        np.savez(f"{out}/rank{rank}.npz", **got)
    _run(rank, world, rendezvous, body)


def spawn(target, worlds, inputs, root, timeout_s=120):
    """Run `target` on each number of gloo ranks in `worlds`, all at once;
    a rank that fails or hangs past `timeout_s` fails the run. Returns
    {world: [the ranks' outputs in rank order]}."""
    from concurrent.futures import ThreadPoolExecutor

    def one(world):
        out = root / str(world)
        out.mkdir()
        failed = dry.spawn_ranks(target, world, (str(inputs), str(out)),
                                 timeout_s)
        if failed:
            raise AssertionError(f"{target.__name__} at {world} ranks: "
                                 f"ranks {failed} failed or hung")
        return [_load(out / f"rank{r}.npz") for r in range(world)]

    with ThreadPoolExecutor(len(worlds)) as pool:
        return dict(zip(worlds, pool.map(one, worlds)))
