"""The port's fixed-order scatter helpers against the reference (CPU).

`scatter.segment_sum` is the port's one float scatter-add (the BA, the pose
graph, the FEM assembly). Its plain path is `index_add_`, which the CPU
runs row by row in ascending order; on the card it launches
`csrc/segment_sum.cu`, whose loop adds each segment's rows in the same
order from the plan `segment_plan` builds. Here, on the same seeded numpy
inputs at the main path's shapes:
- the plain path against the reference's `jax.ops.segment_sum` and
  `.at[].add`;
- a numpy float32 emulation of the kernel's loop, on the plan built on the
  CPU, bit for bit against `index_add_` (the kernel's algorithm; the kernel
  itself is held to its plain version on the card by the `cuda` tests
  below and by `chip_smoke.py`);
- `scatter.masked_set_last` against the reference's `masked_set` where
  live indices repeat (the fusion tables).
The module imports JAX only inside the CPU tests, so that `python -m pytest
tests/test_torch_scatter.py -m cuda` runs on a machine without it.
"""

import numpy as np
import pytest
import torch

from _torch_port import cuda_device, tnp
from orb_slam2_e_tpu_torch.ops import ba as tba
from orb_slam2_e_tpu_torch.ops import pose_graph as tpg
from orb_slam2_e_tpu_torch.ops import scatter

# Two orders of summing n float32 terms differ by at most 2 (n - 1) u sum|v|
# (u = 2^-24), the tolerance of the plain path against the reference. Both
# add in ascending row order on the CPU: the distance measured on every case
# below is 0 (AMD EPYC, jax 0.9.0, torch 2.13.0+cpu).
U32 = 2.0 ** -24

# (name, rows, segments, columns, index sorted, share of rows masked,
# segments the index draws from): the main path's sums
CASES = [
    ("local BA Hpp|bp, point-sorted", 12288, 4096, 12, True, 0.0, 4096),
    ("local BA Schur buffer, (point, camera)-sorted", 12288, 4096 * 32, 18,
     True, 0.0, 4096 * 32),
    ("global BA Hcc per camera", 131072, 64, 36, False, 0.0, 40),
    ("global BA point products", 131072, 24576, 3, False, 0.0, 24576),
    ("pose graph blocks a*K+b", 4 * 300, 64 * 64, 49, False, 0.0, 64 * 64),
    ("FEM assembly", 4096 * 8, 4096, 3, False, 0.0, 2048),
    ("duplicate-heavy", 5000, 3, 6, False, 0.0, 3),
    ("empty and masked segments", 2000, 500, 5, False, 0.3, 120),
]
IDS = [c[0] for c in CASES]


def _inputs(case, seed=0):
    """(idx (N,) int64 in [0, n], vals (N, D) float32) of a case: values of
    magnitudes 1e-3..1e3, so that the order of the adds shows in the bits;
    masked rows carry idx == n."""
    _, rows, n, cols, is_sorted, masked, drawn = case
    rng = np.random.RandomState(seed)
    live = rng.choice(n, size=drawn, replace=False) if drawn < n else None
    idx = rng.randint(0, drawn, rows)
    if live is not None:
        idx = live[idx]
    idx = np.where(rng.rand(rows) < masked, n, idx).astype(np.int64)
    if is_sorted:
        idx = np.sort(idx)
    vals = (rng.standard_normal((rows, cols))
            * 10.0 ** rng.uniform(-3, 3, (rows, 1))).astype(np.float32)
    return idx, vals


def _emulate_kernel(n, plan, vals):
    """csrc/segment_sum.cu's loop in numpy float32: segment s adds the rows
    perm[offsets[s]:offsets[s + 1]] one by one from 0.0. The segments are
    walked in lockstep (the j-th row of every segment at once), which keeps
    each segment's own order."""
    perm = tnp(plan.perm)
    off = tnp(plan.offsets)
    acc = np.zeros((n, vals.shape[1]), np.float32)
    length = off[1:] - off[:-1]
    for j in range(int(length.max(initial=0))):
        seg = np.nonzero(length > j)[0]
        acc[seg] = acc[seg] + vals[perm[off[seg] + j]]
    return acc


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_reference_segment_sum(case):
    import jax
    import jax.numpy as jnp
    idx, vals = _inputs(case)
    n, is_sorted = case[2], case[4]
    got = tnp(scatter.segment_sum(n, torch.from_numpy(idx),
                                  torch.from_numpy(vals)))
    want_seg = np.asarray(jax.ops.segment_sum(
        jnp.asarray(vals), jnp.asarray(idx), num_segments=n + 1,
        indices_are_sorted=is_sorted))[:n]
    want_at = np.asarray(jnp.zeros((n, vals.shape[1])).at[idx].add(
        vals, mode="drop"))
    live = idx < n
    terms = np.bincount(idx[live], minlength=n)[:, None]
    abs_sum = np.zeros((n, vals.shape[1]), np.float64)
    np.add.at(abs_sum, idx[live], np.abs(vals[live]).astype(np.float64))
    bound = 2 * np.maximum(terms - 1, 0) * U32 * abs_sum
    for want in (want_seg, want_at):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_loop_on_the_plan_equals_index_add(case):
    idx, vals = _inputs(case)
    n = case[2]
    want = tnp(torch.zeros((n + 1, vals.shape[1])).index_add_(
        0, torch.from_numpy(idx), torch.from_numpy(vals))[:n])
    plan = scatter.segment_plan(torch.from_numpy(idx), n)
    off = tnp(plan.offsets)
    assert off.shape == (n + 1,) and off[0] == 0
    assert off[-1] == int((idx < n).sum())
    got = _emulate_kernel(n, plan, vals)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_cpu_wrapper_takes_plain_path_with_or_without_plan():
    idx, vals = _inputs(CASES[-1])
    n = CASES[-1][2]
    ti, tv = torch.from_numpy(idx), torch.from_numpy(vals).reshape(-1, 5, 1)
    before = scatter.segment_sum.launches
    a = scatter.segment_sum(n, ti, tv)
    b = scatter.segment_sum(n, ti, tv, scatter.segment_plan(ti, n))
    assert scatter.segment_sum.launches == before
    assert a.shape == (n, 5, 1)
    want = scatter.segment_sum_plain(n, ti, tv)
    assert torch.equal(a, want) and torch.equal(b, want)


def test_pose_graph_blocks_sum_as_four_index_puts():
    """The dense pose graph's flat (a * K + b) segment sum of the four block
    kinds adds in the order of the four `index_put_(accumulate=True)` calls
    it replaced: the CPU's Hessian is unchanged bit for bit."""
    rng = np.random.RandomState(1)
    K, E = 32, 200
    ei = torch.from_numpy(rng.randint(0, K, E))
    ej = torch.from_numpy(rng.randint(0, K, E))
    blocks = [torch.from_numpy((rng.standard_normal((E, 7, 7)) * 10.0 **
                                rng.uniform(-3, 3, (E, 1, 1))).astype(
                                    np.float32)) for _ in range(4)]
    pairs = ((ei, ei), (ej, ej), (ei, ej), (ej, ei))
    want = torch.zeros((K, K, 7, 7))
    for (a, b), v in zip(pairs, blocks):
        want.index_put_((a, b), v, accumulate=True)
    flat = torch.cat([a * K + b for a, b in pairs])
    got = scatter.segment_sum(K * K, flat, torch.cat(blocks)).reshape(
        K, K, 7, 7)
    assert torch.equal(got, want)


def _masked_set_cases():
    rng = np.random.RandomState(2)
    P, N = 1000, 600
    # the fusion table: landmark ids, losers drawn from few ids so that
    # live rows repeat an index, winners the values
    loser = rng.randint(0, 40, N).astype(np.int32)
    ok = rng.rand(N) < 0.7
    winner = rng.randint(0, P, N).astype(np.int32)
    yield "fusion table", np.arange(P, dtype=np.int32), loser, ok, winner
    arr = rng.standard_normal((50, 3)).astype(np.float32)
    yield ("rows of floats", arr, rng.randint(0, 50, N).astype(np.int32),
           rng.rand(N) < 0.5, rng.standard_normal((N, 3)).astype(np.float32))
    yield ("one value broadcast", arr, rng.randint(0, 50, N).astype(np.int32),
           rng.rand(N) < 0.5, np.float32(7.0))
    yield ("three writes to one slot", np.zeros(4, np.int32),
           np.array([2, 2, 2, 1], np.int32), np.array([True, True, False,
                                                        True]),
           np.array([10, 20, 30, 40], np.int32))


@pytest.mark.parametrize("name,arr,idx,ok,val", list(_masked_set_cases()),
                         ids=[c[0] for c in _masked_set_cases()])
def test_masked_set_last_follows_reference_masked_set(name, arr, idx, ok,
                                                      val):
    import jax.numpy as jnp
    from orb_slam2_e_tpu.ops import scatter as jscatter
    want = np.asarray(jscatter.masked_set(jnp.asarray(arr), jnp.asarray(idx),
                                          jnp.asarray(ok), jnp.asarray(val)))
    got = tnp(scatter.masked_set_last(
        torch.from_numpy(np.array(arr)), torch.from_numpy(idx),
        torch.from_numpy(ok), torch.from_numpy(np.array(val))))
    np.testing.assert_array_equal(got, want)
    # the rule: the last live row of an index wins
    last = np.array(arr, copy=True)
    v = np.broadcast_to(val, (idx.shape[0],) + last.shape[1:])
    for i in range(idx.shape[0]):
        if ok[i]:
            last[idx[i]] = v[i]
    np.testing.assert_array_equal(got, last)


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version (skip without one)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cuda_segment_sum_equals_plain_bit_for_bit(case):
    dev = cuda_device()
    idx, vals = _inputs(case)
    n = case[2]
    ti, tv = torch.from_numpy(idx), torch.from_numpy(vals)
    want = scatter.segment_sum_plain(n, ti, tv)
    plan = scatter.segment_plan(ti.to(dev), n)
    before = scatter.segment_sum.launches
    got = scatter.segment_sum(n, ti.to(dev), tv.to(dev), plan)
    torch.cuda.synchronize()
    assert scatter.segment_sum.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_segment_sum_rejects_what_the_kernel_does_not_take():
    dev = cuda_device()
    idx = torch.zeros(4, dtype=torch.long, device=dev)
    with pytest.raises(ValueError):
        scatter.segment_sum(2, idx, torch.ones(4, 3, dtype=torch.float64,
                                               device=dev))
    with pytest.raises(ValueError):
        scatter.segment_sum(2, idx, torch.ones(4, 65, device=dev))
    with pytest.raises(ValueError):
        scatter.segment_sum(2, idx[:3], torch.ones(4, 3, device=dev))


@pytest.mark.cuda
def test_cuda_solvers_repeat_bit_for_bit():
    """The PCG bundle adjustment and both pose-graph solvers, twice from one
    input in the card's default (non-deterministic) mode."""
    dev = cuda_device()
    from orb_slam2_e_tpu_torch.parallel import dist_ba
    cam, prob = dist_ba.dryrun_problem(8, 64, 256, dev)
    runs = [tba.ba_solve_pcg(cam, prob, n_outer=3, cg_iters=10)
            for _ in range(2)]
    assert torch.equal(runs[0].points, runs[1].points)
    assert torch.equal(runs[0].cam_pose7, runs[1].cam_pose7)
    rng = np.random.RandomState(3)
    K, E = 12, 30
    sim8 = np.tile(np.array([1, 0, 0, 0, 0, 0, 0, 1], np.float32), (K, 1))
    sim8[:, 4:7] = rng.standard_normal((K, 3)) * 0.3
    sim8 = torch.from_numpy(sim8).to(dev)
    ei = torch.from_numpy(rng.randint(0, K, E)).to(dev)
    ej = torch.from_numpy(rng.randint(0, K, E)).to(dev)
    meas = tpg.build_relative_measurements(sim8[ei], sim8[ej])
    meas[:, 4:7] += 0.01
    valid = torch.ones(K, dtype=torch.bool, device=dev)
    fixed = torch.arange(K, device=dev) == 0
    for solver in (tpg.optimize_pose_graph, tpg.optimize_pose_graph_cg):
        a, b = (solver(sim8, valid, fixed, ei, ej, meas, valid[:1].expand(E),
                       n_iters=5) for _ in range(2))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
