"""Masked, order-free and fixed-order scatter helpers.

The reference routes masked rows of a scatter to an out-of-range index and
drops them with `mode='drop'` (orb_slam2_e_tpu/ops/scatter.py). torch has no
drop mode: an out-of-range index raises on the CPU and fires a device assert
on the GPU. So the mask is applied explicitly: masked rows write into one
spare row appended past the end, which is cut off again. That keeps the
index tensor's shape static (no host sync for a boolean mask).

Float sums go through `segment_sum`, which adds in one fixed order on every
device: on the CPU it is `index_add_` (rows added one by one in ascending
order, as XLA's scatter adds on the CPU), on the card the hand-written
kernel `csrc/segment_sum.cu`, which adds in the same order, in place of the
atomics of `index_add_`, whose order changes from run to run. A CUDA tensor
never takes `index_add_`: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple

import torch

from . import kernels

SEGMENT_SUM_SOURCE = os.path.join(kernels._PKG_DIR, "csrc", "segment_sum.cu")
SEGMENT_SUM_MAX_COLS = 64   # csrc/segment_sum.cu: segment_sum_launch


def masked_set(arr: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
               val) -> torch.Tensor:
    """Copy of arr with arr[idx[ok]] = val[ok].

    idx: (N,) int; ok: (N,) bool; val: (N, ...) or broadcastable. Live rows
    must not repeat an index (the reference leaves the winner of duplicate
    live writes unspecified too). Out of place, so it also runs under
    `torch.vmap` with `arr` shared by the lanes."""
    cap = arr.shape[0]
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    val = val.expand((idx.shape[0],) + tuple(arr.shape[1:]))
    out = torch.cat([arr, arr[:1]])               # row `cap` is the spare
    return out.index_put((torch.where(ok, idx.long(), cap),), val)[:cap]


def masked_set_last(arr: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                    val) -> torch.Tensor:
    """`masked_set` where live rows may repeat an index: among the live rows
    that share one, the last row wins, on every device. That is the rule of
    the reference's `masked_set` (`.at[idx].set(val, mode='drop')`, whose
    XLA scatter writes the updates in row order on the CPU): an
    order-free `amax` of the row positions names each index's winner, and
    only the winners are written, with no index twice."""
    cap = arr.shape[0]
    safe = torch.where(ok, idx.long(), cap)
    pos = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full((cap + 1,), -1, dtype=torch.long,
                        device=idx.device).scatter_reduce(
        0, safe, pos, reduce="amax")
    return masked_set(arr, idx, ok & (winner[safe] == pos), val)


class SegmentPlan(NamedTuple):
    """Where each segment's rows lie, built once for a fixed index and reused
    by every `segment_sum` over it (the BA's observation -> point and
    observation -> camera maps within one solve)."""
    n: int                  # segments
    perm: torch.Tensor      # (N,) int64 stable sort of the index
    offsets: torch.Tensor   # (n + 1,) int64: segment s is rows
                            # perm[offsets[s]:offsets[s + 1]]


def segment_plan(idx: torch.Tensor, n: int) -> SegmentPlan:
    """The plan of `segment_sum(n, idx, ...)`: a stable sort of `idx` and
    the n + 1 segment offsets by `torch.searchsorted`, so building it never
    waits for the device. Rows with idx == n (masked) lie past offsets[n]."""
    key, perm = torch.sort(idx.reshape(-1).long(), stable=True)
    offsets = torch.searchsorted(key, torch.arange(n + 1, device=key.device))
    return SegmentPlan(n, perm, offsets)


@functools.lru_cache(maxsize=None)
def _segment_sum_fn():
    """Compile csrc/segment_sum.cu (once per source hash) and load it."""
    lib = ctypes.CDLL(kernels.compile_sources([SEGMENT_SUM_SOURCE])[0][0])
    fn = lib.segment_sum_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_sum_plain(n: int, idx: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """The plain version of `segment_sum`: `index_add_`, which on the CPU
    adds the rows one by one in ascending order."""
    out = torch.zeros((n + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx.long(), vals)[:n]


def segment_sum(n: int, idx: torch.Tensor, vals: torch.Tensor,
                plan: SegmentPlan | None = None) -> torch.Tensor:
    """`zeros((n,) + vals.shape[1:]).at[idx].add(vals)`, every segment summed
    in ascending row order from 0.0; rows with idx == n (masked) are
    dropped. idx: (N,) int in [0, n]; vals: (N, ...).

    CPU tensors take `segment_sum_plain`. CUDA tensors take the kernel,
    one launch: float32 values of at most 64 columns per row; `plan`, from
    `segment_plan(idx, n)`, is built here when not given. Each launch adds
    one to `segment_sum.launches`."""
    rest = tuple(vals.shape[1:])
    dev = vals.device
    if dev.type == "cpu":
        return segment_sum_plain(n, idx, vals)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows, cols = vals.shape[0], math.prod(rest)
    if vals.dtype != torch.float32:
        raise ValueError(f"segment_sum takes float32 values, got {vals.dtype}")
    if not 1 <= cols <= SEGMENT_SUM_MAX_COLS:
        raise ValueError(f"segment_sum takes 1..{SEGMENT_SUM_MAX_COLS} "
                         f"columns per row, got {cols}")
    if tuple(idx.shape) != (rows,) or idx.device != dev:
        raise ValueError(f"index of shape {tuple(idx.shape)} on {idx.device} "
                         f"for {rows} rows on {dev}")
    if plan is None:
        plan = segment_plan(idx, n)
    if (plan.n != n or plan.offsets.device != dev
            or plan.perm.shape[0] != rows):
        raise ValueError("the plan was made for another index")
    out = torch.empty((n, cols), dtype=torch.float32, device=dev)
    if n == 0:
        return out.reshape((n,) + rest)
    v = vals.reshape(rows, cols).contiguous()
    fn = _segment_sum_fn()
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), plan.perm.data_ptr(),
                 plan.offsets.data_ptr(), n, cols, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    segment_sum.launches += 1
    return out.reshape((n,) + rest)


segment_sum.launches = 0


def scatter_max(size: int, idx: torch.Tensor, val: torch.Tensor,
                fill) -> torch.Tensor:
    """`full((size,), fill).at[idx].max(val)`: order-free, exact."""
    out = torch.full((size,), fill, dtype=val.dtype, device=val.device)
    return out.scatter_reduce(0, idx.long(), val, reduce="amax")


def scatter_min(size: int, idx: torch.Tensor, val: torch.Tensor,
                fill) -> torch.Tensor:
    """`full((size,), fill).at[idx].min(val)`: order-free, exact."""
    out = torch.full((size,), fill, dtype=val.dtype, device=val.device)
    return out.scatter_reduce(0, idx.long(), val, reduce="amin")


def mark(size: int, idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """(size,) bool: True at idx[ok] (`zeros(bool).at[idx].max(ok)`)."""
    return scatter_max(size, idx, ok.to(torch.int32), 0) > 0


def nonzero_static(mask: torch.Tensor, size: int):
    """`jnp.nonzero(mask, size=size, fill_value=0)` for a 1-d mask, without
    a host sync: (ids (size,) int64 in increasing order, zero-padded;
    live (size,) bool marking the real entries)."""
    n = mask.shape[0]
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    if size > n:
        order = torch.cat([order, order.new_zeros(size - n)])
    ids = order[:size]
    live = torch.arange(size, device=mask.device) < mask.sum()
    return torch.where(live, ids, 0), live
