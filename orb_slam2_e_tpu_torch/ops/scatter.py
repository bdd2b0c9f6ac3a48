"""Masked and order-free scatter helpers.

The reference routes masked rows of a scatter to an out-of-range index and
drops them with `mode='drop'` (orb_slam2_e_tpu/ops/scatter.py). torch has no
drop mode: an out-of-range index raises on the CPU and fires a device assert
on the GPU. So the mask is applied explicitly: masked rows write into one
spare row appended past the end, which is cut off again. That keeps the
index tensor's shape static (no host sync for a boolean mask).
"""

from __future__ import annotations

import torch


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
