"""Work items: contiguous index ranges cut into pieces of bounded length, so
that one block per piece balances a kernel whose ranges are uneven (K3's
chunk job ranges, K7's tile pair ranges)."""
from __future__ import annotations

import torch


def work_items(begin, end, size: int, slots: int):
    """Cut each owner's range [begin[o], end[o]) into items of at most `size`
    consecutive indices, in owner order and, within an owner, in index order
    → (owner, lo, hi) int32 [slots], item k covering [lo[k], hi[k]) of
    owner[k]; and (first, count) int32 [n_owners], owner o's items being
    first[o] .. first[o] + count[o] − 1. An empty range has no item. Slots
    past the last item have owner −1 and an empty range. `slots` must hold
    every item: n_owners + (the ranges' total length) // size always does.
    Device ops only (cumsum, searchsorted): no host sync."""
    dev = begin.device
    n_owners = begin.shape[0]
    b, e = begin.long(), end.long()
    count = (torch.clamp(e - b, min=0) + size - 1) // size
    last = torch.cumsum(count, 0)
    first = last - count
    k = torch.arange(slots, device=dev)
    owner = torch.searchsorted(last, k, right=True)
    live = owner < n_owners
    # owner n_owners (slots past the last item) reads a padding row of 0
    pad = lambda x: torch.cat([x, x.new_zeros(1)])
    lo = torch.where(live, pad(b)[owner] + (k - pad(first)[owner]) * size, 0)
    hi = torch.where(live, torch.minimum(lo + size, pad(e)[owner]), 0)
    i32 = lambda x: x.to(torch.int32).contiguous()
    return (i32(torch.where(live, owner, -1)), i32(lo), i32(hi), i32(first),
            i32(count))
