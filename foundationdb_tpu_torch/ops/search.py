"""Vectorized multiword-key comparison and binary search (torch).

Port of the reference package's ops/search.py over the int32 flipped-lane
layout (keys.py): rows are int32[N, W] whose signed lexicographic order is
the byte-string order of the keys they encode.  Fixed-trip-count binary
search: `_levels(n)` vectorized gather+compare rounds per query batch."""

from __future__ import annotations

import torch

from .rmq import _levels


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the trailing word axis, broadcasting over
    the leading axes; [..., W] -> [...] bool.  Decided at the first lane
    that differs (lane 0, equal, when none does): a fixed number of ops
    whatever W, so 16 KB keys cost no more launches than short ones."""
    a, b = torch.broadcast_tensors(a, b)
    first = (a != b).to(torch.uint8).argmax(-1, keepdim=True)
    return (a.gather(-1, first) < b.gather(-1, first)).squeeze(-1)


def _search(sorted_keys: torch.Tensor, q: torch.Tensor, go_right) -> torch.Tensor:
    n = sorted_keys.shape[0]
    lo = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    if n == 0:
        return lo
    hi = torch.full((q.shape[0],), n, dtype=torch.int32, device=q.device)
    for _ in range(_levels(n)):
        active = lo < hi
        mid = torch.clamp(torch.div(lo + hi, 2, rounding_mode="floor"), 0, n - 1)
        right = go_right(sorted_keys[mid.long()], q)
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def lower_bound(sorted_keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """First index i with sorted_keys[i] >= q.  sorted_keys [N, W], q [Q, W]."""
    return _search(sorted_keys, q, lambda km, qq: lex_less(km, qq))


def upper_bound(sorted_keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """First index i with sorted_keys[i] > q."""
    return _search(sorted_keys, q, lambda km, qq: ~lex_less(qq, km))


def lexsort(cols: list[torch.Tensor]) -> torch.Tensor:
    """Permutation (int64) that sorts rows by the int32 columns `cols`,
    most significant first — the counterpart of the reference's
    multi-operand `lax.sort(num_keys=...)` and `jnp.lexsort`.  Columns
    pair up into int64 keys (hi * 2**32 + lo + 2**31 is monotone in
    (hi, lo)), and the keys take stable sorts least significant first."""
    keys = []
    for i in range(0, len(cols), 2):
        hi = cols[i].long()
        if i + 1 < len(cols):
            hi = hi * (1 << 32) + (cols[i + 1].long() + (1 << 31))
        keys.append(hi)
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        p = torch.sort(k, stable=True).indices
        perm = p if perm is None else perm[p]
    return perm
