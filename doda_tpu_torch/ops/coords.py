"""Packed coordinate keys, dedup and table lookup (one scene).

Port of ``doda_tpu/ops/coords.py``: ``unique_coords``, ``pack_coords``,
``lookup`` and ``pad_rows``, and its packed single-key half. Brick coords
are packed into one int32 key ``(x << 20) | (y << 10) | z``; coords outside
[0, 1024) per axis count as invalid. Voxel coords (``unique_coords``, up to
``MAX_COORD`` per axis) take one int64 key ``x * 2^32 + y * 2^16 + z``,
which sorts as the JAX package's two int32 keys (x, y * 2^16 + z) of
``pack_coords`` do. Tables are sorted by their key, so table ids are ranks
in the packed order, exactly as in the JAX package, and both lookups are a
binary search of the table's keys. Every miss (invalid point, absent
neighbour, overflowed capacity) maps to the null id ``cap``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_COORD = 2 ** 15 - 1
SENTINEL = torch.iinfo(torch.int32).max
SENTINEL64 = torch.iinfo(torch.int64).max
PACK_BITS = 10
_PACK_LIM = 1 << PACK_BITS


class CoordTable(NamedTuple):
    """A deduplicated coordinate table sorted by packed key.

    coords : (cap, 3) int32 — unique coords; rows >= n hold MAX_COORD.
    key    : (cap,) packed key of each row, SENTINEL past n: int32 for
             brick tables, int64 (SENTINEL64) for ``unique_coords``.
    n      : () int32 — number of valid rows (<= cap).
    p2v    : (N,) int32 — input row -> table id; misses -> cap.
    """

    coords: torch.Tensor
    key: torch.Tensor
    n: torch.Tensor
    p2v: torch.Tensor

    @property
    def cap(self) -> int:
        return self.coords.shape[-2]

    @property
    def valid(self) -> torch.Tensor:
        return torch.arange(self.cap, device=self.n.device) < self.n


def pack_coords1(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., 3) int coords -> one int32 key; invalid or out of range ->
    SENTINEL."""
    c = coords.to(torch.int32)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    in_range = ((c >= 0) & (c < _PACK_LIM)).all(-1)
    k = (x << (2 * PACK_BITS)) | (y << PACK_BITS) | z
    return torch.where(valid & in_range, k, SENTINEL)


def _unpack(k: torch.Tensor) -> torch.Tensor:
    return torch.stack([k >> (2 * PACK_BITS),
                        (k >> PACK_BITS) & (_PACK_LIM - 1),
                        k & (_PACK_LIM - 1)], dim=-1)


def unique_coords_packed(coords: torch.Tensor, valid: torch.Tensor,
                         cap: int) -> CoordTable:
    """Deduplicate (N, 3) coords into a sorted table of capacity ``cap``.

    Keys beyond the first ``cap`` unique ones overflow into the null slot
    and are dropped silently (``n`` is clamped to ``cap``)."""
    dev = coords.device
    n_pts = coords.shape[0]
    ks, order = torch.sort(pack_coords1(coords, valid), stable=True)
    valid_s = ks != SENTINEL
    new = torch.ones_like(valid_s)
    new[1:] = ks[1:] != ks[:-1]
    new &= valid_s
    vid_s = torch.cumsum(new, 0, dtype=torch.int32) - 1
    n = (vid_s[-1] + 1).clamp(max=cap).to(torch.int32)
    vid_s = torch.where(valid_s & (vid_s < cap), vid_s, cap)

    slot = torch.where(new & (vid_s < cap), vid_s, cap).long()
    table = torch.full((cap + 1, 3), MAX_COORD, dtype=torch.int32,
                       device=dev)
    table[slot] = _unpack(ks)
    table = table[:cap]         # row cap took every non-new write

    p2v = torch.empty(n_pts, dtype=torch.int32, device=dev)
    p2v[order] = vid_s
    key = pack_coords1(table, torch.arange(cap, device=dev) < n)
    return CoordTable(coords=table, key=key, n=n, p2v=p2v)


def lookup_packed(table: CoordTable, query_coords: torch.Tensor,
                  query_valid: torch.Tensor) -> torch.Tensor:
    """Table id of each query coord, ``cap`` where absent.

    Table keys ascend (SENTINEL rows last), so a binary search finds each
    query's only candidate row."""
    cap = table.cap
    qk = pack_coords1(query_coords, query_valid)
    pos = torch.searchsorted(table.key, qk.reshape(-1)).reshape(qk.shape)
    pos = pos.clamp(max=cap - 1)
    hit = (table.key[pos] == qk) & (qk != SENTINEL)
    return torch.where(hit, pos.to(torch.int32), cap)


def pack_coords(coords: torch.Tensor, valid: torch.Tensor):
    """(..., 3) int coords -> the JAX package's two int32 sort keys
    k1 = x, k2 = y * 2^16 + z; invalid rows get SENTINEL in both."""
    c = coords.to(torch.int32)
    k1 = torch.where(valid, c[..., 0], SENTINEL)
    k2 = torch.where(valid, c[..., 1] * 2 ** 16 + c[..., 2], SENTINEL)
    return k1, k2


def lookup(table: CoordTable, query_coords: torch.Tensor,
           query_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Table id of each query coord in a ``unique_coords`` table, ``cap``
    where absent. The int64 key k1 * 2^32 + k2 equals the table's key for
    the same coords and no other table row's: a query coord of -1 or
    MAX_COORD + 1 (an offset past the scene) would need a table coord of
    65535 on the next axis."""
    cap = table.cap
    if query_valid is None:
        query_valid = torch.ones(query_coords.shape[:-1], dtype=torch.bool,
                                 device=query_coords.device)
    k1, k2 = pack_coords(query_coords, query_valid)
    qk = k1.to(torch.int64) * 2 ** 32 + k2.to(torch.int64)
    pos = torch.searchsorted(table.key, qk.reshape(-1)).reshape(qk.shape)
    pos = pos.clamp(max=cap - 1)
    hit = (table.key[pos] == qk) & (k1 != SENTINEL)
    return torch.where(hit, pos.to(torch.int32), cap)


def _pack64(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    c = coords.to(torch.int64)
    k = (c[..., 0] << 32) | (c[..., 1] << 16) | c[..., 2]
    return torch.where(valid, k, SENTINEL64)


def unique_coords(coords: torch.Tensor, valid: torch.Tensor,
                  cap: int) -> CoordTable:
    """Deduplicate (N, 3) coords, 0 <= c <= MAX_COORD, into a table of
    capacity ``cap`` sorted lexicographically by (x, y, z).

    Coords beyond the first ``cap`` unique ones overflow into the null
    slot and are dropped (``n`` is clamped to ``cap``)."""
    dev = coords.device
    n_pts = coords.shape[0]
    ks, order = torch.sort(_pack64(coords, valid), stable=True)
    valid_s = ks != SENTINEL64
    new = torch.ones_like(valid_s)
    new[1:] = ks[1:] != ks[:-1]
    new &= valid_s
    vid_s = torch.cumsum(new, 0, dtype=torch.int32) - 1
    n = (vid_s[-1] + 1).clamp(max=cap).to(torch.int32) if n_pts \
        else torch.zeros((), dtype=torch.int32, device=dev)
    vid_s = torch.where(valid_s & (vid_s < cap), vid_s, cap)

    slot = torch.where(new & (vid_s < cap), vid_s, cap).long()
    table = torch.full((cap + 1, 3), MAX_COORD, dtype=torch.int32,
                       device=dev)
    table[slot] = torch.stack([ks >> 32, (ks >> 16) & 0xffff, ks & 0xffff],
                              -1).to(torch.int32)
    table = table[:cap]         # row cap took every non-new write

    p2v = torch.empty(n_pts, dtype=torch.int32, device=dev)
    p2v[order] = vid_s
    key = _pack64(table, torch.arange(cap, device=dev) < n)
    return CoordTable(coords=table, key=key, n=n, p2v=p2v)


def pad_rows(values: torch.Tensor) -> torch.Tensor:
    """Append one zero row so null-slot gathers (id == cap) return 0."""
    return torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
