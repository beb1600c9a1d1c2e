"""The resolver's packed batch layout, frozen here so that the benchmark
feeds the program the same bytes whatever a later change does to its own
packer.

A key of up to ``4 * kw`` bytes is ``kw`` big-endian uint32 words of its
bytes, zero padded, then one length word; lexicographic order of the lanes
is byte order.  A point range ``[k, k + b"\\x00")`` has the same words for
both ends and the end's length word one higher (the appended zero byte is
padding, or lies past the words): no key sorts between the two.

`pack` turns one generated batch into the eight arrays that
``DeviceConflictSet.resolve_arrays`` takes: read begins, ends and
transaction ids, write begins, ends and ids (rows padded to a power of two
with all-0xFFFFFFFF sentinels and id -1), snapshots as offsets from the
oldest version, and the live mask.  A transaction whose snapshot is below
the oldest version is TOO_OLD: it is not live and contributes no rows.
The arithmetic is that of the program's vectorised bench packer and of its
TxInfo packer (snapshot offsets, TOO_OLD at add time); the tests hold this
copy against both.

`pack_ranges` is the same layout for ranges of any keys, any number a
transaction: the TxInfo packer's (`pack_batch`), which drops an empty
range (begin >= end) as well.  `pack` stays for point keys.
"""

from __future__ import annotations

import numpy as np

SENTINEL_WORD = 0xFFFFFFFF


def bucket(n: int, lo: int = 16) -> int:
    """The least power of two that is at least n and at least lo."""
    b = lo
    while b < n:
        b *= 2
    return b


def key_lanes(key_bytes: np.ndarray, lens: np.ndarray, max_key_bytes: int) -> np.ndarray:
    """uint8[n, L] keys (zero past each length) and their lengths ->
    uint32[n, max_key_bytes // 4 + 1] lanes."""
    if max_key_bytes <= 0 or max_key_bytes % 4:
        raise ValueError("max_key_bytes must be a positive multiple of 4")
    n, L = key_bytes.shape
    if L > max_key_bytes:
        raise ValueError(f"{L}-byte key rows exceed {max_key_bytes}")
    kw = max_key_bytes // 4
    padded = np.zeros((n, 4 * kw), dtype=np.uint8)
    padded[:, :L] = key_bytes
    out = np.empty((n, kw + 1), dtype=np.uint32)
    out[:, :kw] = padded.view(">u4")
    out[:, kw] = lens
    return out


def _rows(lanes: np.ndarray, tx: np.ndarray, width: int):
    """Begin rows, end rows and transaction ids of point ranges on keys
    with these lanes, padded to a power of two."""
    n = lanes.shape[0]
    m = bucket(n)
    b = np.full((m, width), SENTINEL_WORD, dtype=np.uint32)
    e = np.full((m, width), SENTINEL_WORD, dtype=np.uint32)
    t = np.full(m, -1, dtype=np.int32)
    b[:n] = lanes
    e[:n] = lanes
    e[:n, -1] += 1
    t[:n] = tx
    return b, e, t


def pack(reads: np.ndarray, writes: np.ndarray, snaps: np.ndarray, oldest: int,
         lanes_of, width: int) -> tuple:
    """One batch as resolve_arrays' arrays.  `reads` [B, r] and `writes`
    [B, w] are key ids, `snaps` [B] read versions; `lanes_of(ids)` gives
    the ids' key lanes, `width` lanes a row.  Returns (rbv, rev, rtv, wbv,
    wev, wtv, snap, active)."""
    B = snaps.shape[0]
    active = snaps >= oldest
    live = np.flatnonzero(active).astype(np.int32)
    r_ids = reads[live].ravel()
    ids, where = np.unique(np.concatenate([r_ids, writes[live].ravel()]),
                           return_inverse=True)
    lanes = lanes_of(ids)[where]  # each distinct key encoded once
    rbv, rev, rtv = _rows(lanes[:r_ids.size], np.repeat(live, reads.shape[1]), width)
    wbv, wev, wtv = _rows(lanes[r_ids.size:], np.repeat(live, writes.shape[1]), width)
    Bp = bucket(B)
    snap = np.zeros(Bp, dtype=np.int32)
    snap[live] = snaps[live] - oldest
    act = np.zeros(Bp, dtype=bool)
    act[:B] = active
    return rbv, rev, rtv, wbv, wev, wtv, snap, act


def _rows_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rowwise a < b over uint32 lane rows: byte order of their keys."""
    neq = a != b
    first = neq.argmax(axis=1)
    rows = np.arange(a.shape[0])
    return neq.any(axis=1) & (a[rows, first] < b[rows, first])


def _range_rows(begin: np.ndarray, end: np.ndarray, tx: np.ndarray, active: np.ndarray,
                width: int):
    """The rows of the ranges of live transactions that are not empty,
    in the order given, padded to a power of two."""
    if begin.shape != end.shape or begin.shape != (tx.shape[0], width):
        raise ValueError(f"range rows must be [n, {width}] lanes, one id each")
    if (np.diff(tx) < 0).any() or (tx.size and (tx[0] < 0 or tx[-1] >= active.shape[0])):
        raise ValueError("ranges must come in transaction order, of the batch's transactions")
    keep = active[tx] & _rows_less(begin, end)
    n = int(keep.sum())
    m = bucket(n)
    b = np.full((m, width), SENTINEL_WORD, dtype=np.uint32)
    e = np.full((m, width), SENTINEL_WORD, dtype=np.uint32)
    t = np.full(m, -1, dtype=np.int32)
    b[:n] = begin[keep]
    e[:n] = end[keep]
    t[:n] = tx[keep]
    return b, e, t


def pack_ranges(r_begin: np.ndarray, r_end: np.ndarray, r_tx: np.ndarray,
                w_begin: np.ndarray, w_end: np.ndarray, w_tx: np.ndarray,
                snaps: np.ndarray, oldest: int, width: int) -> tuple:
    """One batch of key ranges as resolve_arrays' arrays.  Read ranges
    [r_begin, r_end) as uint32[n, width] key lanes (key_lanes) with their
    transactions' indices `r_tx`, in transaction order, and the same for
    writes; `snaps` [B] read versions.  A transaction may carry any number
    of ranges, none included.  Returns (rbv, rev, rtv, wbv, wev, wtv,
    snap, active)."""
    B = snaps.shape[0]
    active = snaps >= oldest
    rbv, rev, rtv = _range_rows(r_begin, r_end, r_tx, active, width)
    wbv, wev, wtv = _range_rows(w_begin, w_end, w_tx, active, width)
    live = np.flatnonzero(active)
    Bp = bucket(B)
    snap = np.zeros(Bp, dtype=np.int32)
    snap[live] = snaps[live] - oldest
    act = np.zeros(Bp, dtype=bool)
    act[:B] = active
    return rbv, rev, rtv, wbv, wev, wtv, snap, act
