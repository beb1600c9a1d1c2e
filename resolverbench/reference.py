"""The plain reference: what a resolver must answer for a stream of
transactions, worked out again from the generated inputs with NumPy and a
loop in transaction order.  It imports nothing of the program.

FoundationDB's resolver semantics (fdbserver/ConflictSet.h,
SkipList.cpp):
  TOO_OLD    the snapshot is below the MVCC floor (oldest version);
  CONFLICT   a read range [rb, re) intersects (wb < re and rb < we) a
             write range [wb, we) committed at a version above the
             snapshot by a transaction of an earlier batch, or one of an
             earlier committed transaction of the same batch;
  COMMITTED  otherwise; its write ranges then enter the history at the
             batch's commit version.
Writes below the floor never conflict with a snapshot at or above it, so
the floor needs no history of its own.  `Reference` is that check for
point ranges [k, k + b"\\x00"), which intersect only on equal keys;
`RangeReference` for ranges of any keys, empty ones (begin >= end)
dropped.

Keys are compared as the bytes the generator makes: `Keys` maps key ids to
one index per distinct byte string, in byte order, so two ids with the same
bytes are one key and a range's ends can be compared by their indices.
"""

from __future__ import annotations

import numpy as np

CONFLICT, TOO_OLD, COMMITTED = 0, 1, 2  # ConflictSet.h's result codes
_NONE = np.iinfo(np.int64).max


class Keys:
    """Key ids -> one dense index per distinct key (by its bytes)."""

    def __init__(self, ids: np.ndarray, key_bytes) -> None:
        self.ids = np.unique(ids)
        rows, lens = key_bytes(self.ids)
        width = -(-rows.shape[1] // 8) * 8
        padded = np.zeros((rows.shape[0], width), dtype=np.uint8)
        padded[:, :rows.shape[1]] = rows
        words = padded.view(">u8").astype(np.uint64)
        cols = [np.asarray(lens, dtype=np.uint64)] + [words[:, j] for j in
                                                     range(words.shape[1] - 1, -1, -1)]
        order = np.lexsort(cols)
        srt = np.stack(cols, axis=1)[order]
        new = np.ones(len(order), dtype=bool)
        new[1:] = (srt[1:] != srt[:-1]).any(axis=1)
        dense = np.empty(len(order), dtype=np.int64)
        dense[order] = np.cumsum(new) - 1
        self.count = int(new.sum())
        # a lookup table by id (-1: an id the reference was not built for)
        self.table = np.full(int(self.ids[-1]) + 1 if len(self.ids) else 0, -1,
                             dtype=np.int64)
        self.table[self.ids] = dense

    def __call__(self, ids: np.ndarray) -> np.ndarray:
        out = self.table[ids]
        if (out < 0).any():
            raise KeyError("a key id outside the ones the reference was built for")
        return out


class Reference:
    """The resolver's answers, batch after batch, over dense key indices.
    `intra`, `history` and `too_old` name the guarantees checked; a
    control (control.py) turns one off."""

    def __init__(self, n_keys: int, *, intra: bool = True, history: bool = True,
                 too_old: bool = True) -> None:
        self.last = np.zeros(n_keys, dtype=np.int64)  # last committed write version
        self.intra, self.history, self.too_old = intra, history, too_old

    def resolve(self, version: int, oldest: int, reads: np.ndarray,
                writes: np.ndarray, snaps: np.ndarray) -> np.ndarray:
        """Verdicts of one batch (reads [B, r] and writes [B, w] as dense
        key indices), and its committed writes into the history."""
        B = snaps.shape[0]
        active = snaps >= oldest if self.too_old else np.ones(B, dtype=bool)
        ok = active.copy()
        if self.history and reads.shape[1]:
            ok &= ~(self.last[reads] > snaps[:, None]).any(axis=1)
        committed = ok.copy()
        if self.intra and reads.shape[1] and writes.shape[1]:
            self._intra(reads, writes, committed)
        verdict = np.where(active, np.where(committed, COMMITTED, CONFLICT), TOO_OLD)
        self.last[writes[committed].ravel()] = version
        return verdict.astype(np.int8)

    @staticmethod
    def _intra(reads, writes, committed) -> None:
        """Clear `committed` for each transaction that reads a key an
        earlier committed transaction of the batch writes, in transaction
        order.  Only a transaction that reads a key some earlier one writes
        can be hit; the others keep their verdict and are settled first."""
        B = committed.shape[0]
        keys, inv = np.unique(np.concatenate([reads.ravel(), writes.ravel()]),
                              return_inverse=True)
        r_loc = inv[:reads.size].reshape(reads.shape)
        w_loc = inv[reads.size:].reshape(writes.shape)
        tx = np.arange(B)
        first_writer = np.full(len(keys), _NONE, dtype=np.int64)
        np.minimum.at(first_writer, w_loc.ravel(), np.repeat(tx, writes.shape[1]))
        hit = committed & (first_writer[r_loc] < tx[:, None]).any(axis=1)
        settled = committed & ~hit
        first_committed = np.full(len(keys), _NONE, dtype=np.int64)
        np.minimum.at(first_committed, w_loc[settled].ravel(),
                      np.repeat(tx[settled], writes.shape[1]))
        fc = first_committed.tolist()
        hits = np.flatnonzero(hit)
        for t, r_row, w_row in zip(hits.tolist(), r_loc[hits].tolist(),
                                   w_loc[hits].tolist()):
            if any(fc[k] < t for k in r_row):
                committed[t] = False
                continue
            for k in w_row:
                if t < fc[k]:
                    fc[k] = t


def _spans(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The positions of the non-empty spans [lo, hi), concatenated, and
    where each span starts among them."""
    n = hi - lo
    starts = np.cumsum(n) - n
    return np.arange(int(n.sum())) - np.repeat(starts - lo, n), starts


class RangeReference:
    """The resolver's answers, batch after batch, for ranges [begin, end)
    of dense key indices (`Keys`: in byte order).  The history is the last
    committed write version of each segment [key j, key j + 1) between
    consecutive keys, so a range covers the segments of indices begin to
    end - 1.  The same switches as `Reference`."""

    def __init__(self, n_keys: int, *, intra: bool = True, history: bool = True,
                 too_old: bool = True) -> None:
        self.last = np.zeros(n_keys, dtype=np.int64)
        self.intra, self.history, self.too_old = intra, history, too_old

    def resolve(self, version: int, oldest: int, rb: np.ndarray, re: np.ndarray,
                rt: np.ndarray, wb: np.ndarray, we: np.ndarray, wt: np.ndarray,
                snaps: np.ndarray) -> np.ndarray:
        """Verdicts of one batch: read ranges [rb, re) of transactions rt,
        write ranges [wb, we) of transactions wt, read versions `snaps`
        [B]; its committed writes into the history."""
        B = snaps.shape[0]
        active = snaps >= oldest if self.too_old else np.ones(B, dtype=bool)
        r = active[rt] & (rb < re)
        rb, re, rt = rb[r], re[r], rt[r]
        w = active[wt] & (wb < we)
        wb, we, wt = wb[w], we[w], wt[w]
        ok = active.copy()
        if self.history and rb.size:
            idx, starts = _spans(rb, re)
            newest = np.maximum.reduceat(self.last[idx], starts)
            ok[rt[newest > snaps[rt]]] = False
        committed = ok.copy()
        if self.intra and rb.size and wb.size:
            self._intra(rb, re, rt, wb, we, wt, committed)
        verdict = np.where(active, np.where(committed, COMMITTED, CONFLICT), TOO_OLD)
        c = committed[wt]
        if c.any():
            self.last[self._covered(wb[c], we[c])] = version  # versions rise
        return verdict.astype(np.int8)

    @staticmethod
    def _covered(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """The segments the ranges [lo, hi) cover, each once: a coverage
        count over the ranges' own ends."""
        pts, inv = np.unique(np.concatenate([lo, hi]), return_inverse=True)
        count = (np.bincount(inv[:lo.size], minlength=pts.size)
                 - np.bincount(inv[lo.size:], minlength=pts.size))
        on = np.cumsum(count)[:-1] > 0  # the piece [pts[j], pts[j + 1])
        return _spans(pts[:-1][on], pts[1:][on])[0]

    @staticmethod
    def _intra(rb, re, rt, wb, we, wt, committed) -> None:
        """Clear `committed` for each transaction with a read range that
        intersects a write range of an earlier committed transaction of
        the batch, in transaction order, over the segments between the
        batch's own range ends.  Only a transaction with a read range that
        some earlier one's write range intersects can be hit; the others
        keep their verdict and are settled first."""
        B = committed.shape[0]
        pts, inv = np.unique(np.concatenate([rb, re, wb, we]), return_inverse=True)
        lrb, lre, lwb, lwe = np.split(inv, np.cumsum([rb.size, re.size, wb.size]))
        r_seg, r_starts = _spans(lrb, lre)
        w_seg, _ = _spans(lwb, lwe)
        r_tx, w_tx = np.repeat(rt, lre - lrb), np.repeat(wt, lwe - lwb)
        first_writer = np.full(pts.size, _NONE, dtype=np.int64)
        np.minimum.at(first_writer, w_seg, w_tx)
        earliest = np.minimum.reduceat(first_writer[r_seg], r_starts)
        hit = np.zeros(B, dtype=bool)
        hit[rt[earliest < rt]] = True
        hit &= committed
        settled = committed & ~hit
        first_committed = np.full(pts.size, _NONE, dtype=np.int64)
        s = settled[w_tx]
        np.minimum.at(first_committed, w_seg[s], w_tx[s])
        hits = np.flatnonzero(hit)
        reads_of, writes_of = _group(r_seg, r_tx, hits), _group(w_seg, w_tx, hits)
        for t, rs, ws in zip(hits.tolist(), reads_of, writes_of):
            if first_committed[rs].min() < t:
                committed[t] = False
            elif ws.size:
                first_committed[ws] = np.minimum(first_committed[ws], t)


def _group(seg: np.ndarray, tx: np.ndarray, txs: np.ndarray) -> list[np.ndarray]:
    """The segments of each of the transactions `txs` (sorted)."""
    keep = np.isin(tx, txs)
    order = np.argsort(tx[keep], kind="stable")
    seg, tx = seg[keep][order], tx[keep][order]
    lo, hi = np.searchsorted(tx, txs, "left"), np.searchsorted(tx, txs, "right")
    return [seg[a:b] for a, b in zip(lo.tolist(), hi.tolist())]
