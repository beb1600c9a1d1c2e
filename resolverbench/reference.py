"""The plain reference: what a resolver must answer for a stream of point
transactions, worked out again from the generated inputs with NumPy and a
loop in transaction order.  It imports nothing of the program.

FoundationDB's resolver semantics (fdbserver/ConflictSet.h,
SkipList.cpp), for point ranges [k, k + b"\\x00"), which intersect only on
equal keys:
  TOO_OLD    the snapshot is below the MVCC floor (oldest version);
  CONFLICT   a key read was written at a version above the snapshot by a
             committed transaction of an earlier batch, or by an earlier
             committed transaction of the same batch;
  COMMITTED  otherwise; its writes then enter the history at the batch's
             commit version.
Writes below the floor never conflict with a snapshot at or above it, so
the floor needs no history of its own.

Keys are compared as the bytes the generator makes: `Keys` maps key ids to
one index per distinct byte string, so two ids with the same bytes are one
key.
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
