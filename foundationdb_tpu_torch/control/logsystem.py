"""LogSystem — the epoch'd TLog-set abstraction (fdbserver/LogSystem.h:787
ILogSystem; fdbserver/TagPartitionedLogSystem.actor.cpp).

One generation's durability plane as a first-class object: the set of TLog
replicas, the tag -> replica-slot map, epoch-end determination (lock the
old set, compute the recovery version, merge surviving tag data), the
whole-cluster-restart twin that reads the same state from disk files, and
seed construction for the next epoch's set.  Recovery
(control/controller.py) and the stream-consumer wiring (backup workers,
log routers) consume this interface instead of manipulating TLogs
directly, so a second log topology (satellites, sharded log groups) is a
new LogSystem implementation, not controller surgery.

Epoch-end rule (the reference's): a version acked to the client was made
durable on EVERY replica of its tags, so `min(end_version)` over the
surviving replicas keeps every acked commit and drops any torn
partially-pushed suffix consistently across tags.  A tag whose every
replica is lost (no live lock reply AND no readable file) is an
unrecoverable-data-loss error, never a silent proceed.

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

from typing import Callable

from ..roles.tlog import TLog
from ..roles.types import TLogLockReply, TLogLockRequest, Version
from ..rpc.stream import RequestStreamRef
from ..runtime.core import BrokenPromise, TimedOut
from ..runtime.coverage import testcov


def region_required_tags(storage_tags: list[str], region_config,
                         stream_consumers) -> list[str]:
    """The required-tag set recovery refuses to lose, grown by the region
    configuration (control/region.py): under `usable_regions=2` with the
    satellite requirement, the log-router tag's retained backlog — commits
    acked locally but not yet durable in the remote region — is part of
    the durability contract, so losing every replica slot of it must abort
    recovery exactly like losing a storage tag would.  Consumed by both
    epoch-end paths (live lock and whole-cluster restart from disk)."""
    tags = list(storage_tags)
    if region_config is not None and region_config.router_tag_required:
        from ..roles.logrouter import ROUTER_TAG

        if ROUTER_TAG in stream_consumers:
            testcov("region.router_tag_required")
            tags.append(ROUTER_TAG)
    return tags


def remap_router_entries(replies: list, remote_map) -> int:
    """Fold retained log-router entries into the REMOTE tags' recovery
    seeds (the promoted-reboot half of the router retention contract).

    After a region failover, the promoted replicas' newest data is held
    back from their disks by the MVCC window — for that window the only
    durable copy a reboot can re-serve them is the router tag's retained
    backlog (mutations <= the promotion boundary carry only primary and
    router tags; the replicas' own tags start ABOVE it).  A whole-sim
    power kill inside the window therefore lands here: re-tag each
    retained router mutation by key through the promoted key map —
    exactly the re-tagging the live router performed — so merge_replies
    seeds the replicas' tags with the stream they still owe their disks.
    Entries drain from the reply dicts (the router tag itself stays
    droppable); duplicate versions against the replicas' own tags are
    deduplicated by merge_replies.  Returns the entry count remapped."""
    from ..roles.logrouter import ROUTER_TAG
    from ..roles.types import MutationType

    remapped = 0
    for r in replies:
        if r is None or ROUTER_TAG not in r.tags:
            continue
        entries = r.tags.pop(ROUTER_TAG)
        for version, muts in entries:
            by_tag: dict[str, list] = {}
            for m in muts:
                if m.type == MutationType.CLEAR_RANGE:
                    teams = remote_map.members_for_range(m.key, m.value)
                else:
                    teams = [remote_map.member_for_key(m.key)]
                for team in teams:
                    for t in team:
                        by_tag.setdefault(t, []).append(m)
            for t, tmuts in by_tag.items():
                r.tags.setdefault(t, []).append((version, tmuts))
            remapped += 1
    if remapped:
        testcov("region.router_seed_remap")
    return remapped


class LogSystem:
    """One epoch's TLog set (tag-partitioned, 2x replicated)."""

    def __init__(self, epoch: int, tlogs: list[TLog],
                 paths: list[str] | None = None) -> None:
        self.epoch = epoch
        self.tlogs = tlogs
        self.paths = paths or []
        self.n_slots = len(tlogs)

    # -- tag -> replica slots (TagPartitionedLogSystem's tag->log map) -------
    @staticmethod
    def parse_tag(tag: str) -> tuple[int, int]:
        """Storage tag -> (shard, replica): "ss-3-r1" is shard 3 replica 1;
        legacy "ss-3" is replica 0 (reference Tag(locality, id))."""
        parts = tag.split("-")
        shard = int(parts[1])
        replica = int(parts[2][1:]) if len(parts) > 2 else 0
        return shard, replica

    @classmethod
    def tag_slots(cls, tag: str, n_slots: int) -> list[int]:
        """Replica slots holding `tag`: primary + next (2x log replication
        — one TLog loss keeps every tag recoverable)."""
        shard, replica = cls.parse_tag(tag)
        primary = (shard + replica) % n_slots
        if n_slots == 1:
            return [0]
        return [primary, (primary + 1) % n_slots]

    def slots_for(self, tag: str) -> list[int]:
        return self.tag_slots(tag, self.n_slots)

    # -- wiring helpers (peek/pop refs for a tag's consumers) ----------------
    def peek_ref(self, net, proc, tag: str) -> RequestStreamRef:
        tlog = self.tlogs[self.slots_for(tag)[0]]
        return RequestStreamRef(net, proc, tlog.peek_stream.endpoint)

    def pop_ref(self, net, proc, tag: str) -> RequestStreamRef:
        """Primary-slot pop ref (storage servers pop where they peek)."""
        tlog = self.tlogs[self.slots_for(tag)[0]]
        return RequestStreamRef(net, proc, tlog.pop_stream.endpoint)

    def pop_refs(self, net, proc, tag: str) -> list[RequestStreamRef]:
        return [
            RequestStreamRef(net, proc, self.tlogs[s].pop_stream.endpoint)
            for s in self.slots_for(tag)
        ]

    # -- epoch end: lock the set, learn the recovery version -----------------
    async def lock(
        self, net, cc_proc, fs, required_tags: list[str],
    ) -> tuple[Version, list[dict]]:
        """End this epoch: lock every reachable TLog (locked TLogs refuse
        further commits — the fence against a deposed proxy), fall back to
        the synced file of any observably-dead one, and return
        (recovery_version, per-slot replies) — feed to `merge_replies`.

        Raises on unrecoverable data loss: a required tag with every
        replica lost."""
        replies: list[TLogLockReply | None] = []
        for i, t in enumerate(self.tlogs):
            ref = RequestStreamRef(net, cc_proc, t.lock_stream.endpoint)
            try:
                replies.append(await ref.get_reply(TLogLockRequest(), timeout=1.0))
                continue
            except (TimedOut, BrokenPromise):
                pass
            # a KILLED TLog's disk outlives it (kill drops only the unsynced
            # suffix, and every acked commit was synced first): recover its
            # state from the file — the difference between "machine died"
            # and "data lost".  Only for observably-dead processes: an alive
            # but partitioned TLog must not be bypassed (it could still be
            # acking; the lock fence is what stops it).
            if fs is not None and not t.process.alive and i < len(self.paths):
                reply = self.read_tlog_file(fs, self.paths[i])
                if reply is not None:
                    testcov("recovery.tlog_disk_fallback")
                    replies.append(reply)
                    continue
            replies.append(None)  # that TLog is gone
        self._check_coverage(replies, required_tags)
        alive = [r for r in replies if r is not None]
        recovery_version = min(r.end_version for r in alive)
        return recovery_version, replies

    def _check_coverage(self, replies: list, required_tags: list[str]) -> None:
        alive_any = any(r is not None for r in replies)
        if not alive_any:
            raise RuntimeError("all TLogs lost: unrecoverable data loss")
        for tag in required_tags:
            slots = self.slots_for(tag)
            if all(replies[s] is None for s in slots):
                raise RuntimeError(
                    f"tag {tag}: all replica slots {slots} lost — data loss"
                )

    @staticmethod
    def read_tlog_file(fs, path: str) -> TLogLockReply | None:
        """One TLog's state from its synced log file (shared by the
        whole-cluster restart path and the live-recovery fallback)."""
        if not fs.exists(path):
            return None
        from ..storage.diskqueue import DiskQueue

        dq = DiskQueue(fs.open(path, None))
        end, _kc, tags = TLog.recover_state(dq)
        return TLogLockReply(end_version=end, tags=tags)

    @classmethod
    def from_disk(
        cls, fs, prev_epoch: int, prev_n_slots: int,
        paths: list[str] | None, required_tags: list[str],
    ) -> tuple[Version, list[dict], "LogSystem"]:
        """Whole-cluster restart: rebuild (recovery_version, replies) from
        the previous epoch's synced TLog files.  Unsynced suffixes died
        with the power loss; every acked commit was synced on EVERY
        replica, so the min over recovered ends keeps all acked data."""
        paths = paths or [
            f"tlog{i}-e{prev_epoch}.dq" for i in range(prev_n_slots)
        ]
        ls = cls(prev_epoch, [None] * len(paths), paths)  # type: ignore[list-item]
        ls.n_slots = len(paths)
        replies = [cls.read_tlog_file(fs, p) for p in paths]
        if not any(r is not None for r in replies):
            raise RuntimeError("no TLog files recovered: data loss")
        if sum(r is not None for r in replies) < prev_n_slots:
            ls._check_coverage(replies, required_tags)
        alive = [r for r in replies if r is not None]
        recovery_version = min(r.end_version for r in alive)
        return recovery_version, replies, ls

    # -- seed construction for the NEXT epoch's set --------------------------
    @classmethod
    def merge_replies(
        cls, replies: list, recovery_version: Version, new_n_slots: int,
        keep_tag: Callable[[str], bool],
    ) -> list[dict]:
        """Rebuild per-new-slot tag seeds from surviving replicas: union
        each tag's entries across replicas (replicas may have popped
        differently), drop anything above the recovery version, and fan
        out to the NEW epoch's replica slots."""
        merged: dict[str, list] = {}
        for r in replies:
            if r is None:
                continue
            for tag, entries in r.tags.items():
                if not keep_tag(tag):
                    continue  # residue of a finished consumer: drop
                cur = merged.setdefault(tag, [])
                have = {v for v, _ in cur}
                cur.extend((v, m) for v, m in entries if v not in have)
        seeds = [dict() for _ in range(new_n_slots)]
        for tag, entries in merged.items():
            entries.sort(key=lambda e: e[0])
            entries = [e for e in entries if e[0] <= recovery_version]
            for idx in cls.tag_slots(tag, new_n_slots):
                seeds[idx][tag] = list(entries)  # per-replica copy: the new
                # TLogs append to these lists independently
        return seeds
