"""Client transaction API — the NativeAPI analog (fdbclient/NativeAPI.actor.cpp).

`Database` is the connection handle; `Transaction` implements the FDB
transaction model: snapshot reads at a GRV-acquired read version
(getReadVersion :2821), buffered writes, conflict ranges accumulated per
read/write, OCC commit via the proxy (tryCommit :2412), and the retry loop
(`Database.run`, the `fdb.transactional` analog: on_error backoff + full
retry on NotCommitted / TransactionTooOld).

Reads route to storage servers by key partition (the client's location
cache, getKeyLocation_internal :1085 — here a static map handed out by the
cluster; invalidation/refresh arrives with data distribution).

Copy of the reference package's module, on the port's roles and rpc;
`RETRYABLE_ERRORS` holds the port's exception classes.
"""

from __future__ import annotations

from ..roles.proxy import KeyPartitionMap
from ..roles.types import (
    CLIENT_KEYSPACE_END,
    CommitReply,
    CommitResult,
    CommitTransactionRequest,
    CommitUnknownResult,
    FutureVersion,
    GetKeyRequest,
    GetKeyValuesRequest,
    GetReadVersionRequest,
    GetValueRequest,
    KeySelector,
    Mutation,
    MutationType,
    NotCommitted,
    TransactionTooOld,
    Version,
)
from ..rpc.stream import RequestStreamRef
from ..runtime.core import (
    ActorCancelled,
    BrokenPromise,
    DeterministicRandom,
    EventLoop,
    Promise,
    TimedOut,
)
from ..runtime.trace import g_trace_batch
from ..keys import key_after
from ..runtime.coverage import testcov

# errors a client retry loop may transparently retry (the onError set,
# NativeAPI.actor.cpp:2543 — not_committed / transaction_too_old /
# future_version / commit_unknown_result / proxy-unreachable timeouts /
# broken-promise connection resets)
RETRYABLE_ERRORS = (
    NotCommitted,
    TransactionTooOld,
    FutureVersion,
    CommitUnknownResult,
    TimedOut,
    BrokenPromise,
)


def selector_conflict_range(
    sel: KeySelector, resolved: bytes
) -> tuple[bytes, bytes] | None:
    """The read-conflict range a getKey adds (NativeAPI.actor.cpp
    getKeyAndConflictRange): the span whose contents DETERMINED the
    resolution — any write inside it could move the resolved position.
    Backward selectors depend on [resolved, anchor), forward ones on
    (anchor, resolved]; or_equal widens the anchor side to include the
    anchor key itself.  None when the span is empty."""
    if sel.offset <= 0:
        b, e = resolved, (key_after(sel.key) if sel.or_equal else sel.key)
    else:
        b, e = (key_after(sel.key) if sel.or_equal else sel.key), key_after(resolved)
    return (b, e) if b < e else None


def _intersect_ranges(
    a: list[tuple[bytes, bytes]], b: list[tuple[bytes, bytes]]
) -> tuple[bytes, bytes] | None:
    """First non-empty intersection of any range in `a` with any in `b`."""
    for ab, ae in a:
        for bb, be in b:
            lo, hi = max(ab, bb), min(ae, be)
            if lo < hi:
                return lo, hi
    return None


class ClusterView:
    """The client's window onto the current cluster generation — the
    MonitorLeader/cluster-file analog.  The control plane mutates these
    attributes on recovery; every Transaction reads them per call, so
    clients follow failovers without restarting.

    `grvs`/`commits` hold one ref per proxy; clients spread load across
    them (the reference load-balances MasterProxyInterface the same way)."""

    def __init__(
        self,
        grv_refs: list[RequestStreamRef] | RequestStreamRef | None,
        commit_refs: list[RequestStreamRef] | RequestStreamRef | None,
        storage_map: KeyPartitionMap,  # members: {"getvalue": ref, "getkeyvalues": ref}
        epoch: int = 0,
    ) -> None:
        def as_list(x):
            return x if isinstance(x, list) or x is None else [x]

        self.grvs = as_list(grv_refs)
        self.commits = as_list(commit_refs)
        self.smap = storage_map
        self.epoch = epoch
        # special key space handlers (SpecialKeySpace.actor.cpp): module
        # reads under \xff\xff, e.g. the status-client path.  special_keys
        # answers exact-key gets; special_ranges is [(prefix, handler)] for
        # module RANGE reads (handler() -> [(key, value)] rows)
        self.special_keys: dict[bytes, object] = {}
        self.special_ranges: list[tuple[bytes, object]] = []


class QueueModel:
    """Per-replica latency/penalty model for read load-balancing
    (fdbrpc/QueueModel.h + LoadBalance.actor.h:159): smoothed reply latency
    plus an in-flight count per endpoint; picks the better of two random
    candidates (the reference's alternatives comparison), and a broken
    endpoint carries a decaying penalty so retries steer away from it."""

    def __init__(self, clock) -> None:
        self._clock = clock
        # endpoint key -> [smoothed_latency, inflight, penalty_until, last_t]
        self._stats: dict = {}
        # cluster-wide FailureMonitor (rpc/failmon.py), wired by Database
        # when the view carries one: pick() skips replicas the cluster
        # already knows are down instead of paying a timeout to rediscover
        # it (LoadBalance.actor.h consulting IFailureMonitor::getState)
        self.failmon = None

    def _key(self, ref) -> tuple:
        ep = ref.endpoint
        return (ep.address, ep.token)

    def _entry(self, ref):
        e = self._stats.get(self._key(ref))
        if e is None:
            if len(self._stats) > 4096:
                # endpoints churn with every recovery: drop the stalest
                stale = min(self._stats, key=lambda k: self._stats[k][3])
                del self._stats[stale]
            e = self._stats[self._key(ref)] = [0.001, 0, 0.0, self._clock()]
        return e

    def _score(self, ref) -> float:
        lat, inflight, penalty_until, last_t = self._entry(ref)
        now = self._clock()
        p = 10.0 if now < penalty_until else 0.0
        if now - last_t > 2.0:
            # a losing replica's estimate goes stale (it is never picked,
            # so never refreshed): forget its history so it gets re-probed
            # — the role of the reference LoadBalance's second requests
            lat = 0.001
        return lat * (1 + inflight) + p

    def pick(self, rng, members: list, opkey: str):
        if self.failmon is not None and len(members) > 1:
            live = [
                m for m in members
                if not self.failmon.is_failed(m[opkey].endpoint.address)
            ]
            if live:  # all-failed: fall through and probe anyway
                members = live
        if len(members) == 1:
            return members[0][opkey]
        i = rng.random_int(0, len(members))
        j = (i + 1 + rng.random_int(0, len(members) - 1)) % len(members)
        ra, rb = members[i][opkey], members[j][opkey]
        return ra if self._score(ra) <= self._score(rb) else rb

    def on_start(self, ref) -> None:
        self._entry(ref)[1] += 1

    def on_reply(self, ref, latency: float) -> None:
        e = self._entry(ref)
        e[0] += (latency - e[0]) * 0.2
        e[1] = max(e[1] - 1, 0)
        e[3] = self._clock()

    def on_abandon(self, ref) -> None:
        """Timeout/cancel: no reply was observed — never feed the elapsed
        wait into the latency estimate (it measures the caller, not the
        replica)."""
        self._entry(ref)[1] = max(self._entry(ref)[1] - 1, 0)

    def on_broken(self, ref) -> None:
        e = self._entry(ref)
        e[1] = max(e[1] - 1, 0)
        e[2] = self._clock() + 1.0  # steer away while it is likely dead
        e[3] = self._clock()


class Database:
    def __init__(
        self,
        loop: EventLoop,
        view: ClusterView,
        rng: DeterministicRandom,
        client_knobs=None,
    ) -> None:
        from ..runtime.knobs import ClientKnobs

        self.loop = loop
        self.view = view
        self.knobs = client_knobs or ClientKnobs()
        self._rng = rng.split()
        self._qm = QueueModel(loop.now)
        self._qm.failmon = getattr(view, "failure_monitor", None)
        # fraction of transactions given a pipeline-timeline debug ID
        # (g_traceBatch; the reference samples via CLIENT_KNOBS->
        # *_DEBUG_TRANSACTION_RATE)
        self.debug_sample_rate = 0.0
        # RYW SnapshotCache counters, aggregated across every transaction
        # this handle creates (client/snapshot_cache.py); surfaced in
        # cluster_status and the periodic ClientMetrics trace event
        from .snapshot_cache import CacheStats

        self.cache_stats = CacheStats()
        self._metrics_emitter = None

    def start_metrics(self, trace, interval: float, process=None):
        """Periodic ClientMetrics emission — the client-side slice of the
        `*Metrics` plane (the reference's TransactionMetrics): RYW cache
        hit/miss/insert/eviction rates plus the live cache-byte gauge."""
        from ..runtime.trace import spawn_role_metrics

        if self._metrics_emitter is not None:
            self._metrics_emitter.cancel()

        def fields() -> dict:
            r = self.cache_stats.counters.rates(self.loop.now())
            snap = self.cache_stats.snapshot()
            return {
                "CacheHitsPerSec": r.get("cache_hits", 0.0),
                "CacheMissesPerSec": r.get("cache_misses", 0.0),
                "CacheInsertsPerSec": r.get("cache_inserts", 0.0),
                "CacheEvictionsPerSec": r.get("cache_evictions", 0.0),
                "SelectorReadsPerSec": r.get("selector_reads", 0.0),
                "CacheBytes": snap["bytes"],
                "CachedTransactions": snap["transactions"],
            }

        self._metrics_emitter = spawn_role_metrics(
            self.loop, process, trace, "ClientMetrics", fields, interval,
        )
        return self._metrics_emitter

    @property
    def _grv(self) -> RequestStreamRef:
        return self._rng.random_choice(self.view.grvs)

    @property
    def _commit(self) -> RequestStreamRef:
        return self._rng.random_choice(self.view.commits)

    @property
    def _smap(self) -> KeyPartitionMap:
        return self.view.smap

    def create_transaction(self) -> "Transaction":
        tr = Transaction(self)
        if self.debug_sample_rate > 0 and self._rng.random() < self.debug_sample_rate:
            tr.debug_id = self._rng.random_unique_id()[:12]
            g_trace_batch.add("NativeAPI.createTransaction", tr.debug_id)
        return tr

    def create_ryw_transaction(self):
        """A read-your-writes transaction (the reference's default client
        surface, fdbclient/ReadYourWrites.actor.cpp)."""
        from .ryw import ReadYourWritesTransaction

        return ReadYourWritesTransaction(self)

    async def watch(self, key: bytes):
        """Future resolving when `key`'s value changes from its current
        value (fdbclient watch semantics: register against the storage
        server owning the key)."""
        from ..roles.types import WatchValueRequest

        tr = self.create_transaction()
        current = await tr.get(key, snapshot=True)
        v = await tr.get_read_version()

        async def waiter():
            # loadBalance over the shard's team: a dead replica answers
            # BrokenPromise, so re-register against another one
            while True:
                refs = self._rng.random_choice(self._smap.member_for_key(key))
                try:
                    return await refs["watch"].get_reply(
                        WatchValueRequest(key, current, v)
                    )
                except BrokenPromise:
                    await self.loop.delay(0.05)

        return self.loop.spawn(waiter())

    async def run(self, fn, max_retries: int = 50, ryw: bool = True):
        """Retry loop (fdb.transactional): run fn(tr), commit; on retryable
        errors `tr.on_error` backs off — and for CommitUnknownResult first
        fences the in-flight original with the dummy-transaction dance
        (NativeAPI.actor.cpp:2482-2502) — then the loop starts over with a
        fresh read version.

        The fence only prevents the zombie-commit race (the original landing
        AFTER the retry's reads); a CommitUnknownResult retry can still
        re-apply fn if the original committed — safe only for idempotent or
        self-verifying transactions, the same contract as the reference.

        Transactions are read-your-writes by default (the reference's client
        surface); pass ryw=False for the raw snapshot-read flavor."""
        tr = self.create_ryw_transaction() if ryw else self.create_transaction()
        for _attempt in range(max_retries):
            try:
                result = await fn(tr)
                await tr.commit()
                return result
            except RETRYABLE_ERRORS as e:
                await tr.on_error(e)
        raise NotCommitted(f"transaction failed after {max_retries} retries")


class Transaction:
    def __init__(self, db: Database) -> None:
        self.db = db
        self._read_version: Version | None = None
        # single-flight GRV: concurrent first reads share ONE in-flight
        # fetch (the reference caches a Future<Version>, not a value —
        # NativeAPI's readVersion), or two racing reads could land in
        # different proxy batches and observe DIFFERENT snapshots
        self._grv_fetch = None
        self._mutations: list[Mutation] = []
        self._read_ranges: list[tuple[bytes, bytes]] = []
        self._write_ranges: list[tuple[bytes, bytes]] = []
        self.committed_version: Version | None = None
        self._backoff = db.knobs.DEFAULT_BACKOFF  # carried across resets
        self.debug_id: str | None = None  # set by sampled create_transaction
        self._priority = 1  # TransactionPriority.DEFAULT
        self._causal_write_risky = False
        self._lock_aware = False

    def set_option(self, option: bytes, value: bytes | None = None) -> None:
        """Transaction options (fdb_transaction_set_option; the generated
        surface the reference's vexillographer emits).  Supported:

          priority_batch              yield to other traffic under load
          priority_system_immediate   bypass ratekeeper admission
          causal_write_risky          skip the self-conflict ranges that
                                      make the unknown-result fence certain
                                      (faster commits, weaker retry safety)
          lock_aware                  commit through a locked database
                                      (ManagementAPI lock/unlock)
          debug_transaction_identifier  value = id; join pipeline timelines
        """
        from ..roles.types import PRIORITY_BATCH, PRIORITY_IMMEDIATE

        if option == b"priority_batch":
            self._priority = PRIORITY_BATCH
        elif option == b"priority_system_immediate":
            self._priority = PRIORITY_IMMEDIATE
        elif option == b"causal_write_risky":
            self._causal_write_risky = True
        elif option == b"lock_aware":
            self._lock_aware = True
        elif option == b"debug_transaction_identifier":
            if not value:
                raise ValueError("debug_transaction_identifier needs a value")
            self.debug_id = value.decode()
        else:
            raise ValueError(f"unknown transaction option {option!r}")

    def reset(self) -> None:
        """Clear all transaction state for a retry (fresh read version,
        empty mutation/conflict sets); the retry backoff is preserved."""
        self._read_version = None
        self._grv_fetch = None
        self._mutations = []
        self._read_ranges = []
        self._write_ranges = []
        self.committed_version = None

    async def on_error(self, e: BaseException) -> None:
        """The reference's tr.onError contract (NativeAPI.actor.cpp:2543):
        for a retryable error, back off and reset this transaction so the
        caller can re-run its body.  Non-retryable errors re-raise.

        For CommitUnknownResult the in-flight original commit is first
        FENCED (:2482-2502): commit a dummy transaction whose write set
        intersects this transaction's read conflict ranges.  Once the dummy
        commits, the original — whose read snapshot predates it — can never
        commit afterwards, so the retry cannot race a zombie commit into a
        double-apply.  The intersection always exists because commit()
        makes every transaction self-conflicting when its read and write
        sets are disjoint — UNLESS the causal_write_risky option disabled
        that, in which case the fence is skipped and a retried unknown-
        result commit may double-apply (the option's documented trade)."""
        if not isinstance(e, RETRYABLE_ERRORS):
            raise e
        if isinstance(e, CommitUnknownResult) and self._write_ranges:
            fence = _intersect_ranges(self._write_ranges, self._read_ranges)
            if fence is not None:
                testcov("client.unknown_result_fence")
                await self._commit_fence(fence[0])
        await self.db.loop.delay(self._backoff * (0.5 + self.db._rng.random()))
        self._backoff = min(self._backoff * 2, self.db.knobs.MAX_BACKOFF)
        self.reset()

    async def _commit_fence(self, key: bytes) -> None:
        """Commit a dummy transaction conflicting with the original
        (commitDummyTransaction, NativeAPI.actor.cpp:2380): read+write
        conflict ranges on one key, no mutations.  Retries until it lands;
        a dummy's own unknown result is safe to retry (it is idempotent)."""
        for _ in range(50):
            dummy = self.db.create_transaction()
            # always lock-aware (the reference's commitDummyTransaction sets
            # LOCK_AWARE unconditionally): the fence must land even if the
            # database was locked between the unknown commit and the retry —
            # it writes nothing, it only settles the original's outcome
            dummy._lock_aware = True
            dummy.add_read_conflict_range(key, key_after(key))
            dummy.add_write_conflict_range(key, key_after(key))
            try:
                await dummy.commit()
                return
            except RETRYABLE_ERRORS:
                await self.db.loop.delay(
                    self._backoff * (0.5 + self.db._rng.random())
                )
        raise CommitUnknownResult("fence transaction could not commit")

    async def _reply_rerouted(self, pick_ref, payload, timeout: float | None = None):
        """get_reply with fast re-route: a BrokenPromise (dead endpoint —
        the connection-reset analog) retries immediately against a freshly
        picked ref (the view is re-read, so a recovery's rewire takes
        effect), the reference's loadBalance/alternatives loop.  Only the
        overall deadline surfaces, as TimedOut."""
        loop = self.db.loop
        qm = self.db._qm
        if timeout is None:
            timeout = self.db.knobs.REQUEST_TIMEOUT
        deadline = loop.now() + timeout
        while True:
            remaining = deadline - loop.now()
            if remaining <= 0:
                raise TimedOut(f"timed out after {timeout}s")
            ref = pick_ref()
            qm.on_start(ref)
            t0 = loop.now()
            try:
                reply = await ref.get_reply(payload, timeout=remaining)
                qm.on_reply(ref, loop.now() - t0)
                return reply
            except BrokenPromise:
                qm.on_broken(ref)
                await loop.delay(
                    min(self.db.knobs.REROUTE_DELAY,
                        max(deadline - loop.now(), 0.001))
                )
            except (TimedOut, ActorCancelled):
                qm.on_abandon(ref)  # no reply observed: not a latency sample
                raise
            except Exception:
                qm.on_reply(ref, loop.now() - t0)  # an error IS a reply
                raise

    # -- read version -------------------------------------------------------
    async def _fetch_read_version(self) -> Version:
        g_trace_batch.add(
            "NativeAPI.getConsistentReadVersion.Before", self.debug_id
        )
        reply = await self._reply_rerouted(
            lambda: self.db._grv,
            GetReadVersionRequest(debug_id=self.debug_id,
                                  priority=self._priority),
        )
        g_trace_batch.add(
            "NativeAPI.getConsistentReadVersion.After", self.debug_id
        )
        return reply.version

    async def get_read_version(self) -> Version:
        # take ownership of the fetch BEFORE suspending: two reads racing
        # the first GRV must share ONE request, or they can land in
        # different proxy batches and pin DIFFERENT snapshots to one
        # transaction (flowcheck check-then-act audit; regression-pinned by
        # test_concurrent_first_reads_share_one_read_version).  The leader
        # fetches inline (scheduling-identical to the sequential path);
        # followers await its future.
        while self._read_version is None:
            # flowlint: ok stale-read-across-await (deliberate: the handler inspects the OUTCOME of the very future it awaited, not the current fetch)
            fut = self._grv_fetch
            if fut is not None:
                # follower: share the in-flight fetch.  A LEADER failure is
                # not ours to surface — re-lead a fresh fetch under our own
                # deadline; only our own cancellation propagates.
                try:
                    await fut
                except ActorCancelled:
                    if fut.done() and fut.exception() is not None:
                        continue  # the leader was cancelled: re-lead
                    raise         # we ourselves were cancelled
                except Exception:  # noqa: BLE001 — leader's fetch failed
                    continue      # re-lead (shielded by the handler above)
                continue  # leader filled _read_version
            p = Promise()
            self._grv_fetch = p.future
            try:
                v = await self._fetch_read_version()
            except BaseException as e:
                if self._grv_fetch is p.future:
                    self._grv_fetch = None  # next caller leads a fresh fetch
                p.fail(e)
                raise
            # publish only while still owning the fetch: a reset() during
            # the RPC cleared the slot and a NEW leader may be in flight —
            # stamping the pre-reset version here would pin the RETRIED
            # transaction to a stale snapshot.  Disowned: wake followers
            # and loop — they (and we) follow the new fetch.
            if self._grv_fetch is p.future:
                self._read_version = v
            p.send(v)
        return self._read_version

    # -- reads --------------------------------------------------------------
    async def get(self, key: bytes, snapshot: bool = False) -> bytes | None:
        if key.startswith(b"\xff\xff"):
            # special key space (fdbclient/SpecialKeySpace.actor.cpp): reads
            # under \xff\xff are answered by module handlers, not storage —
            # e.g. \xff\xff/status/json is the status-client fetch path
            handler = self.db.view.special_keys.get(key)
            if handler is not None:
                return handler()
            # range modules answer exact gets too (SpecialKeySpace: a get
            # inside a module's range resolves against its rows)
            for prefix, rh in self.db.view.special_ranges:
                if key.startswith(prefix):
                    for k, v in rh():
                        if k == key:
                            return v
                    return None
            return None
        v = await self.get_read_version()
        # loadBalance (fdbrpc/LoadBalance.actor.h:159): pick a random replica
        # of the shard's team per attempt; _reply_rerouted re-picks on a
        # dead endpoint, so reads fail over to the surviving replicas
        g_trace_batch.add("NativeAPI.getValue.Before", self.debug_id)
        reply = await self._reply_rerouted(
            lambda: self.db._qm.pick(
                self.db._rng, self.db._smap.member_for_key(key), "getvalue"
            ),
            GetValueRequest(key, v, debug_id=self.debug_id),
        )
        g_trace_batch.add("NativeAPI.getValue.After", self.debug_id)
        if not snapshot:
            self._read_ranges.append((key, key_after(key)))
        return reply.value

    # -- key selectors (NativeAPI.actor.cpp getKey) --------------------------
    def _selector_route(self, sel: KeySelector) -> tuple[int, bytes, bytes]:
        """(member index, shard begin, shard end) for one resolution step.
        A backward selector anchored EXACTLY on a shard boundary routes to
        the shard on the LEFT (the reference's Reverse getKeyLocation):
        every key it can resolve to lives there."""
        smap = self.db._smap
        idx = smap.position_for_key(sel.key)
        if sel.is_backward and idx > 0 and sel.key == smap.splits[idx - 1]:
            idx -= 1
        mb = smap.splits[idx - 1] if idx > 0 else b""
        me = smap.splits[idx] if idx < len(smap.splits) else CLIENT_KEYSPACE_END
        return idx, mb, min(me, CLIENT_KEYSPACE_END)

    async def get_key(self, selector: KeySelector, snapshot: bool = False) -> bytes:
        """Resolve a KeySelector to an actual key (fdb_transaction_get_key).
        Resolution happens SERVER-side: each step asks the shard the
        selector currently points into; an offset stepping past the shard
        boundary comes back as an updated selector for the next shard.  A
        position before the first key clamps to b""; past the last user
        key clamps to CLIENT_KEYSPACE_END (b"\\xff") — offset overflow
        yields the boundary, never an error (docs/API.md)."""
        if not isinstance(selector, KeySelector):
            raise TypeError("get_key takes a KeySelector")
        if selector.key.startswith(b"\xff\xff"):
            raise ValueError("key selectors are not supported under \\xff\\xff")
        v = await self.get_read_version()
        sel = selector
        g_trace_batch.add("NativeAPI.getKey.Before", self.debug_id)
        while True:
            # boundary clamps FIRST (the reference's allKeys.begin/end checks)
            if sel.key >= CLIENT_KEYSPACE_END:
                if sel.offset > 0:
                    rep = CLIENT_KEYSPACE_END
                    break
                sel = KeySelector(CLIENT_KEYSPACE_END, False, sel.offset)
            if sel.key == b"" and sel.offset <= 0:
                rep = b""
                break
            idx, mb, me = self._selector_route(sel)
            reply = await self._reply_rerouted(
                lambda idx=idx: self.db._qm.pick(
                    self.db._rng, self.db._smap.members[idx], "getkey"
                ),
                GetKeyRequest(sel, v, mb, me, debug_id=self.debug_id),
            )
            sel = reply.sel
            if sel.is_resolved:
                rep = sel.key
                break
        g_trace_batch.add("NativeAPI.getKey.After", self.debug_id)
        if not snapshot:
            cr = selector_conflict_range(selector, rep)
            if cr is not None:
                self._read_ranges.append(cr)
        return rep

    async def get_range(
        self,
        begin: bytes | KeySelector,
        end: bytes | KeySelector,
        limit: int = 10000,
        snapshot: bool = False,
    ) -> list[tuple[bytes, bytes]]:
        if isinstance(begin, KeySelector) or isinstance(end, KeySelector):
            # selector endpoints resolve server-side first (each adds its
            # own narrow resolution conflict range); the data read then
            # proceeds over the resolved window
            b = begin if isinstance(begin, bytes) else await self.get_key(
                begin, snapshot=snapshot
            )
            e = end if isinstance(end, bytes) else await self.get_key(
                end, snapshot=snapshot
            )
            if b >= e:
                return []
            return await self.get_range(b, e, limit=limit, snapshot=snapshot)
        if begin.startswith(b"\xff\xff"):
            # special-key-space MODULE range read (SpecialKeySpace.actor.cpp:
            # `\xff\xff/<module>/...` ranges answered by handlers, not
            # storage — e.g. \xff\xff/keyservers/, \xff\xff/excluded/)
            out = []
            for prefix, handler in self.db.view.special_ranges:
                if begin < prefix + b"\xff" and prefix < end:
                    out.extend(
                        (k, v) for k, v in handler()
                        if begin <= k < end
                    )
            return sorted(out)[:limit]
        v = await self.get_read_version()
        out: list[tuple[bytes, bytes]] = []
        smap = self.db._smap
        # walk shards left to right (the client iterates locations :1228)
        for idx in range(len(smap.members)):
            clip = smap.clip_to_member(idx, begin, end)
            if clip is None:
                continue
            b, e = clip
            reply = await self._reply_rerouted(
                lambda idx=idx: self.db._qm.pick(
                    self.db._rng, self.db._smap.members[idx], "getkeyvalues"
                ),
                GetKeyValuesRequest(b, e, v, limit - len(out)),
            )
            out.extend(reply.data)
            if len(out) >= limit:
                break
        if not snapshot:
            self._read_ranges.append((begin, end))
        return out[:limit]

    # -- writes -------------------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        self._mutations.append(Mutation(MutationType.SET_VALUE, key, value))
        self._write_ranges.append((key, key_after(key)))

    def clear(self, key: bytes) -> None:
        self.clear_range(key, key_after(key))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._mutations.append(Mutation(MutationType.CLEAR_RANGE, begin, end))
        self._write_ranges.append((begin, end))

    def atomic_op(self, op: MutationType, key: bytes, operand: bytes) -> None:
        # versionstamped placeholders are validated HERE, at the API
        # boundary: the proxy must never see a malformed offset it would
        # have to fail mid-batch (it still guards, defense in depth)
        if op == MutationType.SET_VERSIONSTAMPED_KEY:
            from ..roles.types import VERSIONSTAMP_LEN

            off = int.from_bytes(key[-4:], "little")
            if len(key) < 14 or off + VERSIONSTAMP_LEN > len(key) - 4:
                raise ValueError(f"versionstamp offset {off} out of range")
        elif op == MutationType.SET_VERSIONSTAMPED_VALUE:
            from ..roles.types import VERSIONSTAMP_LEN

            off = int.from_bytes(operand[-4:], "little")
            if len(operand) < 14 or off + VERSIONSTAMP_LEN > len(operand) - 4:
                raise ValueError(f"versionstamp offset {off} out of range")
        self._mutations.append(Mutation(op, key, operand))
        self._write_ranges.append((key, key_after(key)))

    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._read_ranges.append((begin, end))

    def add_write_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._write_ranges.append((begin, end))

    # -- commit -------------------------------------------------------------
    async def commit(self) -> Version:
        if not self._mutations and not self._write_ranges:
            self.committed_version = self._read_version or 0
            return self.committed_version  # read-only: nothing to commit
        v = await self.get_read_version()
        if (
            not self._causal_write_risky
            and _intersect_ranges(self._write_ranges, self._read_ranges) is None
        ):
            # make the transaction self-conflicting (the reference's
            # makeSelfConflicting under !causalWriteRisky): gives on_error's
            # unknown-result fence a range that aborts the in-flight
            # original for certain.  A unique key adds no spurious
            # conflicts with other transactions.
            sc = b"\xff/SC/" + self.db._rng.random_unique_id().encode()
            self._read_ranges.append((sc, key_after(sc)))
            self._write_ranges.append((sc, key_after(sc)))
        req = CommitTransactionRequest(
            read_snapshot=v,
            read_conflict_ranges=list(self._read_ranges),
            write_conflict_ranges=list(self._write_ranges),
            mutations=list(self._mutations),
            debug_id=self.debug_id,
            lock_aware=self._lock_aware,
        )
        g_trace_batch.add("NativeAPI.commit.Before", self.debug_id)
        try:
            reply: CommitReply = await self.db._commit.get_reply(
                req, timeout=self.db.knobs.COMMIT_TIMEOUT
            )
            g_trace_batch.add("NativeAPI.commit.After", self.debug_id)
        except TimedOut:
            # proxy unreachable: the commit may have happened
            raise CommitUnknownResult()
        except BrokenPromise:
            # the request was never delivered (proxy dead/stream closed
            # before delivery): the commit definitely did not start, so a
            # plain retry is safe — no fence needed
            raise NotCommitted()
        if reply.result == CommitResult.COMMITTED:
            self.committed_version = reply.version
            return reply.version
        if reply.result == CommitResult.TRANSACTION_TOO_OLD:
            raise TransactionTooOld()
        if reply.result == CommitResult.UNKNOWN:
            raise CommitUnknownResult()
        if reply.result == CommitResult.DATABASE_LOCKED:
            from ..roles.types import DatabaseLocked

            raise DatabaseLocked()  # not retryable: on_error re-raises
        raise NotCommitted()
