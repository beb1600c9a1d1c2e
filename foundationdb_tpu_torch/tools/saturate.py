"""Saturation harness — ramp offered load until ratekeeper engages and
record where the cluster's ceiling is, and why (the measured half of the
"production scale" claim: ReadWrite.actor.cpp-grade load against the ssd
engine, with the PR's file-level page cache on or off).

Per curve (cache on / cache off) the driver:

  1. boots a durable ssd-engine cluster, preloads a keyspace, waits for
     storage durability, then POWER-KILLS and reboots from the disks —
     so phase 2 starts with every cache (parsed pages, file pages) cold;
  2. runs a COLD full-range scan and records the pread-count proxy
     (simulated disk reads are instant, so wall time can't see the
     cache — the disk-op count is the honest measurable) plus the
     page-cache hit/read-ahead counters;
  3. ramps offered load step by step (open-loop: transactions start on a
     fixed cadence regardless of completions, bounded by an outstanding
     cap), recording per step the achieved commit rate, driver-side
     latency percentiles, the proxies' LatencyBands commit/GRV band
     deltas, ratekeeper's budget/limit reason, and the page-cache
     counter deltas — until ratekeeper's limit engages (the knee) or the
     steps run out.

The artifact (BENCH_SAT_*.json) carries both curves plus the knob
overrides that shaped the run: the storage queue spring is deliberately
tightened (TARGET_STORAGE_QUEUE_BYTES et al) so the knee lands at a
simulable rate — the SHAPE of the curve and the limiting reason are the
claim, not the absolute tps.

`--mode hot` is the load-metric plane's proof harness instead: the same
open-loop ramp, but key choice is zipf-skewed WITHOUT rank scattering so
the hot keys pile into ONE shard, and the two curves are data
distribution ON vs FROZEN (dd.frozen — the `datadistribution off`
analog) on the same seed.  With DD frozen the hot team's storage queue
is the knee; with DD on, sampled-bandwidth splits and hot-shard
relocations spread the hot range across teams and the knee moves right.
The artifact (BENCH_SAT_r02.json) records both curves plus the per-step
DD counters (splits, hot relocations, shard count) and ratekeeper's
hot-range attribution.

Usage:
    python -m foundationdb_tpu_torch.tools.saturate --out sat.json \
        [--steps 25,50,100,200,400] [--step-duration 4] [--keys 4000] \
        [--seed 11] [--device cuda|cpu]
    python -m foundationdb_tpu_torch.tools.saturate --mode hot \
        --out sat_hot.json

Copy of the reference package's module, on the port's own modules: every
cluster it boots is the port's RecoverableCluster on `device` (default
cuda; `--device`), whose resolvers host the port's DeviceConflictSet, so
the ladder's commits are checked on the card.  Without a card the first
boot raises.  The curves are the reference's, row for row: the conflict
sets' verdicts equal the reference's oracle's, so the simulation is the
same.
"""

from __future__ import annotations

import argparse
import json
import sys

# knob overrides shared by both curves: tighten the storage queue spring
# so the knee lands at a Python-simulable offered rate, and shrink the
# parsed-page cache so reads really reach the file layer
_KNOBS_COMMON = {
    "TARGET_STORAGE_QUEUE_BYTES": 1 << 15,
    "STORAGE_HARD_LIMIT_BYTES": 1 << 17,
    "BTREE_CACHE_BYTES": 1 << 15,
}

# hot-shard mode overrides (on top of _KNOBS_COMMON): thresholds scaled
# down so sampled-bandwidth splits and hot-shard detection fire at
# Python-simulable rates, merges disabled so the harness never un-splits
# what it is trying to measure
_KNOBS_HOT = {
    **_KNOBS_COMMON,
    "DD_SHARD_SPLIT_BYTES": 1 << 19,
    "DD_SHARD_SPLIT_WRITE_BYTES_PER_SEC": 1 << 14,
    "DD_SHARD_MERGE_BYTES": 0,
    "DD_HOT_SHARD_BYTES_PER_KSEC": 4_000_000,
}

_VALUE_BYTES = 128


def _key(i: int) -> bytes:
    return b"sat/%06d" % i


def _pct(xs: list[float], p: float) -> float:
    from ..workloads.readwrite import percentile

    return percentile(sorted(xs), p)


def _page_cache_totals(cluster) -> dict:
    tot = {"hits": 0, "misses": 0, "readahead_pages": 0, "readahead_hits": 0,
           "parsed_hits": 0, "parsed_misses": 0}
    for ss in cluster.storage:
        pcs = getattr(ss.store, "page_cache_stats", None)
        if pcs is None:
            continue
        s = pcs()
        for k in tot:
            tot[k] += s.get(k, 0)
    return tot


def _disk_read_ops(cluster) -> int:
    """preads on the STORAGE stores' disks (`ss*` paths) — the dedicated
    reads gauge, so recovery-era appends/fsyncs on the same disks never
    pollute the cold-read proxy."""
    return sum(
        d["reads"] for p, d in cluster.fs.disk_usage().items()
        if p.startswith("ss")
    )


def _boot(seed: int, cache_on: bool, fs=None, restart: bool = False,
          device="cuda"):
    from ..control.recoverable import RecoverableCluster

    overrides = dict(_KNOBS_COMMON)
    if not cache_on:
        overrides["PAGE_CACHE_BYTES"] = 0
    return RecoverableCluster(
        seed=seed, n_storage_shards=2, storage_replication=2,
        storage_engine="ssd", fs=fs, restart=restart,
        knob_overrides=overrides, device=device,
    )


def _preload(cluster, keys: int) -> None:
    db = cluster.database()

    async def fill():
        val = b"x" * _VALUE_BYTES
        for lo in range(0, keys, 400):
            tr = db.create_transaction()
            for i in range(lo, min(lo + 400, keys)):
                tr.set(_key(i), val)
            await tr.commit()
        # let storage durability cross the MVCC window so the reboot's
        # disks hold the whole dataset
        await cluster.loop.delay(12.0)

    cluster.run_until(cluster.loop.spawn(fill()), 600.0)


def _cold_scan(cluster, keys: int) -> dict:
    """Full-range scan against cold caches: the pread-count proxy for the
    cold-range-read wall, plus the page-cache counters it populated."""
    db = cluster.database()
    ops0 = _disk_read_ops(cluster)
    t0 = cluster.loop.now()

    async def scan():
        async def fn(tr):
            return await tr.get_range(b"sat/", b"sat0", limit=keys + 10)

        return await db.run(fn)

    rows = cluster.run_until(cluster.loop.spawn(scan()), 600.0)
    pc = _page_cache_totals(cluster)
    return {
        "rows": len(rows),
        "disk_read_ops": _disk_read_ops(cluster) - ops0,
        "sim_seconds": round(cluster.loop.now() - t0, 4),
        "page_cache": pc,
    }


def _band_delta(now: dict, before: dict) -> dict:
    return {k: now.get(k, 0) - before.get(k, 0) for k in now}


def _run_step(cluster, offered_tps: float, duration: float, keys: int,
              rng, pick=None) -> dict:
    """One open-loop load step: start a transaction every 1/offered_tps
    sim seconds (regardless of completions, outstanding capped), measure
    what actually commits and at what latency.  `pick(crng) -> key index`
    overrides the uniform key choice (the hot-shard mode's zipf)."""
    from ..client.transaction import RETRYABLE_ERRORS
    from ..control.status import cluster_status
    from ..runtime.core import ActorCancelled

    db = cluster.database()
    loop = cluster.loop
    stats = {"started": 0, "committed": 0, "errors": 0, "shed": 0}
    commit_lat: list[float] = []
    grv_lat: list[float] = []
    outstanding = [0]
    cap = max(int(offered_tps), 64)  # ~1s of backlog before the driver sheds

    doc0 = cluster_status(cluster)
    bands0 = {
        "commit": dict(doc0["latency_bands"]["commit"]["bands"]),
        "grv": dict(doc0["latency_bands"]["grv"]["bands"]),
    }
    pc0 = _page_cache_totals(cluster)

    def choose(crng) -> int:
        return pick(crng) if pick is not None else crng.random_int(0, keys)

    async def one_txn(crng):
        outstanding[0] += 1
        try:
            tr = db.create_transaction()
            for attempt in range(8):
                try:
                    t0 = loop.now()
                    await tr.get_read_version()
                    grv_lat.append(loop.now() - t0)
                    for _ in range(3):
                        await tr.get(_key(choose(crng)))
                    tr.set(_key(choose(crng)),
                           b"y" * _VALUE_BYTES)
                    t0 = loop.now()
                    await tr.commit()
                    commit_lat.append(loop.now() - t0)
                    stats["committed"] += 1
                    return
                except RETRYABLE_ERRORS as e:
                    await tr.on_error(e)
            stats["errors"] += 1
        except ActorCancelled:
            raise
        except Exception:  # noqa: BLE001 — overload shapes vary; count them
            stats["errors"] += 1
        finally:
            outstanding[0] -= 1

    async def generator():
        t_end = loop.now() + duration
        interval = 1.0 / offered_tps
        nxt = loop.now()
        while loop.now() < t_end:
            if outstanding[0] < cap:
                stats["started"] += 1
                loop.spawn(one_txn(rng.split()))
            else:
                stats["shed"] += 1
            nxt += interval
            await loop.delay(max(nxt - loop.now(), 0.0))
        # drain grace so in-flight commits land in this step's counters
        t_drain = loop.now() + 2.0
        while outstanding[0] > 0 and loop.now() < t_drain:
            await loop.delay(0.05)

    t0 = loop.now()
    cluster.run_until(loop.spawn(generator()), 3600.0)
    elapsed = max(loop.now() - t0, 1e-9)

    doc = cluster_status(cluster)
    rk = doc.get("ratekeeper", {})
    pc1 = _page_cache_totals(cluster)
    return {
        "offered_tps": offered_tps,
        "achieved_tps": round(stats["committed"] / elapsed, 1),
        **stats,
        "commit_p50_ms": round(_pct(commit_lat, 0.5) * 1e3, 3),
        "commit_p95_ms": round(_pct(commit_lat, 0.95) * 1e3, 3),
        "commit_p99_ms": round(_pct(commit_lat, 0.99) * 1e3, 3),
        "grv_p99_ms": round(_pct(grv_lat, 0.99) * 1e3, 3),
        "latency_bands": {
            "commit": _band_delta(
                doc["latency_bands"]["commit"]["bands"], bands0["commit"]
            ),
            "grv": _band_delta(
                doc["latency_bands"]["grv"]["bands"], bands0["grv"]
            ),
        },
        "ratekeeper": {
            "tps_budget": round(rk.get("tps_budget", 0.0), 1),
            "limit_reason": rk.get("limit_reason", "?"),
            "limiting_server": rk.get("limiting_server"),
            # the load-metric plane's attribution: WHICH range was hot
            "limiting_shard": rk.get("limiting_shard"),
            "e_brake": rk.get("e_brake", False),
        },
        "data_distribution": doc["cluster"].get("data_distribution"),
        "page_cache_delta": {k: pc1[k] - pc0[k] for k in pc1},
    }


def run_curve(cache_on: bool, steps: list[float], step_duration: float,
              keys: int, seed: int, device="cuda") -> dict:
    """One full saturation curve: preload → power-kill reboot → cold scan
    → ramp until ratekeeper's limit engages."""
    from ..runtime.core import DeterministicRandom

    c = _boot(seed, cache_on, device=device)
    _preload(c, keys)
    ops_pre = _disk_read_ops(c)  # DiskState survives the power-kill
    fs = c.power_off()
    c = _boot(seed + 1, cache_on, fs=fs, restart=True, device=device)
    # disk reads the REBOOT itself paid (recovery's directory load —
    # with the cache on, its read-ahead batches prefetch the tree, so
    # the later "cold" scan may already be pool-warm; the boot+cold SUM
    # is the honest cross-mode comparison)
    boot_ops = _disk_read_ops(c) - ops_pre
    cold = _cold_scan(c, keys)
    warm = _cold_scan(c, keys)  # the same scan again: the cache-hit twin

    rng = DeterministicRandom(seed + 7)
    curve: list[dict] = []
    knee = None
    for tps in steps:
        row = _run_step(c, tps, step_duration, keys, rng)
        curve.append(row)
        print(
            f"[saturate] cache={'on' if cache_on else 'off'} "
            f"offered={tps} achieved={row['achieved_tps']} "
            f"reason={row['ratekeeper']['limit_reason']} "
            f"p99={row['commit_p99_ms']}ms",
            file=sys.stderr,
        )
        if knee is None and (
            row["ratekeeper"]["limit_reason"] != "unlimited"
            or row["achieved_tps"] < 0.8 * tps
        ):
            knee = row
    c.stop()
    return {
        "cache": "on" if cache_on else "off",
        "boot_disk_ops": boot_ops,
        "boot_plus_cold_ops": boot_ops + cold["disk_read_ops"],
        "cold_scan": cold,
        "warm_scan": warm,
        "steps": curve,
        "knee": {
            "offered_tps": knee["offered_tps"],
            "achieved_tps": knee["achieved_tps"],
            "limit_reason": knee["ratekeeper"]["limit_reason"],
            "limiting_server": knee["ratekeeper"]["limiting_server"],
        } if knee is not None else None,
    }


def _zipf_pick(keys: int, skew: float):
    """Unscattered zipf picker: hot ranks stay CONTIGUOUS at the bottom
    of the keyspace, so the skewed load lands in one shard — the input
    the load-metric plane exists to detect."""
    import bisect

    w = [(i + 1) ** -skew for i in range(keys)]
    total = sum(w)
    cdf, acc = [], 0.0
    for x in w:
        acc += x / total
        cdf.append(acc)

    def pick(crng) -> int:
        return min(bisect.bisect_left(cdf, crng.random()), keys - 1)

    return pick


def run_hot_curve(dd_on: bool, steps: list[float], step_duration: float,
                  keys: int, seed: int, skew: float, device="cuda") -> dict:
    """One hot-shard curve: preload a uniform keyspace, then ramp
    zipf-hot (unscattered) load with data distribution either live or
    FROZEN — the same seed both ways, so the only difference is whether
    the sampled metric plane gets to move data."""
    from ..control.recoverable import RecoverableCluster
    from ..control.status import cluster_status
    from ..runtime.core import DeterministicRandom

    c = RecoverableCluster(
        seed=seed, n_storage_shards=2, storage_replication=2,
        storage_engine="ssd", knob_overrides=dict(_KNOBS_HOT), device=device,
    )
    c.dd.frozen = not dd_on
    _preload(c, keys)

    rng = DeterministicRandom(seed + 7)
    pick = _zipf_pick(keys, skew)
    curve: list[dict] = []
    knee = None
    for tps in steps:
        row = _run_step(c, tps, step_duration, keys, rng, pick=pick)
        curve.append(row)
        dd = row.get("data_distribution") or {}
        print(
            f"[saturate] dd={'on' if dd_on else 'frozen'} "
            f"offered={tps} achieved={row['achieved_tps']} "
            f"reason={row['ratekeeper']['limit_reason']} "
            f"shard={row['ratekeeper']['limiting_shard']} "
            f"splits={dd.get('shard_splits')} "
            f"hot_moves={dd.get('hot_relocations')}",
            file=sys.stderr,
        )
        if knee is None and (
            row["ratekeeper"]["limit_reason"] != "unlimited"
            or row["achieved_tps"] < 0.8 * tps
        ):
            knee = row
    doc = cluster_status(c)
    data = doc["cluster"].get("data", {})
    ddb = doc["cluster"].get("data_distribution", {})
    c.stop()
    return {
        "dd": "on" if dd_on else "frozen",
        "skew": skew,
        "steps": curve,
        "final": {
            "shard_count": data.get("shard_count"),
            "shard_splits": ddb.get("shard_splits"),
            "shard_merges": ddb.get("shard_merges"),
            "hot_relocations": ddb.get("hot_relocations"),
            "hot_shards": data.get("hot_shards"),
        },
        "knee": {
            "offered_tps": knee["offered_tps"],
            "achieved_tps": knee["achieved_tps"],
            "limit_reason": knee["ratekeeper"]["limit_reason"],
            "limiting_server": knee["ratekeeper"]["limiting_server"],
            "limiting_shard": knee["ratekeeper"]["limiting_shard"],
        } if knee is not None else None,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", default="25,50,100,200,400",
                    help="comma-separated offered tps per step")
    ap.add_argument("--step-duration", type=float, default=4.0,
                    help="sim seconds per load step")
    ap.add_argument("--keys", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", default="sat.json")
    ap.add_argument("--cache", choices=("both", "on", "off"), default="both")
    ap.add_argument("--mode", choices=("cache", "hot"), default="cache",
                    help="cache: page-cache on/off curves (r01); hot: "
                         "zipf-hot ramp with DD on vs frozen (r02)")
    ap.add_argument("--skew", type=float, default=1.2,
                    help="zipf exponent for --mode hot key choice")
    ap.add_argument("--device", default="cuda",
                    help="device of the resolvers' conflict sets (cuda or cpu)")
    args = ap.parse_args(argv)

    steps = [float(s) for s in args.steps.split(",") if s]
    curves = []
    if args.mode == "hot":
        for dd_on in (False, True):
            curves.append(run_hot_curve(dd_on, steps, args.step_duration,
                                        args.keys, args.seed, args.skew,
                                        device=args.device))
    else:
        if args.cache in ("both", "on"):
            curves.append(run_curve(True, steps, args.step_duration,
                                    args.keys, args.seed, device=args.device))
        if args.cache in ("both", "off"):
            curves.append(run_curve(False, steps, args.step_duration,
                                    args.keys, args.seed, device=args.device))

    doc = {
        "metric": ("hot_shard_saturation" if args.mode == "hot"
                   else "saturation_curve"),
        "engine": "ssd",
        "keys": args.keys,
        "value_bytes": _VALUE_BYTES,
        "seed": args.seed,
        "device": args.device,
        "step_duration_s": args.step_duration,
        "knob_overrides": (_KNOBS_HOT if args.mode == "hot"
                           else _KNOBS_COMMON),
        "curves": curves,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"[saturate] wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
