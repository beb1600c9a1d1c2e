"""Production server entrypoint — the `fdbserver` main analog
(fdbserver/fdbserver.actor.cpp main; flow/Net2 run loop).

    python -m foundationdb_tpu_torch.tools.server [--port P] [--shards N]
           [--replication R] [--engine memory|ssd] [--workers W]
           [--trace-file PATH] [--device cuda|cpu]

Boots a complete cluster (coordinators, worker-recruited write pipeline,
replicated storage, data distribution, ratekeeper) in this OS process,
anchored to the WALL clock, and serves the client gateway protocol on
--port (the C ABI / bindings surface, tools/gateway.py).  The fdbcli
shell and any FFI client connect to that port.

One process hosts the whole simulation-grade cluster: the deterministic
runtime is the same, only the clock driver differs (the Net2/Sim2 seam).
Multi-OS-process deployment rides rpc/transport.py's real TCP fabric.

Copy of the reference package's module, on the port's own modules, with
two flags of its own: `--device` (default cuda) is the device of every
resolver's conflict set (the port's DeviceConflictSet, RecoverableCluster's
default backend), so the served cluster checks conflicts on the card.
Without a card the server exits with the cluster's error before it serves;
`--device cpu` runs the same sets on the CPU.  `--protocol-version` is the
wire version its coordinator transport announces at hello (RealNetwork's
`protocol_version=`; the reference reads an environment variable)."""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--engine", choices=("memory", "ssd"), default="ssd")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--protocol-version", default=None,
                    help="wire protocol version announced at hello to the "
                         "coordinators (default: this build's)")
    ap.add_argument("--device", default="cuda",
                    help="device of the resolvers' conflict sets (cuda, a "
                         "cuda:N, or cpu)")
    ap.add_argument("--trace-file", default=None,
                    help="base path for ROLLING per-process trace files "
                         "(<path>.<seq>.jsonl — the reference's rolling "
                         "trace files); events stream line-buffered so a "
                         "crash loses at most one line")
    ap.add_argument("--trace-roll-size", type=int, default=None,
                    help="bytes per trace file before rolling "
                         "(TRACE_ROLL_SIZE knob; --maxlogssize analog)")
    ap.add_argument("--trace-max-logs", type=int, default=None,
                    help="rolled generations kept (TRACE_MAX_LOGS knob)")
    ap.add_argument("--trace-severity", type=int, default=None,
                    help="drop trace events below this severity "
                         "(TRACE_SEVERITY knob)")
    ap.add_argument("--metrics-interval", type=float, default=None,
                    help="seconds between per-role *Metrics trace events "
                         "(METRICS_INTERVAL knob)")
    ap.add_argument("--timeline-file", default=None,
                    help="scrape endpoint for sampled-transaction pipeline "
                         "timelines: rewrite this file with the "
                         "tools/timeline.py JSON dump every "
                         "--timeline-interval seconds (clients can also "
                         "read the \\xff\\xff/timeline/json special key)")
    ap.add_argument("--timeline-interval", type=float, default=5.0)
    ap.add_argument("--sample-rate", type=float, default=0.0,
                    help="fraction of gateway transactions given a debug ID "
                         "(feeds the timeline scrape)")
    ap.add_argument("--cluster-file", default=None,
                    help="fdb.cluster naming REMOTE coordinator processes "
                         "(tools/coordserver.py); the recovery state lives "
                         "on that quorum and the gateway address is "
                         "published to it for client discovery")
    ap.add_argument("--run-seconds", type=float, default=None,
                    help="exit after N wall seconds (default: run forever)")
    ap.add_argument("--ready-file", default=None,
                    help="path written (atomically) once the cluster is "
                         "accepting commits and the gateway port is open — "
                         "the supervisor's readiness probe (fdbmonitor "
                         "waits on it before counting a bounce complete); "
                         "removed again on shutdown")
    ap.add_argument("--image-dir", default=None,
                    help="durable restart image directory: boot FROM it when "
                         "it holds a complete image (refusing a config "
                         "mismatch), and save a fresh image on clean "
                         "shutdown (SIGTERM / --run-seconds expiry) — the "
                         "rolling-bounce persistence seam: acked commits "
                         "survive the process")
    args = ap.parse_args(argv)

    # SIGTERM is the supervisor's clean-shutdown request (fdbmonitor's
    # kill path): the serving loop ends at the end of its turn and the same
    # unwind as Ctrl-C follows, so trace sinks flush, sockets close and the
    # restart image (if any) is saved before exit.  (Raising from the
    # handler, as the reference does, loses the request whenever the
    # signal lands inside a task's step: the task keeps the exception as
    # its error and the server serves on.)
    stop_requested: list[int] = []
    signal.signal(signal.SIGTERM, lambda _signo, _frame: stop_requested.append(_signo))

    from ..control.recoverable import RecoverableCluster
    from ..runtime.knobs import CoreKnobs
    from ..runtime.trace import TraceFileSink
    from .gateway import ClientGateway, GatewayDriver

    knobs = CoreKnobs()
    if args.trace_roll_size is not None:
        knobs.TRACE_ROLL_SIZE = args.trace_roll_size
    if args.trace_max_logs is not None:
        knobs.TRACE_MAX_LOGS = args.trace_max_logs
    if args.trace_severity is not None:
        knobs.TRACE_SEVERITY = args.trace_severity
    if args.metrics_interval is not None:
        knobs.METRICS_INTERVAL = args.metrics_interval
    sink = (
        TraceFileSink(args.trace_file, roll_size=knobs.TRACE_ROLL_SIZE,
                      max_logs=knobs.TRACE_MAX_LOGS)
        if args.trace_file else None
    )
    rnet = None
    extra = {}
    leader_cs = None
    if args.cluster_file:
        # multi-OS-process deployment: the cstate quorum is remote, reached
        # over the real TCP fabric sharing the cluster's event loop
        from ..client.cluster_file import (
            cstate_refs,
            leader_refs,
            parse_cluster_file,
        )
        from ..control.coordination import CoordinatedState
        from ..rpc.transport import NetDriver, RealNetwork
        from ..runtime.core import EventLoop

        loop = EventLoop()
        rnet = RealNetwork(loop, name=f"server-{args.seed}",
                           protocol_version=args.protocol_version)
        _desc, coords = parse_cluster_file(args.cluster_file)
        cstate = CoordinatedState(
            loop,
            cstate_refs(rnet, rnet.process, coords),
            cstate_refs(rnet, rnet.process, coords, write=True),
            owner=f"server-{rnet.address.port}",
        )
        leader_cs = CoordinatedState(
            loop,
            leader_refs(rnet, rnet.process, coords),
            leader_refs(rnet, rnet.process, coords, write=True),
            owner=f"server-{rnet.address.port}",
        )
        extra = dict(
            loop=loop,
            external_cstate=cstate,
            wall_driver=NetDriver(loop, rnet),
        )
    # the restart manifest doubles as the config check: a bounce that
    # changes the cluster shape must not silently reinterpret old disks
    config = dict(
        seed=args.seed, shards=args.shards, replication=args.replication,
        engine=args.engine, workers=args.workers,
    )
    if args.image_dir and os.path.exists(
        os.path.join(args.image_dir, "manifest.json")
    ):
        from ..storage.image import load_image, restore_filesystem

        files, manifest = load_image(args.image_dir)
        for k, v in config.items():
            if manifest.get("config", {}).get(k) != v:
                raise SystemExit(
                    f"restart image {args.image_dir} was saved with "
                    f"{k}={manifest.get('config', {}).get(k)!r}, "
                    f"this process wants {v!r} — refusing to boot"
                )
        extra["fs"] = restore_filesystem(files)
        extra["restart"] = True
    cluster = RecoverableCluster(
        seed=args.seed,
        n_storage_shards=args.shards,
        storage_replication=args.replication,
        storage_engine=args.engine,
        n_workers=args.workers,
        trace_sink=sink,
        # a real process stamps trace WallTime from the HOST wall: clients
        # and coordservers join this server's trace files on that clock
        trace_wall_clock=time.time,  # flowlint: ok wall-clock (cross-process trace joins share the host wall)
        knobs=knobs,
        device=args.device,
        **extra,
    )
    if rnet is not None:
        # wire-level errors (rejected/undecodable frames) land in the
        # cluster's trace stream; the collector only exists post-assembly,
        # and the transport reads the attribute at event time
        rnet.trace = cluster.trace
        # the REAL transport's WireStats deltas join the metrics plane too
        from ..runtime.trace import spawn_wire_metrics

        spawn_wire_metrics(
            cluster.loop, cluster.trace, rnet.wire,
            knobs.METRICS_INTERVAL, "tcp",
        )
    db = cluster.database()
    if args.sample_rate > 0:
        db.debug_sample_rate = args.sample_rate
    gw = ClientGateway(cluster.loop, db, port=args.port, trace=cluster.trace)
    # host attribution for cross-process trace joins (trace_tool)
    cluster.trace.machine = f"server:{gw.port}"
    if args.timeline_file:
        # the ops scrape surface: atomically rewrite the dump on a cadence
        # so a file-watching collector always reads a complete document
        import json as _json
        import os as _os

        from .timeline import timeline_dump

        async def dump_timelines() -> None:
            while True:
                await cluster.loop.delay(args.timeline_interval)
                tmp = args.timeline_file + ".tmp"
                try:
                    with open(tmp, "w") as f:
                        _json.dump(timeline_dump(), f, default=str)
                    _os.replace(tmp, args.timeline_file)
                except OSError:
                    pass  # a full disk must not kill the server

        cluster.loop.spawn(dump_timelines())
    driver = GatewayDriver(
        cluster.loop, gw,
        extra_pump=rnet.pump if rnet is not None else None,
    )
    if leader_cs is not None:
        # publish the gateway address for client discovery, and RE-ASSERT
        # it periodically (MonitorLeader semantics): a conditional-write
        # rejection (a client's read bumped the promised generation first)
        # retries with a higher generation, and restarted in-memory
        # coordinator registers re-learn the address within one period
        async def publish_once() -> None:
            for _ in range(50):
                if await leader_cs.write({"gateway": f"127.0.0.1:{gw.port}"}):
                    return
            raise RuntimeError("could not publish gateway to coordinators")

        async def reassert() -> None:
            from ..runtime.core import ActorCancelled

            while True:
                await cluster.loop.delay(2.0)
                try:
                    await publish_once()
                except ActorCancelled:
                    raise  # server shutdown: stop re-asserting leadership
                except Exception:  # noqa: BLE001 — quorum down: next period
                    pass

        driver.run_until(cluster.loop.spawn(publish_once()), wall_timeout=30.0)
        cluster.loop.spawn(reassert())
    print(f"fdbtpu server ready on 127.0.0.1:{gw.port}", flush=True)
    if args.ready_file and cluster.ready():
        # atomic: a supervisor polling the path never reads a torn file,
        # and the payload is the discovery hint (the gateway address)
        tmp = args.ready_file + f".{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(f"127.0.0.1:{gw.port}\n")
        os.replace(tmp, args.ready_file)
    try:
        if not stop_requested:
            driver.serve_forever(wall_timeout=args.run_seconds,
                                 stop=lambda: bool(stop_requested))
    except KeyboardInterrupt:
        pass
    finally:
        if args.ready_file:
            try:
                os.unlink(args.ready_file)
            except OSError:
                pass
        gw.close()
        if args.image_dir:
            # clean shutdown = flush everything durable, power off, save
            # the restart image the NEXT process lifetime boots from —
            # this is what makes a SIGTERM bounce lose zero acked commits
            from ..storage.image import save_image

            fs = cluster.clean_shutdown()
            save_image(fs, args.image_dir, {"config": config})
        cluster.stop()
        if rnet is not None:
            rnet.close()
        if sink:
            sink.close()
        print("fdbtpu server stopped", file=sys.stderr)


if __name__ == "__main__":
    main()
