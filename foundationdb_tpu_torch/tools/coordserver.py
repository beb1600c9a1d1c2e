"""Standalone coordinator — one OS process serving the cluster's generation
registers over real TCP (the coordinator slot of `fdbserver` when its
address is listed in the cluster file; fdbserver/Coordination.actor.cpp
coordinationServer).

    python -m foundationdb_tpu_torch.tools.coordserver [--port P]

Serves TWO registers, exactly like the reference's coordination server:

  * the CLUSTER STATE register (recovery generations — CoordinatedState)
    on the default `wlt:coord_read`/`wlt:coord_write` tokens, and
  * the LEADER register (which server currently runs the cluster, and its
    client-gateway address — the MonitorLeader discovery target) on
    `wlt:leader_read`/`wlt:leader_write`.

A quorum of these processes is the cluster's ground truth; servers
(tools/server.py --cluster-file) write through them and clients
(client/cluster_file.py) discover the gateway from them.  Registers are
in-memory here — a killed coordinator rejoins empty and the quorum
carries the state, which is the failure mode the test kills exercise.

Copy of the reference package's module, on the port's own modules.  A
coordinator holds no conflict set and runs nothing on the card, so it
takes no device.
"""

from __future__ import annotations

import argparse
import os
import signal


LEADER_TOKENS = ("wlt:leader_read", "wlt:leader_write")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--ip", default="127.0.0.1")
    ap.add_argument("--run-seconds", type=float, default=None)
    ap.add_argument("--trace-file", default=None,
                    help="base path for rolling trace files "
                         "(<path>.<seq>.jsonl): wire errors + periodic "
                         "WireMetrics from this coordinator process")
    ap.add_argument("--ready-file", default=None,
                    help="path written (atomically) once the registers are "
                         "listening — the supervisor's readiness probe; "
                         "removed on shutdown")
    ap.add_argument("--store-dir", default=None,
                    help="durable register store (storage/image.py format), "
                         "saved on clean shutdown and restored at boot — "
                         "the reference coordinator's on-disk "
                         "localGenerationReg.  Without it a bounced "
                         "coordinator rejoins empty, and a rolling bounce "
                         "of the whole quorum silently erases the cluster "
                         "state")
    args = ap.parse_args(argv)

    # SIGTERM = the supervisor's clean-shutdown request: unwind through
    # the same finally as Ctrl-C so the socket closes and traces flush
    def _sigterm(_signo, _frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)

    from ..control.coordination import Coordinator
    from ..rpc.transport import NetDriver, RealNetwork
    from ..runtime.core import EventLoop
    from ..runtime.knobs import CoreKnobs
    from ..runtime.trace import TraceCollector, TraceFileSink, spawn_wire_metrics

    loop = EventLoop()
    knobs = CoreKnobs()
    sink = None
    trace = None
    if args.trace_file:
        sink = TraceFileSink(args.trace_file, roll_size=knobs.TRACE_ROLL_SIZE,
                             max_logs=knobs.TRACE_MAX_LOGS)
        trace = TraceCollector(clock=loop.now, sink=sink,
                               min_severity=knobs.TRACE_SEVERITY)
    net = RealNetwork(loop, name="coordinator", ip=args.ip, port=args.port,
                      trace=trace)
    if trace is not None:
        trace.machine = f"coord:{net.address.port}"
        spawn_wire_metrics(loop, trace, net.wire, knobs.METRICS_INTERVAL, "tcp")
    fs = None
    if args.store_dir:
        from ..runtime.core import DeterministicRandom
        from ..storage.files import SimFilesystem
        from ..storage.image import load_image, restore_filesystem

        if os.path.exists(os.path.join(args.store_dir, "manifest.json")):
            files, _manifest = load_image(args.store_dir)
            fs = restore_filesystem(files)
            fs.reattach(loop, DeterministicRandom(net.address.port))
        else:
            fs = SimFilesystem(loop, DeterministicRandom(net.address.port))
    # cluster-state + leader registers; disk-backed when --store-dir is set
    Coordinator(net.process, loop, fs=fs, path="cstate.reg")
    Coordinator(net.process, loop, fs=fs, path="leader.reg",
                tokens=LEADER_TOKENS)
    print(f"coordinator ready on {net.address.ip}:{net.address.port}", flush=True)
    if args.ready_file:
        tmp = args.ready_file + f".{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{net.address.ip}:{net.address.port}\n")
        os.replace(tmp, args.ready_file)
    try:
        NetDriver(loop, net).serve_forever(wall_timeout=args.run_seconds)
    except KeyboardInterrupt:
        pass
    finally:
        if args.ready_file:
            try:
                os.unlink(args.ready_file)
            except OSError:
                pass
        net.close()
        if fs is not None and args.store_dir:
            from ..storage.image import save_image

            # clean shutdown: flush THEN image, so the saved registers are
            # exactly what this process last acked
            fs.flush_buffers()
            save_image(fs, args.store_dir, {
                "config": {"role": "coordinator", "port": net.address.port},
            })
        if sink is not None:
            sink.close()


if __name__ == "__main__":
    main()
