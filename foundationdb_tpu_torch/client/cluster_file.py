"""Cluster-file bootstrap — fdb.cluster parsing + coordinator discovery
(fdbclient/MonitorLeader.actor.cpp:435 parsing; the MonitorLeader poll
that turns a coordinator list into a live server address).

Format (the reference's): one line, `description:id@ip:port,ip:port,...`.
Comments (#) and blank lines are ignored.

`discover_gateway` quorum-reads the coordinators' LEADER register and
returns the client-gateway address the current cluster server published —
the bootstrap path a real multi-OS-process deployment uses:

    coordinators (tools/coordserver.py, N OS processes)
        ^ cstate + leader registers over real TCP
    server (tools/server.py --cluster-file)  -> publishes gateway addr
    client (this module)                     -> reads it, connects

Copy of the reference package's module, on the port's own modules.
"""

from __future__ import annotations

import os

from ..rpc.network import Endpoint, NetworkAddress


def parse_cluster_file(path: str) -> tuple[str, list[NetworkAddress]]:
    """Returns (description_id, coordinator addresses)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            head, _, addrs = line.partition("@")
            if not addrs:
                raise ValueError(f"{path}: malformed cluster file line {line!r}")
            out = []
            for a in addrs.split(","):
                ip, _, port = a.strip().rpartition(":")
                out.append(NetworkAddress(ip, int(port)))
            return head, out
    raise ValueError(f"{path}: no connection string found")


def write_cluster_file(path: str, addrs: list[NetworkAddress],
                       description: str = "fdbtpu:cluster") -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(description + "@" + ",".join(f"{a.ip}:{a.port}" for a in addrs) + "\n")
    os.replace(tmp, path)


def leader_refs(net, process, coords: list[NetworkAddress], write: bool = False):
    """RequestStreamRefs to every coordinator's leader register."""
    from ..rpc.stream import RequestStreamRef
    from ..tools.coordserver import LEADER_TOKENS

    tok = LEADER_TOKENS[1] if write else LEADER_TOKENS[0]
    return [
        RequestStreamRef(net, process, Endpoint(a, tok)) for a in coords
    ]


def cstate_refs(net, process, coords: list[NetworkAddress], write: bool = False):
    """RequestStreamRefs to every coordinator's cluster-state register."""
    from ..control.coordination import Coordinator
    from ..rpc.stream import RequestStreamRef

    tok = Coordinator.WLT_WRITE if write else Coordinator.WLT_READ
    return [
        RequestStreamRef(net, process, Endpoint(a, tok)) for a in coords
    ]


def discover_gateway(path: str, timeout: float = 10.0) -> tuple[str, int]:
    """MonitorLeader for clients: read the cluster file, quorum-read the
    leader register, return the published (host, port) of the client
    gateway.  Raises TimedOut when no quorum answers or no leader is
    published within `timeout`.

    All pacing routes through the bound clock: the NetDriver anchors the
    loop's virtual time to the wall, so `loop.now()` deadlines and
    driver-driven `loop.delay()` backoffs replace raw monotonic reads —
    and the retry backoff keeps PUMPING the network instead of blocking
    the process in time.sleep (a late quorum reply now lands during the
    backoff rather than after it)."""
    from ..control.coordination import CoordinatedState
    from ..rpc.transport import NetDriver, RealNetwork
    from ..runtime.core import EventLoop, TimedOut

    _desc, coords = parse_cluster_file(path)
    loop = EventLoop()
    net = RealNetwork(loop, name=f"client-{os.getpid()}")
    try:
        cs = CoordinatedState(
            loop,
            leader_refs(net, net.process, coords),
            leader_refs(net, net.process, coords, write=True),
            owner=f"client-{os.getpid()}",
        )
        driver = NetDriver(loop, net)

        def backoff() -> None:
            driver.run_until(loop.spawn(_delay_only(loop, 0.2)))

        deadline = loop.now() + timeout
        while loop.now() < deadline:
            fut = loop.spawn(cs.read())
            try:
                value, _gen = driver.run_until(
                    fut, wall_timeout=max(deadline - loop.now(), 0.1)
                )
            except TimedOut:
                backoff()  # quorum unreachable: back off, re-dial
                continue
            if value and "gateway" in value:
                host, _, port = value["gateway"].rpartition(":")
                return host, int(port)
            backoff()  # quorum up but no leader published yet
        raise TimedOut(f"no leader published by coordinators in {path}")
    finally:
        net.close()


async def _delay_only(loop, seconds: float) -> None:
    await loop.delay(seconds)
