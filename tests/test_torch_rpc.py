"""The port's rpc layer (foundationdb_tpu_torch/rpc/) against the
reference's: the same seeded SimNetwork traffic — requests and replies,
one-way sends, a partition, a clog, a killed server, a closed stream and
timeouts — delivers at identical virtual times, in identical order, with
identical counters; and the port's RealNetwork serves request/reply over
loopback TCP between two networks in one process (one WallDriver pumping
both), answers its own address through the codec, fails a request to a
dead peer or a closed stream with BrokenPromise, and severs a peer that
announces another protocol version (the `protocol_version=` keyword)."""

from types import SimpleNamespace

import pytest

from foundationdb_tpu.roles import types as jtypes
from foundationdb_tpu.rpc import network as jnetwork
from foundationdb_tpu.rpc import stream as jstream
from foundationdb_tpu.runtime import combinators as jcombinators
from foundationdb_tpu.runtime import core as jcore
from foundationdb_tpu_torch.roles import types
from foundationdb_tpu_torch.rpc import network, stream, transport
from foundationdb_tpu_torch.runtime import combinators, core, trace

PORT = SimpleNamespace(core=core, network=network, stream=stream, types=types,
                       combinators=combinators)
REF = SimpleNamespace(core=jcore, network=jnetwork, stream=jstream, types=jtypes,
                      combinators=jcombinators)


def _sim_traffic(m, seed):
    """A server answering GetValueRequests after a seeded think time, and a
    client firing bursts at it through faults.  Returns every delivery as
    (virtual time, what), and the fabric's counters."""
    core, net_mod, st, ty = m.core, m.network, m.stream, m.types
    loop = core.EventLoop()
    rng = core.DeterministicRandom(seed)
    net = net_mod.SimNetwork(loop, rng)
    server = net.create_process("server")
    client = net.create_process("client", machine="m2")
    rs = st.RequestStream(server, "wlt:get", unique=True)
    oneway = st.RequestStream(server, "wlt:oneway")
    log = []
    think = core.DeterministicRandom(seed + 1)

    async def serve():
        while True:
            req = await rs.next()
            log.append((loop.now(), "recv", req.payload.key, req.spans))
            await loop.delay(think.random() * 0.001)
            if req.payload.key.endswith(b"!"):
                req.reply_error(ValueError("refused"))
            else:
                req.reply(ty.GetValueReply(req.payload.key[::-1]))

    async def sink():
        while True:
            req = await oneway.next()
            log.append((loop.now(), "oneway", req.payload))

    loop.spawn(serve())
    loop.spawn(sink())
    ref = st.RequestStreamRef(net, client, rs.endpoint)

    async def call(key, timeout=None, spans=None):
        try:
            got = await ref.get_reply(ty.GetValueRequest(key, 7), timeout=timeout,
                                      spans=spans)
            log.append((loop.now(), "reply", key, got.value))
        except core.TimedOut:
            log.append((loop.now(), "timeout", key))
        except core.BrokenPromise:
            log.append((loop.now(), "broken", key))
        except ValueError as e:
            log.append((loop.now(), "error", key, str(e)))

    async def main():
        burst = [loop.spawn(call(b"k%d" % i, spans=("d%d" % i,) if i % 3 == 0 else None))
                 for i in range(12)]
        burst.append(loop.spawn(call(b"bad!")))
        await m.combinators.wait_all(burst)
        st.RequestStreamRef(net, client, oneway.endpoint).send(b"ping")
        net.clog_pair(client.address, server.address, 0.05)
        await m.combinators.wait_all([loop.spawn(call(b"c%d" % i)) for i in range(3)])
        net.partition(client.address, server.address)
        await m.combinators.wait_all(
            [loop.spawn(call(b"p%d" % i, timeout=0.02)) for i in range(2)])
        net.heal_partition(client.address, server.address)
        await call(b"healed")
        closed = st.RequestStream(server, "wlt:closed")
        closed.close()
        try:
            await st.RequestStreamRef(net, client, closed.endpoint).get_reply(
                ty.GetValueRequest(b"x", 1))
        except core.BrokenPromise:
            log.append((loop.now(), "closed-stream broken"))
        server.kill()
        await call(b"dead", timeout=1.0)
        net.heal_all()

    loop.run_until(loop.spawn(main()), deadline=100.0)
    wire = net.wire.snapshot()
    del wire["encode_ms"], wire["decode_ms"]
    return log, net.messages_sent, net.messages_dropped, wire, loop.now()


@pytest.mark.parametrize("seed", [1, 2, 3, 40])
def test_sim_network_delivery_identical_to_the_reference(seed):
    got = _sim_traffic(PORT, seed)
    want = _sim_traffic(REF, seed)
    assert got == want
    log, sent, dropped, wire, _now = got
    kinds = [e[1] for e in log]
    assert kinds.count("reply") == 16 and kinds.count("timeout") == 2
    assert "error" in kinds and "oneway" in kinds and "closed-stream broken" in kinds
    assert kinds[-1] == "broken" and dropped > 0
    # the error reply, the closed stream's and the dead server's breaks
    assert wire["fallback_types"] == {"RpcError": 3}


def test_sim_processes_and_machines():
    loop = core.EventLoop()
    net = network.SimNetwork(loop, core.DeterministicRandom(0))
    a = net.create_process("a", machine="m1", dc="dc1")
    b = net.create_process("b", machine="m1", dc="dc2")
    net.create_process("c", machine="m2", dc="dc2")
    with pytest.raises(ValueError):
        net.create_process("dup", ip=a.address.ip, port=a.address.port)
    assert [p.name for p in net.kill_machine("m1")] == ["a", "b"]
    assert [p.name for p in net.kill_dc("dc2")] == ["c"]
    b.reboot()
    assert b.alive and b.reboots == 1 and not a.alive
    assert [e["Type"] for e in net.trace.events] == ["KillMachine", "KillDataCenter"]


# ---------------------------------------------------------------------------
# RealNetwork on loopback


def _pair(protocol_version=None):
    loop = core.EventLoop()
    col = trace.TraceCollector(clock=loop.now)
    server = transport.RealNetwork(loop, "server", trace=col)
    client = transport.RealNetwork(loop, "client", protocol_version=protocol_version)
    return loop, col, server, client, transport.WallDriver(loop, [server.pump, client.pump])


def test_real_network_request_reply_and_a_dead_peer():
    loop, _col, server, client, drv = _pair()
    rs = stream.RequestStream(server.process, "wlt:get", unique=True)

    async def serve():
        while True:
            req = await rs.next()
            req.reply(types.GetValueReply(req.payload.key + b"!"))

    loop.spawn(serve())
    ref = stream.RequestStreamRef(client, client.process, rs.endpoint)
    local = stream.RequestStreamRef(server, server.process, rs.endpoint)

    async def main():
        out = [(await ref.get_reply(types.GetValueRequest(b"k%d" % i, 1), timeout=10.0)).value
               for i in range(5)]
        out.append((await local.get_reply(types.GetValueRequest(b"local", 1))).value)
        return out

    try:
        assert drv.run_until(loop.spawn(main()), wall_timeout=30.0) == \
            [b"k0!", b"k1!", b"k2!", b"k3!", b"k4!", b"local!"]
        assert server.wire.frames_decoded >= 5 and server.wire.pickle_fallbacks == 0
        rs.close()

        async def closed():
            try:
                await ref.get_reply(types.GetValueRequest(b"x", 1), timeout=10.0)
            except core.BrokenPromise:
                return "broken"

        assert drv.run_until(loop.spawn(closed()), wall_timeout=30.0) == "broken"
        server.close()
        server = None
        drv = transport.WallDriver(loop, [client.pump])  # the server's reactor is gone

        async def dead():
            try:
                await ref.get_reply(types.GetValueRequest(b"y", 1), timeout=10.0)
            except core.BrokenPromise:
                return "broken"

        assert drv.run_until(loop.spawn(dead()), wall_timeout=30.0) == "broken"
    finally:
        if server is not None:
            server.close()
        client.close()


def test_real_network_severs_a_peer_on_another_protocol_version():
    loop, col, server, client, drv = _pair(protocol_version="0x0FDB7001")
    assert client.protocol_version == 0x0FDB7001
    assert server.protocol_version == transport.announced_protocol_version()
    rs = stream.RequestStream(server.process, "wlt:get")
    ref = stream.RequestStreamRef(client, client.process, rs.endpoint)

    async def main():
        try:
            await ref.get_reply(types.GetValueRequest(b"k", 1), timeout=10.0)
        except core.BrokenPromise:
            return "broken"

    try:
        assert drv.run_until(loop.spawn(main()), wall_timeout=30.0) == "broken"
        assert col.count("TransportProtocolMismatch") == 1
        assert len(rs.requests) == 0
    finally:
        server.close()
        client.close()


def test_net_driver_serves_one_network():
    loop = core.EventLoop()
    net = transport.RealNetwork(loop, "solo")
    try:
        drv = transport.NetDriver(loop, net)
        assert drv.net is net and net.create_process("x") is net.process
        drv.serve_forever(wall_timeout=0.01)
        with pytest.raises(core.TimedOut):
            drv.run_until(loop.delay(60.0), wall_timeout=0.05)
    finally:
        net.close()
