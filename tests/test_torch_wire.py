"""The port's wire codec (foundationdb_tpu_torch/runtime/serialize.py, with
the codecs its rpc/stream.py and roles/types.py register) against the
reference's, byte for byte: for every registered hand codec, seeded
messages built alike in both packages encode to the same bytes, and each
side decodes the other's bytes to the same message (a full-width
ResolveTransactionBatchRequest among them).  Also the frames
(encode_frame/decode_frame), the scalar tags, the record codecs, the
protocol-version keyword that replaces the reference's environment read,
truncated bodies, and the pickle fallback, whose bytes differ by design
(a pickle names its classes by module path)."""

import dataclasses
import enum
import random
from types import SimpleNamespace

import pytest

from foundationdb_tpu.conflict import api as japi
from foundationdb_tpu.roles import types as jtypes
from foundationdb_tpu.rpc import network as jnetwork
from foundationdb_tpu.rpc import stream as jstream
from foundationdb_tpu.runtime import serialize as jwire
from foundationdb_tpu_torch.conflict import api
from foundationdb_tpu_torch.roles import types
from foundationdb_tpu_torch.rpc import network, stream
from foundationdb_tpu_torch.runtime import serialize as wire
from foundationdb_tpu_torch.runtime.metrics import WireStats

PORT = SimpleNamespace(types=types, api=api, network=network, stream=stream, wire=wire)
REF = SimpleNamespace(types=jtypes, api=japi, network=jnetwork, stream=jstream, wire=jwire)


def norm(x):
    """A package-free form of a message: dataclasses and enums by class
    name, containers by their items."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return [(norm(k), norm(v)) for k, v in x.items()]
    if isinstance(x, BaseException):
        return (type(x).__name__, x.args)
    return x


# ---------------------------------------------------------------------------
# seeded builders, one per registered type (same draws in both packages)


def _key(r, n=None):
    return r.randbytes(r.randrange(0, 12) if n is None else n)


def _opt(r, v):
    return None if r.random() < 0.3 else v


def _ranges(r, n):
    return [tuple(sorted((_key(r), _key(r)))) for _ in range(n)]


def _muts(m, r):
    mt = list(m.types.MutationType)
    return [m.types.Mutation(r.choice(mt), _key(r), _opt(r, _key(r)))
            for _ in range(r.randrange(0, 6))]


def _txns(m, r, n):
    return [m.api.TxInfo(r.randrange(0, 1 << 40), _ranges(r, r.randrange(0, 4)),
                         _ranges(r, r.randrange(0, 3))) for _ in range(n)]


def _entries(m, r):
    return [(r.randrange(1 << 50), _muts(m, r)) for _ in range(r.randrange(0, 4))]


def _sel(m, r):
    return m.types.KeySelector(_key(r), r.random() < 0.5, r.randrange(-5, 6))


def _endpoint(m, r):
    addr = m.network.NetworkAddress(f"10.0.{r.randrange(256)}.{r.randrange(256)}",
                                    r.randrange(1, 65536))
    return m.network.Endpoint(addr, "rp:" + r.randbytes(8).hex())


def _dbg(r):
    return _opt(r, r.randbytes(8).hex())


BUILDERS = {
    "ResolveTransactionBatchRequest": lambda m, r: m.types.ResolveTransactionBatchRequest(
        r.randrange(1 << 40), r.randrange(1 << 40), _txns(m, r, r.randrange(0, 20))),
    "ResolveTransactionBatchReply": lambda m, r: m.types.ResolveTransactionBatchReply(
        [r.randrange(3) for _ in range(r.randrange(0, 40))]),
    "TLogCommitRequest": lambda m, r: m.types.TLogCommitRequest(
        r.randrange(1 << 40), r.randrange(1 << 40),
        {f"tag{i}": _muts(m, r) for i in range(r.randrange(0, 4))},
        known_committed=r.randrange(1 << 40)),
    "CommitTransactionRequest": lambda m, r: m.types.CommitTransactionRequest(
        r.randrange(1 << 40), _ranges(r, r.randrange(3)), _ranges(r, r.randrange(3)),
        _muts(m, r), debug_id=_dbg(r), lock_aware=r.random() < 0.5),
    "CommitReply": lambda m, r: m.types.CommitReply(
        r.choice(list(m.types.CommitResult)), r.randrange(-1, 1 << 40)),
    "GetCommitVersionRequest": lambda m, r: m.types.GetCommitVersionRequest(
        "proxy-" + r.randbytes(3).hex(), r.randrange(1 << 30), r.randrange(1 << 40)),
    "GetCommitVersionReply": lambda m, r: m.types.GetCommitVersionReply(
        r.randrange(1 << 40), r.randrange(1 << 40)),
    "GetReadVersionRequest": lambda m, r: m.types.GetReadVersionRequest(
        debug_id=_dbg(r), priority=r.randrange(3)),
    "GetReadVersionReply": lambda m, r: m.types.GetReadVersionReply(r.randrange(1 << 40)),
    "GetRawCommittedVersionRequest": lambda m, r: m.types.GetRawCommittedVersionRequest(),
    "GetRawCommittedVersionReply": lambda m, r: m.types.GetRawCommittedVersionReply(
        r.randrange(1 << 40)),
    "TLogPeekRequest": lambda m, r: m.types.TLogPeekRequest(
        "tag" + r.randbytes(2).hex(), r.randrange(1 << 40)),
    "TLogPeekReply": lambda m, r: m.types.TLogPeekReply(
        _entries(m, r), r.randrange(1 << 40), known_committed=r.randrange(1 << 40)),
    "TLogPopRequest": lambda m, r: m.types.TLogPopRequest(
        "tag" + r.randbytes(2).hex(), r.randrange(1 << 40)),
    "TLogConfirmRequest": lambda m, r: m.types.TLogConfirmRequest(),
    "TLogConfirmReply": lambda m, r: m.types.TLogConfirmReply(r.random() < 0.5),
    "TLogLockRequest": lambda m, r: m.types.TLogLockRequest(),
    "TLogLockReply": lambda m, r: m.types.TLogLockReply(
        r.randrange(1 << 40), {f"t{i}": _entries(m, r) for i in range(r.randrange(0, 3))}),
    "ResolutionMetricsRequest": lambda m, r: m.types.ResolutionMetricsRequest(),
    "ResolutionMetricsReply": lambda m, r: m.types.ResolutionMetricsReply(
        r.randrange(1 << 40)),
    "ResolutionSplitRequest": lambda m, r: m.types.ResolutionSplitRequest(),
    "ResolutionSplitReply": lambda m, r: m.types.ResolutionSplitReply(_opt(r, _key(r))),
    "GetValueRequest": lambda m, r: m.types.GetValueRequest(
        _key(r), r.randrange(1 << 40), debug_id=_dbg(r)),
    "GetValueReply": lambda m, r: m.types.GetValueReply(_opt(r, _key(r))),
    "GetKeyValuesRequest": lambda m, r: m.types.GetKeyValuesRequest(
        _key(r), _key(r), r.randrange(1 << 40), limit=r.randrange(1, 10000)),
    "GetKeyValuesReply": lambda m, r: m.types.GetKeyValuesReply(
        [(_key(r), _key(r)) for _ in range(r.randrange(0, 6))], r.random() < 0.5),
    "WatchValueRequest": lambda m, r: m.types.WatchValueRequest(
        _key(r), _opt(r, _key(r)), r.randrange(1 << 40)),
    "GetKeyRequest": lambda m, r: m.types.GetKeyRequest(
        _sel(m, r), r.randrange(1 << 40), _key(r), _key(r), debug_id=_dbg(r)),
    "GetKeyReply": lambda m, r: m.types.GetKeyReply(_sel(m, r)),
    "RpcMessage": lambda m, r: m.stream.RpcMessage(
        BUILDERS[r.choice(["ResolveTransactionBatchReply", "GetValueRequest",
                           "CommitReply"])](m, r),
        _opt(r, _endpoint(m, r)),
        _opt(r, tuple(r.randbytes(4).hex() for _ in range(r.randrange(1, 4))))),
}


def _registered(m):
    return {cls.__name__: tag for cls, tag in m.wire.registered_types().items()}


def test_every_hand_codec_is_registered_under_the_reference_tag():
    got = _registered(PORT)
    assert got == _registered(REF)
    assert set(got) == set(BUILDERS) and len(got) == 30
    # the port's classes only: nothing of the reference in its registry
    for cls in wire.registered_types():
        assert cls.__module__.startswith("foundationdb_tpu_torch."), cls


def _same_both_ways(port_msg, ref_msg):
    """Port bytes == reference bytes, and each side decodes the other's."""
    pb = wire.encode_payload(port_msg, strict=True)
    rb = jwire.encode_payload(ref_msg, strict=True)
    assert pb == rb
    assert pb[:2] != b"\x00\x00"  # not the pickle fallback
    from_ref = wire.decode_payload(rb)
    from_port = jwire.decode_payload(pb)
    assert norm(from_ref) == norm(port_msg) == norm(ref_msg) == norm(from_port)
    assert type(from_ref) is type(port_msg) and type(from_port) is type(ref_msg)
    return pb


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_codec_bytes_identical_both_ways(name):
    for seed in range(12):
        pm = BUILDERS[name](PORT, random.Random(seed))
        rm = BUILDERS[name](REF, random.Random(seed))
        blob = _same_both_ways(pm, rm)
        # every truncation of the body fails (or decodes) alike in both
        for cut in sorted({2, 3, len(blob) // 2, len(blob) - 1}):
            if cut >= len(blob):
                continue
            outcomes = []
            for w in (wire, jwire):
                try:
                    outcomes.append(("ok", norm(w.decode_payload(blob[:cut]))))
                except (w.CodecError, ValueError) as e:
                    outcomes.append(("error", type(e).__name__))
            assert outcomes[0] == outcomes[1], (name, seed, cut)


def _full_width(m, seed):
    """The resolver stream's batch: 8192 txns of 2 point reads and 1 point
    write over 16-byte keys."""
    r = random.Random(seed)
    pool = [r.randbytes(16) for _ in range(4096)]
    TxInfo = m.api.TxInfo

    def point(k):
        return (k, k + b"\x00")

    txns = [TxInfo(max(41 - r.randrange(13), 0),
                   [point(r.choice(pool)), point(r.choice(pool))],
                   [point(r.choice(pool))]) for _ in range(8192)]
    return m.types.ResolveTransactionBatchRequest(41, 42, txns)


def test_full_width_resolver_batch_bytes_identical_both_ways():
    pm, rm = _full_width(PORT, 3), _full_width(REF, 3)
    blob = _same_both_ways(pm, rm)
    # header + snapshots + counts + key lengths + keys
    assert len(blob) == 2 + 20 + 8 * 8192 + 8 * 8192 + 4 + 4 * 6 * 8192 + 6 * 8192 * 16.5
    env_p = stream.RpcMessage(pm, network.Endpoint(network.NetworkAddress("1.0.0.2", 4500), "rp:x"))
    env_r = jstream.RpcMessage(rm, jnetwork.Endpoint(jnetwork.NetworkAddress("1.0.0.2", 4500), "rp:x"))
    _same_both_ways(env_p, env_r)


def test_frames_identical_both_ways():
    r = random.Random(9)
    for i in range(20):
        name = sorted(BUILDERS)[i % len(BUILDERS)]
        pm, rm = BUILDERS[name](PORT, random.Random(i)), BUILDERS[name](REF, random.Random(i))
        token = "wlt:" + r.randbytes(4).hex()
        addr = None if i % 3 == 0 else ("10.1.2.3", 4000 + i)
        pa = addr and network.NetworkAddress(*addr)
        ra = addr and jnetwork.NetworkAddress(*addr)
        pf = wire.encode_frame(token, pa, pm)
        rf = jwire.encode_frame(token, ra, rm)
        assert pf == rf
        tok, got_addr, got = wire.decode_frame(rf)
        assert (tok, norm(got_addr), norm(got)) == (token, norm(pa), norm(pm))
        tok, got_addr, got = jwire.decode_frame(pf)
        assert (tok, norm(got_addr), norm(got)) == (token, norm(ra), norm(rm))
    with pytest.raises(wire.CodecError):
        wire.decode_frame(b"\x05\x00\x00\x00abc")
    with pytest.raises(wire.CodecError):
        wire.decode_frame(b"\x00\x00\x00\x00\x07")  # bad addr flag


@pytest.mark.parametrize("value", [None, 0, -1, 1 << 62, b"", b"\x00ab", "", "keyé",
                                   True, False])
def test_scalar_tags_identical(value):
    assert wire.encode_payload(value) == jwire.encode_payload(value)
    assert wire.decode_payload(jwire.encode_payload(value)) == value


def test_record_codecs_identical():
    r = random.Random(5)
    by_tag = {f"t{i}": _muts(PORT, r) for i in range(3)}
    r = random.Random(5)
    jby_tag = {f"t{i}": _muts(REF, r) for i in range(3)}
    blob = wire.encode_version_mutations(77, by_tag)
    assert blob == jwire.encode_version_mutations(77, jby_tag)
    # read_mutation rebuilds b"" for a None value, as the reference does
    v, got = wire.decode_version_mutations(blob)
    jv, jgot = jwire.decode_version_mutations(blob)
    assert (v, norm(got)) == (jv, norm(jgot))
    w, jw = wire.BinaryWriter(), jwire.BinaryWriter()
    for x in (w, jw):
        x.u8(7).u32(1 << 31).i64(-5).f64(2.5).bytes_(b"ab").str_("cd")
    assert w.data() == jw.data()
    rd = wire.BinaryReader(jw.data())
    assert (rd.u8(), rd.u32(), rd.i64(), rd.f64(), rd.bytes_(), rd.str_(), rd.eof()) == \
        (7, 1 << 31, -5, 2.5, b"ab", "cd", True)
    lens, ks = [3, 0, 2], [b"abc", b"", b"de"]
    assert wire.soa_encode_keys(lens, ks) == jwire.soa_encode_keys(lens, ks)
    assert wire.soa_decode_keys(wire.soa_encode_keys(lens, ks), 0) == (ks, 4 + 12 + 5)


@pytest.mark.parametrize("raw", ["", "0x0FDB7102", "0x0fdb7103", "268267778", None])
def test_protocol_version_keyword_matches_the_reference_env_read(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("FDBTPU_PROTOCOL_VERSION", raising=False)
    else:
        monkeypatch.setenv("FDBTPU_PROTOCOL_VERSION", raw)
    assert wire.announced_protocol_version(raw) == jwire.announced_protocol_version()
    assert wire.announced_protocol_version() == wire.PROTOCOL_VERSION == jwire.PROTOCOL_VERSION
    assert wire.announced_protocol_version(0x0FDB7101) == 0x0FDB7101


def test_pickle_fallback_differs_by_design():
    """An unregistered payload rides TAG_PICKLE in both packages; its body
    names the package's own classes, so the bytes differ, and each side
    decodes its own to its own class."""
    pe = stream.RpcError(ValueError("gone"))
    je = jstream.RpcError(ValueError("gone"))
    pb, jb = wire.encode_payload(pe), jwire.encode_payload(je)
    assert pb[:2] == jb[:2] == b"\x00\x00"
    assert pb != jb and b"foundationdb_tpu_torch" in pb
    got = wire.decode_payload(pb)
    assert type(got) is stream.RpcError and norm(got) == norm(je)
    with pytest.raises(wire.Unencodable):
        wire.encode_payload(pe, strict=True)
    stats = WireStats()
    wire.encode_payload(pe, stats=stats)
    assert stats.fallback_types == {"RpcError": 1}
