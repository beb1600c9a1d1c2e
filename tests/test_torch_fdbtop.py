"""fdbtop on the port (foundationdb_tpu_torch/tools/fdbtop.py) against the
reference's (foundationdb_tpu/tools/fdbtop.py): the same status document
and shard rows render the same frame.

- The documents of tests/test_load_metrics.py's two fdbtop tests (a full
  frame with a previous frame's rates, and an empty document).
- The status document of the port's RecoverableCluster (device="cpu")
  after some commits, with shard rows, rendered with and without a
  previous frame and with a cut shard table.
- `snapshot` over a scripted client transaction: the same keys read, the
  same document and shard rows decoded, the transaction destroyed.
The live `fdbtop --once` against a served cluster is in
tests/test_torch_fdbmonitor.py (the supervised server)."""

import json

import pytest

from foundationdb_tpu.tools import fdbtop as ref_top
from foundationdb_tpu_torch.control.recoverable import RecoverableCluster
from foundationdb_tpu_torch.control.status import cluster_status
from foundationdb_tpu_torch.tools import fdbtop as port_top
from tests.torch_threads import one_torch_thread  # noqa: F401

FULL_DOC = {
    "cluster": {
        "generation": {"epoch": 3, "state": "accepting", "count": 1},
        "clock": 12.5,
        "data": {
            "total_kv_bytes_estimate": 1 << 20,
            "moving_bytes_estimate": 2048,
            "moving_ranges": 1,
            "shard_count": 3,
            "hot_shards": [],
        },
        "data_distribution": {"hot_relocations": 2, "frozen": True},
        "messages": [{
            "severity": 30, "name": "e_brake",
            "description": "queue hard limit",
        }],
    },
    "ratekeeper": {
        "tps_budget": 500.0, "limit_reason": "storage_queue",
        "limiting_server": "ss-0-r1", "limiting_shard": "b'hot/key'",
        "limiting_shard_bps": 4096.0, "e_brake": True,
    },
    "proxy": {"committed_version": 900, "txns_committed": 100,
              "txns_conflicted": 5},
    "tlogs": [{"version": 900, "bytes_queued": 4096, "locked": False}],
    "storage": [{"tag": "ss-0-r0", "version": 900,
                 "durable_version": 880, "queue_bytes": 1024,
                 "keys": 1000}],
}
SHARDS = [
    {"begin": "b''", "bytes": 9000, "bytes_read_per_ksec": 2e6,
     "bytes_written_per_ksec": 1e6, "team": ["ss-0-r0", "ss-0-r1"]},
    {"begin": "b'\\x80'", "bytes": 100, "bytes_read_per_ksec": 0.0,
     "bytes_written_per_ksec": 0.0, "team": ["ss-1-r0"]},
]
PREV = {"proxy": {"txns_committed": 80, "txns_conflicted": 5}}


def both(*args, **kw):
    got, want = port_top.render(*args, **kw), ref_top.render(*args, **kw)
    assert got == want
    return got


@pytest.mark.parametrize("case", ["full", "no_prev", "empty", "shards_only"])
def test_frames_equal_the_references(case):
    doc, shards, prev, dt = {
        "full": (FULL_DOC, SHARDS, PREV, 2.0),
        "no_prev": (FULL_DOC, SHARDS, None, 0.0),
        "empty": ({}, [], None, 0.0),
        "shards_only": ({}, SHARDS * 9, None, 0.0),
    }[case]
    frame = both(doc, shards, prev, dt)
    assert frame.startswith("fdbtpu top")
    if case == "full":
        assert "10 commit/s" in frame and "[E-BRAKE]" in frame
    if case == "shards_only":
        assert "more shard(s)" in frame


def test_a_live_status_document_renders_as_the_references():
    """The port's cluster on the CPU: its status document after commits
    (as the gateway serves it: JSON round trip) and made-up shard rows."""
    c = RecoverableCluster(seed=7, n_storage_shards=2, device="cpu")
    try:
        db = c.database()

        async def fill():
            for i in range(20):
                tr = db.create_transaction()
                tr.set(b"top/%03d" % i, b"x" * i)
                await tr.commit()

        c.run_until(c.loop.spawn(fill()), 60.0)
        prev = json.loads(json.dumps(cluster_status(c), default=str))
        c.run_until(c.loop.spawn(fill()), 60.0)
        doc = json.loads(json.dumps(cluster_status(c), default=str))
    finally:
        c.stop()
    assert doc["proxy"]["txns_committed"] > prev["proxy"]["txns_committed"] > 0
    for shards, max_shards in ((SHARDS, 12), (SHARDS * 3, 4), ([], 12)):
        frame = both(doc, shards, prev, 4.0, max_shards=max_shards)
        assert " commit/s" in frame and "storage:" in frame


class _Tr:
    def __init__(self, log):
        self.log = log

    def get(self, key):
        self.log.append(("get", key))
        return json.dumps(FULL_DOC).encode()

    def get_range(self, begin, end):
        self.log.append(("get_range", begin, end))
        return [(b"\xff\xff/metrics/" + b"k%d" % i,
                 json.dumps({"bytes": i, "team": ["a"]}).encode()) for i in range(3)]

    def destroy(self):
        self.log.append(("destroy",))


class _Db:
    def __init__(self):
        self.log = []

    def transaction(self):
        return _Tr(self.log)


def test_snapshot_reads_and_decodes_as_the_references():
    port_db, ref_db = _Db(), _Db()
    got, want = port_top.snapshot(port_db), ref_top.snapshot(ref_db)
    assert got == want and port_db.log == ref_db.log
    assert got[0] == FULL_DOC and [m["begin"] for m in got[1]] == [
        "b'k0'", "b'k1'", "b'k2'"]
    assert port_db.log[-1] == ("destroy",)
