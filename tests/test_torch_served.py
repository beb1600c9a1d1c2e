"""The port's served cluster as OS processes: three coordinators
(foundationdb_tpu_torch/tools/coordserver.py), a cluster file
(client/cluster_file.py) and the server (tools/server.py --cluster-file
--device cpu), which serves the gateway protocol (tools/gateway.py) with
its resolvers on the port's DeviceConflictSet.  Through it:

- the C ABI: bindings/c built with g++ into a temporary directory (never
  into bindings/c) and its `ctest` printing C-OK;
- the bindingtester digests of the C ABI (ctypes), the port's
  gateway_client and the port's in-process client equal each other and
  the reference gateway's, seed by seed (the user keyspace is cleared
  before each digest, as a fresh cluster would have it);
- a coordinator killed: commits go on, and a fresh client rediscovers the
  gateway through the surviving quorum;
- a key of 600 bytes commits through the gateway and reads back, and a
  10-byte key commits after it (the default set widens to 1024 bytes; its
  capacity, 2**16 rows, makes every later batch's sort on the CPU cost
  about a second, so this runs last and the 10,000-byte key is left to
  the card, chip_smoke.py phase 19);
- \\xff\\xff/status/json through the gateway: backend "cpu", key_bytes
  1024 after the 600-byte key, and no kernel launches on the CPU.

Every subprocess has its own wall timeout (`--run-seconds`) and is killed
at the end."""

import json
import os
import pathlib
import queue
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import chip_smoke  # the bindingtester adapters phase 19 uses too
from foundationdb_tpu_torch.client.cluster_file import write_cluster_file
from foundationdb_tpu_torch.client.gateway_client import GatewayClient, open_cluster
from foundationdb_tpu_torch.control.recoverable import RecoverableCluster
from foundationdb_tpu_torch.rpc.network import NetworkAddress
from foundationdb_tpu_torch.tools.gateway import build_c_bindings
from tests.test_bindingtester import digest
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "bindings" / "python"))
from fdbtpu_ctypes import FdbTpu  # noqa: E402

SEEDS = [11, 12, 13]
RUN_S = "300"  # every process's own wall limit
ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")  # one torch thread a process
REF_GATEWAY = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from foundationdb_tpu.control.recoverable import RecoverableCluster
    from foundationdb_tpu.tools.gateway import ClientGateway, GatewayDriver

    c = RecoverableCluster(seed=901, n_storage_shards=2, storage_replication=2)
    gw = ClientGateway(c.loop, c.database(), port=0)
    print("gateway ready on", gw.port, flush=True)
    GatewayDriver(c.loop, gw).serve_forever(wall_timeout={run_s})
""")


class Proc:
    """A child process whose output lines a thread queues."""

    def __init__(self, *args: str) -> None:
        self.p = subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=ENV,
                                  cwd=str(REPO))
        self.lines: queue.Queue[str] = queue.Queue()
        self.seen: list[str] = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for line in self.p.stdout:
            self.lines.put(line)

    def wait_line(self, needle: str, timeout: float = 120.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                line = self.lines.get(timeout=0.5)
            except queue.Empty:
                if self.p.poll() is not None:
                    raise RuntimeError(f"exited rc={self.p.returncode} before "
                                       f"{needle!r}: {''.join(self.seen)[-3000:]}")
                continue
            self.seen.append(line)
            if needle in line:
                return line
        raise TimeoutError(f"never saw {needle!r}: {''.join(self.seen)[-3000:]}")

    def kill(self) -> None:
        self.p.kill()
        self.p.wait()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """3 coordinators, a cluster file and the server on "cpu"; yields
    (cluster file, coordinator processes, C library, ctest)."""
    tmp = tmp_path_factory.mktemp("served")
    lib, ctest = build_c_bindings(tmp / "c")
    procs: list[Proc] = []
    try:
        addrs = []
        for _ in range(3):
            c = Proc("-m", "foundationdb_tpu_torch.tools.coordserver",
                     "--run-seconds", RUN_S)
            procs.append(c)
            ip, _, port = c.wait_line("coordinator ready on").split()[-1].rpartition(":")
            addrs.append(NetworkAddress(ip, int(port)))
        cf = str(tmp / "fdb.cluster")
        write_cluster_file(cf, addrs)
        server = Proc("-m", "foundationdb_tpu_torch.tools.server", "--cluster-file", cf,
                      "--device", "cpu", "--run-seconds", RUN_S)
        procs.append(server)
        server.wait_line("fdbtpu server ready on")
        yield cf, procs[:3], lib, ctest
    finally:
        for p in procs:
            p.kill()


@pytest.fixture(scope="module")
def ref_gateway():
    proc = Proc("-c", REF_GATEWAY.format(repo=str(REPO), run_s=RUN_S))
    try:
        yield int(proc.wait_line("gateway ready on").split()[-1])
    finally:
        proc.kill()


def test_ctest_prints_c_ok(served):
    cf, _coords, _lib, ctest = served
    db = open_cluster(cf, timeout=30.0)
    host, port = db._addr
    db.close()
    r = subprocess.run([str(ctest), host, str(port)], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("C-OK ") and int(r.stdout.split()[1]) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_bindings_digest_as_the_reference_gateway(served, ref_gateway, seed):
    cf, _coords, lib, _ctest = served
    db = open_cluster(cf, timeout=30.0)
    host, port = db._addr
    digests = {}
    chip_smoke.clear_user(db)
    c_db = FdbTpu(str(lib), host, port)
    try:
        digests["c_abi"] = digest(chip_smoke.TxnDriver(c_db.create_transaction), seed)
    finally:
        c_db.close()
    chip_smoke.clear_user(db)
    digests["gateway_client"] = digest(chip_smoke.TxnDriver(db.transaction), seed)
    db.close()
    c = RecoverableCluster(seed=990 + seed, n_storage_shards=2, storage_replication=2,
                           device="cpu")
    try:
        digests["in_process"] = digest(chip_smoke.InProcessDriver(chip_smoke.port_modules(), c),
                                       seed)
    finally:
        c.stop()
    ref = GatewayClient("127.0.0.1", ref_gateway)
    try:
        chip_smoke.clear_user(ref)
        digests["reference_gateway"] = digest(chip_smoke.TxnDriver(ref.transaction), seed)
    finally:
        ref.close()
    assert digests["c_abi"] == digests["reference_gateway"]
    assert digests["gateway_client"] == digests["reference_gateway"]
    assert digests["in_process"] == digests["reference_gateway"]


def test_coordinator_kill_and_rediscovery(served):
    """Kill one of three coordinators: commits go on through the quorum of
    two, and a fresh client discovers the gateway through it."""
    cf, coords, _lib, _ctest = served
    db = open_cluster(cf, timeout=30.0)
    coords[0].kill()
    for i in range(4):
        db.run(lambda tr, i=i: tr.set(b"kill/%d" % i, b"%d" % i))
    db.run(lambda tr: tr.atomic_add(b"kill/ctr", 3))
    db.close()
    fresh = open_cluster(cf, timeout=30.0)
    rows = fresh.read(lambda tr: tr.get_range(b"kill/", b"kill0"))
    fresh.close()
    assert [k for k, _v in rows] == [b"kill/%d" % i for i in range(4)] + [b"kill/ctr"]
    assert int.from_bytes(rows[-1][1], "little", signed=True) == 3


LONG = [600, 10]


def test_long_keys_commit_through_the_gateway(served):
    """A key of 600 bytes, then a 10-byte key, each its own transaction
    (read, write, commit), then both read back."""
    db = open_cluster(served[0], timeout=30.0)
    keys = [b"fz/" + b"k" * (n - 3) for n in LONG]
    versions = []
    for k in keys:
        def body(tr, k=k):
            tr.get(k)
            tr.set(k, b"v%d" % len(k))

        tr = db.transaction()
        body(tr)
        versions.append(tr.commit())
        tr.destroy()
    assert versions == sorted(versions) and len(set(versions)) == 2
    assert db.read(lambda tr: [tr.get(k) for k in keys]) == [b"v%d" % n for n in LONG]
    db.close()


def test_status_json_through_the_gateway(served):
    db = open_cluster(served[0], timeout=30.0)
    doc = json.loads(db.read(lambda tr: tr.get(b"\xff\xff/status/json")))
    db.close()
    assert doc["cluster"]["generation"]["state"] == "fully_recovered"
    kernel = doc["kernel"]
    assert kernel["backend"] == "cpu"
    assert kernel["key_bytes"] == 1024 and kernel["widenings"] >= 1
    assert set(kernel["launches"]) >= {"probe_fused", "intra_fixpoint",
                                       "compact_ranks", "run_to_step"}
    assert not any(kernel["launches"].values())  # the CPU path launches nothing


def test_server_defaults_to_the_card_and_exits_without_one():
    """With no --device the server's sets go on cuda: on a machine without
    a card it exits with the cluster's error before it serves."""
    r = subprocess.run([sys.executable, "-m", "foundationdb_tpu_torch.tools.server",
                        "--run-seconds", "30"], capture_output=True, text=True,
                       timeout=120, env=ENV, cwd=str(REPO))
    if r.returncode == 0 or "server ready" in r.stdout:
        pytest.skip("a CUDA device is present")
    assert "no CUDA device" in r.stderr and "server ready" not in r.stdout
