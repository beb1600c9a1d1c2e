"""The port's rolling-bounce campaign (foundationdb_tpu_torch/tools/bounce.py)
against the reference's (foundationdb_tpu/tools/bounce.py).

- `_build_conf`: the same supervisor conf but for what the port means to
  change: the module paths (foundationdb_tpu_torch), an env.PYTHONPATH line
  in each base section (the children find the package from the campaign
  dir; the reference prepends to its own environment instead), the
  server's `device = ...` line, and the old wire version as the
  coordinator's `protocol-version` argument, not an env.* entry.
- `render_markdown` gives the reference's document for the same report.
- One short campaign on "cpu": 3 coordservers and the port's fdbserver
  under the port's fdbmonitor, load from 2 client threads, all three
  stories (rolling bounce, mixed protocol version, coordinator change):
  every check passes, among them zero acked-commit loss, the ring a
  permutation, each gap under --max-gap, exactly one
  TransportProtocolMismatch per old/new pair, and a fresh client finding
  the gateway through the new quorum."""

import json
import os
import sys

from foundationdb_tpu.tools import bounce as ref_bounce
from foundationdb_tpu_torch.tools import bounce as port_bounce


def _ref_lines_as_port(text: str) -> list[str]:
    """The reference's conf with the port's module paths."""
    return text.replace("-m foundationdb_tpu.tools.", "-m foundationdb_tpu_torch.tools.").split("\n")


def test_build_conf_is_the_references_but_for_the_ports_lines():
    ports = [4101, 4102, 4103]
    for old in (None, 4102):
        for device in ("cuda", "cpu"):
            got = port_bounce._build_conf(ports, 4500, old, device).split("\n")
            want = _ref_lines_as_port(ref_bounce._build_conf(ports, 4500, old))
            pin_ref = f"env.FDBTPU_PROTOCOL_VERSION = {ref_bounce.OLD_PROTOCOL}"
            pin_port = f"protocol-version = {port_bounce.OLD_PROTOCOL}"
            env = f"env.PYTHONPATH = {port_bounce.PKG_ROOT}"
            assert [line for line in got if line not in (env, f"device = {device}")] == [
                pin_port if line == pin_ref else line for line in want]
            assert got.count(env) == 2 and got.count(f"device = {device}") == 1
            assert got.index(f"device = {device}") > got.index("[fdbserver]")
            assert (pin_port in got) == (old is not None)
    assert port_bounce.OLD_PROTOCOL == ref_bounce.OLD_PROTOCOL
    assert port_bounce.PKG_ROOT == os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_pin_parses_to_the_coordinators_argument(tmp_path):
    """The supervisor turns the pin into `--protocol-version 0x0fdb7102`
    on that coordinator alone; `_pinned_protocol` reads it back."""
    from foundationdb_tpu_torch.tools.fdbmonitor import parse_conf

    conf = tmp_path / "m.conf"
    conf.write_text(port_bounce._build_conf([4101, 4102], 4500, 4102, "cpu"))
    _, specs = parse_conf(str(conf))
    pins = {s: port_bounce._pinned_protocol(spec) for s, spec in specs.items()}
    assert pins == {"coordserver.4101": None, "coordserver.4102": "0x0fdb7102",
                    "fdbserver.4500": None}
    server = specs["fdbserver.4500"].argv
    assert server[server.index("--device") + 1] == "cpu"
    assert all(spec.env == {"PYTHONPATH": port_bounce.PKG_ROOT} for spec in specs.values())
    assert specs["coordserver.4101"].argv[:3] == [
        sys.executable, "-m", "foundationdb_tpu_torch.tools.coordserver"]


REPORT = {
    "out": "/x", "gateway_port": 4500, "coordinators": [1, 2, 3],
    "acked_increments": 120, "final_counter": 121, "acked_loss": 0,
    "cycle_steps": 80, "total_acks": 200, "client_errors": ["e"],
    "client_error_count": 1,
    "bounces": [{"section": "fdbserver.4500", "label": "rolling", "restart_s": 3.2,
                 "availability_gap_s": 2.9, "acks_in_window": 14, "p50_ms": 4.1,
                 "p99_ms": 800.0},
                {"section": "coordserver.1", "label": "rolling", "restart_s": 1.0}],
    "mixed_version": {"victim": "coordserver.1", "window_s": 8.1,
                      "mismatch_events": 1, "peer_pairs": 1, "decode_failures": 0,
                      "ours": "0x0fdb7102", "theirs_expected": "0xfdb7103"},
    "checks": [{"name": "zero acked-commit loss", "ok": True, "detail": "a | b"},
               {"name": "x", "ok": False, "detail": ""}],
    "ok": False,
}


def test_render_markdown_is_the_references():
    for report in (REPORT, dict(REPORT, mixed_version={}, client_error_count=0, ok=True)):
        assert port_bounce.render_markdown(report) == ref_bounce.render_markdown(report)


def test_a_short_campaign_on_the_cpu_passes_every_check(tmp_path, monkeypatch):
    """The three stories against the port's server on "cpu".  The children
    inherit one OpenMP thread: with torch's default, a process on the CPU
    spins idle threads between its small ops and starves the other test
    workers (and itself) of the machine."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "camp"
    rc = port_bounce.main(["--out", str(out), "--device", "cpu", "--settle", "3.0",
                           "--max-gap", "30"])
    report = json.loads((out / "campaign.json").read_text())
    failed = [c for c in report["checks"] if not c["ok"]]
    assert rc == 0 and report["ok"] and not failed, failed
    assert report["acked_loss"] == 0 and report["total_acks"] > 0
    assert report["mixed_version"]["peer_pairs"] >= 1
    assert report["mixed_version"]["mismatch_events"] == report["mixed_version"]["peer_pairs"]
    names = [c["name"] for c in report["checks"]]
    assert "fresh discovery through the new quorum" in names
    assert sum(n.startswith("bounce ") for n in names) == 5  # 4 rolling + 1 in phase 3
    md = (out / "campaign.md").read_text()
    assert md == port_bounce.render_markdown(report) and "**OK**" in md
