"""The restarting pairs on the port (foundationdb_tpu_torch/workloads/
spec.py with storage/image.py): each pair of tests/specs/restarting/
through the port's `run_restarting_pair(..., device="cpu")` and the
reference's, same seed, each saving its image into a directory of its own.
Both halves' metrics (less the image path), the census of both halves and
the end virtual time must be identical, and so must the two saved images,
file by file.  RestartAttritionSwizzle names `backend=supervised`: the
power kill lands on the port's supervised set on the CPU.

Then the plumbing, as tests/test_restart_pairs.py pins it for the
reference: pair resolution, the refusals (runSetup typo, a part 1 without
its kill, a part 2 with one, seed / config / invariant-state mismatches,
a torn image), the ephemeral image directory, and the port's own
differences: `_BACKENDS` names the port's OracleConflictSet for "oracle",
and `device=` puts the supervised set on a device (default "cuda", which
raises without a card) while an oracle spec ignores it."""

import os
import pathlib

import pytest
import torch

from foundationdb_tpu.workloads import spec as jspec
from foundationdb_tpu_torch.conflict.device import DeviceConflictSet
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.conflict.supervisor import DeviceSupervisor
from foundationdb_tpu_torch.storage.image import RestartImageError, load_image
from foundationdb_tpu_torch.workloads import spec
from tests.test_restart_pairs import P1_MINI, P2_MINI
from tests.test_torch_specs import _buggify_off, traced  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

RESTARTING = pathlib.Path(__file__).parent / "specs" / "restarting"
PAIRS = sorted(p.name[:-6] for p in RESTARTING.glob("*-1.txt"))


def files_of(d: pathlib.Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file()}


def without_image(m: dict) -> dict:
    out = {k: v for k, v in m.items() if k != "restart_image"}
    out["part1"] = {k: v for k, v in m["part1"].items() if k != "restart_image"}
    out["part1"]["SaveAndKill"] = {k: v for k, v in m["part1"]["SaveAndKill"].items()
                                   if k != "image"}
    return out


def test_the_four_pairs():
    assert PAIRS == ["CycleRestart", "DiskFaultRestart", "KillRegionRestart",
                     "RestartAttritionSwizzle"]


@pytest.mark.parametrize("stem", PAIRS)
def test_pair_matches_the_reference(tmp_path, stem):
    path = str(RESTARTING / stem)
    got = traced(spec.run_restarting_pair, path, image_dir=str(tmp_path / "port"),
                 device="cpu")
    want = traced(jspec.run_restarting_pair, path, image_dir=str(tmp_path / "ref"))
    assert without_image(got[0]) == without_image(want[0])
    assert got[1:] == want[1:]
    assert got[0]["part1"]["phase"] == 1 and got[0]["part2"]
    images = files_of(tmp_path / "port")
    assert "manifest.json" in images and images == files_of(tmp_path / "ref")


def test_resolution_and_same_stem_standalones(tmp_path):
    stem = str(RESTARTING / "CycleRestart")
    want = (stem + "-1.txt", stem + "-2.txt")
    for p in (stem, stem + "-1.txt", stem + "-2.txt", stem + "-1"):
        assert spec.resolve_pair(p) == want
    assert spec.is_restarting_pair(stem)
    assert not spec.is_restarting_pair("tests/specs/CycleTest.txt")
    with pytest.raises(FileNotFoundError, match="missing"):
        spec.resolve_pair("tests/specs/CycleTest.txt")
    plain = "testTitle=Foo\ntestName=Cycle\nnodes=4\nclients=1\ntxnsPerClient=2\n"
    (tmp_path / "Foo-1.txt").write_text(plain)
    (tmp_path / "Foo-2.txt").write_text(plain)
    assert not spec.should_run_pair(str(tmp_path / "Foo-2.txt"))
    m = spec.run_spec_file(str(tmp_path / "Foo-2.txt"), device="cpu")
    assert "part1" not in m and m["Cycle"]["committed"] == 2


def test_refusals_match_the_reference(tmp_path):
    """Each refusal the reference makes, the port makes with its message."""
    with pytest.raises(ValueError, match="runSetup expects true/false"):
        spec.run_spec("testTitle=X\ntestName=Cycle\nnodes=4\nclients=1\n"
                      "txnsPerClient=1\nrunSetup=no\n", device="cpu")
    (tmp_path / "KillTwice-1.txt").write_text(P1_MINI)
    (tmp_path / "KillTwice-2.txt").write_text(
        P2_MINI + "\ntestName=SaveAndKill\nrestartAfter=0.5\n")
    with pytest.raises(ValueError, match="must run checks"):
        spec.run_restarting_pair(str(tmp_path / "KillTwice"),
                                 image_dir=str(tmp_path / "img0"), device="cpu")
    (tmp_path / "NoKill-1.txt").write_text(
        "testTitle=NoKill\ntestName=Cycle\nnodes=4\nclients=1\ntxnsPerClient=1\n")
    (tmp_path / "NoKill-2.txt").write_text(P2_MINI)
    with pytest.raises(ValueError, match="without a SaveAndKill"):
        spec.run_restarting_pair(str(tmp_path / "NoKill"),
                                 image_dir=str(tmp_path / "img1"), device="cpu")
    img = spec.run_spec(P1_MINI, save_dir=str(tmp_path / "img"),
                        device="cpu")["restart_image"]
    for text, match in (
        ("testTitle=X\nseed=6\ntestName=Cycle\nnodes=6\nrunSetup=false\n", "seed"),
        ("testTitle=X\nshards=3\ntestName=Cycle\nnodes=6\nrunSetup=false\n",
         "n_storage_shards"),
        ("testTitle=X\ntestName=Cycle\nnodes=8\nrunSetup=false\n", "Cycle"),
    ):
        with pytest.raises(ValueError, match=f"restarting-pair mismatch.*{match}"):
            spec.run_spec(text, restart_image=img, device="cpu")
    m2 = spec.run_spec("testTitle=X\nseed=5\nshards=2\nreplication=2\n"
                       "testName=Cycle\nnodes=6\nclients=1\ntxnsPerClient=1\n"
                       "runSetup=false\n", restart_image=img, device="cpu")
    assert m2["Cycle"]["committed"] == 1
    os.remove(os.path.join(img, "manifest.json"))
    with pytest.raises(RestartImageError, match="no manifest.json"):
        load_image(img)


def test_ephemeral_image_dir_is_removed_after_a_green_pair(tmp_path, monkeypatch):
    """With no image_dir the pair saves into a fresh temp dir and deletes
    it once part 2 consumed it."""
    monkeypatch.setattr(spec.tempfile, "tempdir", str(tmp_path))
    m = spec.run_restarting_pair(str(RESTARTING / "CycleRestart"), device="cpu")
    assert m["restart_image"] is None and m["part2"]["Cycle"]["committed"] == 8
    assert list(tmp_path.iterdir()) == []


def test_backends_name_the_port_sets(monkeypatch):
    """"oracle" is the port's OracleConflictSet (the reference's None: its
    cluster default); "supervised" wraps the port's DeviceConflictSet on
    the device asked for, and without a card the default raises before a
    cluster boots.  An oracle spec ignores the device keyword."""
    assert spec._BACKENDS["oracle"] is OracleConflictSet
    assert sorted(spec._BACKENDS) == sorted(jspec._BACKENDS)
    sup = spec._backend_factory("supervised", "cpu")(7)
    assert isinstance(sup, DeviceSupervisor) and sup.oldest_version == 7
    assert sup.resolve_batch(9, []) == []  # the first resolve builds the set
    assert isinstance(sup._dev, DeviceConflictSet)
    assert sup._dev.device.type == "cpu" and sup._dev.capacity == 1 << 10
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec._backend_factory("supervised", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.run_spec("backend=supervised\ntestName=Cycle\nnodes=4\n")
    m = spec.run_spec("testName=Cycle\nnodes=4\nclients=1\ntxnsPerClient=2\n")
    assert m["Cycle"]["committed"] == 2
    with pytest.raises(ValueError, match="unknown backend"):
        spec.run_spec("backend=tpu\ntestName=Cycle\n", device="cpu")


def test_the_port_reads_no_environment():
    src = pathlib.Path(spec.__file__).read_text()
    assert "os.environ" not in src and "getenv" not in src
