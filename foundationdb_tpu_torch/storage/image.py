"""Restart images — the saved half of a restarting test pair
(fdbserver/workloads/SaveAndKill.actor.cpp: part 1 copies the simulated
disks plus a restart manifest out of the dying simulation; part 2 —
tester.actor.cpp:1118 — boots a second process-lifetime from exactly that
directory).

An image is a host directory holding the crash-surviving contents of every
simulated disk (`SimFilesystem`'s synced prefixes — the power-kill already
dropped everything an fsync had not made durable) plus `manifest.json`:
the seed, the cluster/spec configuration, and each workload's invariant
state, so part 2 can refuse a mismatched reboot instead of silently
checking the wrong invariants against the wrong disks.

Torn-save discipline: the whole image is staged in a sibling directory
and swapped into place only once complete (payloads first, manifest LAST
and atomically within the staging dir), so a part-1 process dying
mid-save leaves either a complete image — the previous one, if `outdir`
was a reused save directory — or a directory `load_image` refuses
with a clear error; never a half image that boots, and never a good
image destroyed by a failed re-save.  Every payload carries a crc32 the
loader re-verifies.  The `restart.manifest_corrupt` buggify site plants a torn
manifest temp file next to a good save (the leftover shape a crashed
earlier attempt leaves) so chaos campaigns exercise the loader's
tolerance for it.

Copy of the reference package's module, on the port's own modules."""

from __future__ import annotations

import binascii
import glob
import json
import os
import shutil
from urllib.parse import quote

from ..runtime.buggify import buggify
from ..runtime.coverage import testcov

IMAGE_FORMAT = 1
MANIFEST = "manifest.json"


class RestartImageError(Exception):
    """A restart image that must not boot: missing, torn, or corrupt."""


def save_image(fs, outdir: str, manifest: dict) -> str:
    """Serialize `fs`'s durable contents + `manifest` under `outdir`.

    Call AFTER the power-kill: what is saved is each file's synced prefix
    (`SimFile.read_durable` semantics) — the kill has already dropped the
    un-fsynced buffers, so the image is exactly what a machine's disks
    hold when the datacenter power comes back.
    """
    # stage the whole image beside its destination and swap at the end:
    # a reused outdir (a fixed save directory) keeps its previous
    # good image until the replacement is COMPLETE, and a crash anywhere
    # in here leaves only junk the loader refuses or never reads.
    # drop stale staging siblings first — but ONLY those whose owning
    # process is dead (a crashed earlier save left them; they were never
    # an image and never will be).  A live pid may be a concurrent saver
    # into this shared dir: deleting its staging mid-save would fail a
    # healthy run, so leave it alone.
    for stale in glob.glob(glob.escape(outdir.rstrip("/\\")) + ".saving-*"):
        try:
            os.kill(int(stale.rsplit("-", 1)[-1]), 0)
        except (ProcessLookupError, ValueError):
            shutil.rmtree(stale, ignore_errors=True)
        except PermissionError:
            pass  # pid exists under another user — treat as live
    staging = outdir.rstrip("/\\") + f".saving-{os.getpid()}"
    if os.path.exists(staging):
        shutil.rmtree(staging)  # my own staging path is mine regardless
    try:
        files_dir = os.path.join(staging, "files")
        os.makedirs(files_dir)
        file_meta: dict[str, dict] = {}
        for path, data in fs.durable_items():
            with open(os.path.join(files_dir, quote(path, safe="")),
                      "wb") as f:
                f.write(data)
            file_meta[path] = {
                "size": len(data),
                "crc32": binascii.crc32(data) & 0xFFFFFFFF,
            }
        doc = dict(manifest)
        doc["format"] = IMAGE_FORMAT
        doc["files"] = file_meta
        blob = json.dumps(doc, indent=2, sort_keys=True, default=str).encode()
        mpath = os.path.join(staging, MANIFEST)
        if buggify("restart.manifest_corrupt"):
            # a crashed earlier save attempt leaves a torn temp next to the
            # image; the loader must ignore it and read only MANIFEST proper
            with open(mpath + ".tmp", "wb") as f:
                f.write(blob[: max(1, len(blob) // 2)])
        tmp = mpath + f".{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, mpath)  # the manifest appears whole or not at all
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)  # a failed save owns
        raise                                       # its partial copy
    if os.path.exists(outdir):
        # the old image dies only AFTER its replacement is whole; a crash
        # mid-rmtree leaves a manifest missing payloads (or none at all),
        # both of which load_image refuses.  ignore_errors: a concurrent
        # saver racing this swap may have removed it first — last writer
        # wins on a shared dir, and the rename below still errors loudly
        # if the destination genuinely cannot be replaced
        shutil.rmtree(outdir, ignore_errors=True)
    os.rename(staging, outdir)
    testcov("restart.image_saved")
    return outdir


def load_image(indir: str) -> tuple[dict[str, bytes], dict]:
    """-> ({sim path: durable bytes}, manifest).  Refuses torn images:
    a missing/unparseable manifest (part 1 died mid-save) or a payload
    whose size/crc32 disagrees with the manifest raises RestartImageError
    — part 2 must never boot from half a disk image."""
    mpath = os.path.join(indir, MANIFEST)
    if not os.path.exists(mpath):
        raise RestartImageError(
            f"{indir}: no {MANIFEST} — part 1 never completed its save "
            f"(a torn temp file is not a manifest)"
        )
    try:
        with open(mpath, encoding="utf-8") as f:
            doc = json.load(f)
    except ValueError as e:
        raise RestartImageError(f"{mpath}: torn or corrupt manifest: {e}") from None
    if doc.get("format") != IMAGE_FORMAT:
        raise RestartImageError(
            f"{mpath}: image format {doc.get('format')!r}, "
            f"this build reads {IMAGE_FORMAT}"
        )
    files: dict[str, bytes] = {}
    for path, meta in doc.get("files", {}).items():
        fp = os.path.join(indir, "files", quote(path, safe=""))
        try:
            with open(fp, "rb") as f:
                data = f.read()
        except OSError:
            raise RestartImageError(
                f"{indir}: manifest names {path!r} but its payload is missing"
            ) from None
        if len(data) != meta["size"] or (
            binascii.crc32(data) & 0xFFFFFFFF
        ) != meta["crc32"]:
            raise RestartImageError(
                f"{indir}: payload for {path!r} fails its size/crc32 check "
                f"(torn or corrupted image)"
            )
        # manifest keys are the RAW sim paths (only the on-disk payload
        # filenames are quote()d) — no decode, or a path that happens to
        # contain a %XX sequence would restore under a different name
        files[path] = data
    testcov("restart.image_loaded")
    return files, doc


def restore_filesystem(files: dict[str, bytes]):
    """A fresh SimFilesystem whose disks hold exactly `files` as durable
    contents — pass to RecoverableCluster(fs=..., restart=True), whose
    __init__ reattaches it to the new cluster's loop/rng."""
    from .files import SimFilesystem

    return SimFilesystem.from_durable_items(files)
