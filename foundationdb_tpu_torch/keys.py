"""Fixed-width key encoding, and the torch lane layout the kernels use.

Host side (numpy, byte-identical to the reference package's encoder): a key
of up to ``4*num_words`` bytes becomes ``num_words`` big-endian uint32
words (zero padded) followed by one length word:

    enc(k) = (w_0, ..., w_{n-1}, len(k))

Lexicographic order over the ``n+1`` uint32 lanes equals byte-string order
(the length word breaks zero-padding ties such as ``b"a"`` vs
``b"a\\x00"``).  A sentinel of all-0xFFFFFFFF lanes sorts after every real
key and pads unused slots.

Device side: torch cannot compare uint32 tensors on the CPU, so every lane
lives in torch as ``int32`` holding ``u32 ^ 0x80000000``.  Signed order of
the flipped lanes equals the unsigned order above, the sentinel becomes
``0x7FFFFFFF`` (still the largest value), and the length-lane ``+ 1``
upper-bound trick wraps exactly as uint32 does: ``lane_inc`` maps
flip(0xFFFFFFFF) to flip(0).  `to_lanes` / `from_lanes` are the only
crossings between the two layouts.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

# Default: 32-byte keys -> 8 data words + 1 length word.  The reference's
# published benchmarks use 16-byte keys (documentation/sphinx/source/
# performance.rst:14); 32 gives headroom for tuple-encoded keys.
DEFAULT_MAX_KEY_BYTES = 32

SIGN_FLIP = np.uint32(0x80000000)
SENT_LANE = 0x7FFFFFFF  # flipped 0xFFFFFFFF: the sentinel lane value
I32_MIN = -(1 << 31)


def num_words(max_key_bytes: int = DEFAULT_MAX_KEY_BYTES) -> int:
    """Total lanes per encoded key (data words + 1 length word)."""
    if max_key_bytes <= 0 or max_key_bytes % 4:
        raise ValueError("max_key_bytes must be a positive multiple of 4")
    return max_key_bytes // 4 + 1


def sentinel(max_key_bytes: int = DEFAULT_MAX_KEY_BYTES) -> np.ndarray:
    """A key greater than any encodable key; pads unused device slots."""
    return np.full((num_words(max_key_bytes),), 0xFFFFFFFF, dtype=np.uint32)


def encode_keys(keys: list[bytes], max_key_bytes: int = DEFAULT_MAX_KEY_BYTES) -> np.ndarray:
    """Encode a list of byte keys -> uint32[len(keys), num_words].

    Raises KeyTooLongError for keys longer than max_key_bytes."""
    n = len(keys)
    if n == 0:
        return np.zeros((n, num_words(max_key_bytes)), dtype=np.uint32)
    lens = np.fromiter(map(len, keys), count=n, dtype=np.int64)
    return encode_concat(b"".join(keys), lens, max_key_bytes)


class _EncodeScratch(threading.local):
    """Grow-only staging buffers reused across encode_concat calls;
    thread-local so concurrent packers never share a buffer."""

    def __init__(self) -> None:
        self.flatp = np.zeros(0, dtype=np.uint8)
        self.idx: np.ndarray | None = None
        self.buf: np.ndarray | None = None
        self.mask: np.ndarray | None = None

    def stream(self, flat: np.ndarray, L: int, pad: int) -> np.ndarray:
        need = L + pad
        if self.flatp.size < need:
            self.flatp = np.zeros(max(need, 2 * self.flatp.size), np.uint8)
        self.flatp[:L] = flat
        self.flatp[L:need] = 0  # pad region may hold a previous stream
        return self.flatp

    def chunk(self, rows: int, width: int, idt) -> tuple:
        if (
            self.idx is None
            or self.idx.dtype != idt
            or self.idx.shape[0] < rows
            or self.idx.shape[1] != width
        ):
            self.idx = np.empty((rows, width), dtype=idt)
            self.buf = np.empty((rows, width), dtype=np.uint8)
            self.mask = np.empty((rows, width), dtype=bool)
        return self.idx[:rows], self.buf[:rows], self.mask[:rows]


_scratch = _EncodeScratch()


def encode_concat(
    flat: bytes | bytearray | memoryview | np.ndarray,
    lens: np.ndarray,
    max_key_bytes: int = DEFAULT_MAX_KEY_BYTES,
) -> np.ndarray:
    """Batch encoder over an already-concatenated byte stream: key i occupies
    flat[sum(lens[:i]) : sum(lens[:i+1])].  One vectorized gather per 8192
    keys, no per-key Python call (the bulk batch packer encodes every
    conflict-range endpoint of a batch in one call)."""
    kw = num_words(max_key_bytes) - 1  # validates max_key_bytes
    lens = np.asarray(lens, dtype=np.int64)
    n = lens.shape[0]
    out = np.zeros((n, kw + 1), dtype=np.uint32)
    if n == 0:
        return out
    if isinstance(flat, np.ndarray):
        flat = np.ascontiguousarray(flat, dtype=np.uint8)
    else:
        flat = np.frombuffer(flat, dtype=np.uint8)
    if lens.max() > max_key_bytes:
        i = int(np.argmax(lens))
        raise KeyTooLongError(f"key of {int(lens[i])} bytes exceeds {max_key_bytes}")
    L = len(flat)
    flatp = _scratch.stream(flat, L, max_key_bytes)
    # gather indices reach L + max_key_bytes - 1 (the zero pad)
    idt = np.int32 if L + max_key_bytes < 2**31 else np.int64
    starts = np.zeros(n, dtype=idt)
    np.cumsum(lens[:-1], out=starts[1:], dtype=idt)
    cols = np.arange(max_key_bytes, dtype=idt)
    lens_t = lens.astype(idt)
    out[:, kw] = lens
    # reads past a key's end land in the next key's bytes or the zero pad,
    # and the mask multiply zeroes them; a chunk's gather indices stay
    # within 2 MB however wide the keys
    step = min(8192, max(32, (1 << 19) // max_key_bytes))
    idx, buf, mask = _scratch.chunk(min(step, n), max_key_bytes, idt)
    for i in range(0, n, step):
        j = min(i + step, n)
        c = j - i
        np.add(starts[i:j, None], cols[None, :], out=idx[:c])
        np.take(flatp, idx[:c], out=buf[:c])
        np.less(cols[None, :], lens_t[i:j, None], out=mask[:c])
        np.multiply(buf[:c], mask[:c], out=buf[:c], casting="unsafe")
        out[i:j, :kw] = buf[:c].view(">u4")
    return out


def encode_fixed(
    key_bytes: np.ndarray, max_key_bytes: int = DEFAULT_MAX_KEY_BYTES
) -> np.ndarray:
    """Encode uint8[n, L] equal-length keys -> uint32[n, num_words] lanes."""
    kw = num_words(max_key_bytes) - 1
    n, L = key_bytes.shape
    if L > max_key_bytes:
        raise KeyTooLongError(f"{L}-byte keys exceed {max_key_bytes}")
    out = np.zeros((n, kw + 1), dtype=np.uint32)
    padded = np.zeros((n, 4 * kw), dtype=np.uint8)
    padded[:, :L] = key_bytes
    out[:, :kw] = (
        (padded[:, 0::4].astype(np.uint32) << 24)
        | (padded[:, 1::4].astype(np.uint32) << 16)
        | (padded[:, 2::4].astype(np.uint32) << 8)
        | padded[:, 3::4].astype(np.uint32)
    )
    out[:, kw] = L
    return out


def decode_key(enc: np.ndarray) -> bytes:
    """Inverse of encode_keys for a single encoded key."""
    kw = enc.shape[-1] - 1
    length = int(enc[kw])
    b = bytearray()
    for w in range(kw):
        v = int(enc[w])
        b += bytes(((v >> 24) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF))
    return bytes(b[:length])


class KeyTooLongError(ValueError):
    pass


def grown_key_bytes(need: int) -> int:
    """The key width a set widens to for an endpoint of `need` bytes: the
    least power of two of bytes that holds it (32 -> 64 -> ... -> 16384 ->
    32768 -> ...).  There is no fixed ceiling: a set widens until the card
    cannot hold its buffers (conflict/device.py `_widen` then raises
    KeyTooLongError).  From 1024 bytes (W = 257 lanes) K1 and K3 take
    their warp plans (conflict/kernels.WARP_FROM_W, plan_probe,
    plan_ranks)."""
    return max(4, 1 << (need - 1).bit_length())


def widen_lanes(rows: torch.Tensor, W: int) -> torch.Tensor:
    """Flipped lane rows [..., W0] at the wider width W: the encoding with
    W - 1 data words, exactly as `encode_keys` would give it.  A real key
    gains zero words, flip(0) = INT32_MIN, before its length lane.  A row
    that grew from the sentinel (all data words 0xFFFFFFFF, and a length
    lane no real key of that width has: the sentinel's own, or flip(0)
    after `lane_inc` wrapped it) gains SENT_LANE words, as the sentinel at
    width W has.  A real key with all-0xFF data words has length 4*(W0-1).
    Returns a fresh tensor; `rows` unchanged when already W wide."""
    W0 = rows.shape[-1]
    if W == W0:
        return rows
    if W < W0:
        raise ValueError(f"cannot narrow lanes from W={W0} to W={W}")
    data, length = rows[..., :-1], rows[..., -1:]
    real_len = (length > I32_MIN) & (length <= I32_MIN + 4 * (W0 - 1))
    sent = (data == SENT_LANE).all(dim=-1, keepdim=True) & ~real_len
    fill = torch.where(sent, SENT_LANE, I32_MIN).to(rows.dtype)
    fill = fill.expand(*rows.shape[:-1], W - W0)
    return torch.cat([data, fill, length], dim=-1)


def key_after(key: bytes) -> bytes:
    """First key strictly after ``key``: key + b'\\x00' (reference:
    fdbclient/FDBTypes.h keyAfter)."""
    return key + b"\x00"


def strinc(key: bytes) -> bytes:
    """First key not prefixed by ``key`` (reference: flow strinc): strip
    trailing 0xFF bytes then increment the last byte."""
    k = key.rstrip(b"\xff")
    if not k:
        raise ValueError("strinc of all-0xFF key has no upper bound")
    return k[:-1] + bytes([k[-1] + 1])


def to_lanes(rows: np.ndarray, device=None) -> torch.Tensor:
    """uint32 lane rows (the numpy encoding) -> int32 tensor of flipped
    lanes, on `device` (CPU when None).  Always a fresh buffer: the XOR
    allocates, so the tensor never aliases the caller's array."""
    flipped = (np.asarray(rows, dtype=np.uint32) ^ SIGN_FLIP).view(np.int32)
    t = torch.from_numpy(flipped)
    return t if device is None else t.to(device)


def from_lanes(t: torch.Tensor) -> np.ndarray:
    """Inverse of `to_lanes`: int32 flipped lanes -> fresh uint32 array."""
    a = t.detach().to("cpu").contiguous().numpy()
    return a.view(np.uint32) ^ SIGN_FLIP


def lane_inc(lane: torch.Tensor) -> torch.Tensor:
    """`lane + 1` with uint32 wrap-around in the flipped layout: the
    sentinel lane 0x7FFFFFFF becomes flip(0) = INT32_MIN, as
    0xFFFFFFFF + 1 wraps to 0 in the reference's uint32 lanes.  Written
    without signed overflow, so it is defined on every backend."""
    return torch.where(
        lane == SENT_LANE, I32_MIN, lane.clamp(max=SENT_LANE - 1) + 1
    )


def with_last_lane_inc(rows: torch.Tensor) -> torch.Tensor:
    """rows with `lane_inc` applied to the length lane — upper_bound(k)
    == lower_bound((words, len+1)), since no key lies strictly between
    (w, len) and (w, len+1) in the lane encoding."""
    return torch.cat([rows[:, :-1], lane_inc(rows[:, -1:])], dim=1)
