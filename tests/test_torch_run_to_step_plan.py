"""K4's thread-to-element map on the CPU: a numpy model of
run_to_step_kernel (csrc/conflict_kernels.cu) with the kernel's own index
arithmetic in 32-bit unsigned integers, the wrapper's multiply-shift
constants, row-aligned chunks and block tiling (kernels.plan_run_to_step),
a run a grid row, a chunk a grid layer.  Every element of rows and vals
must be written exactly once and equal run_to_step_runs_plain; at the
widest shapes, the offsets are checked against the exact 64-bit formula
without allocating the rows."""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.keys import SENT_LANE

MASK = np.uint64(0xFFFFFFFF)


def u32(x):
    """A uint64 array cut to the 32 bits a CUDA `unsigned` holds."""
    return np.asarray(x, dtype=np.uint64) & MASK


def step_rows(o, plan):
    """The kernel's row of in-run element o: umulhi(o, magic) >> shift, or
    o itself where magic is 0 (W = 1)."""
    o = u32(o)
    if plan.magic == 0:
        return o
    return u32((o * np.uint64(plan.magic)) >> np.uint64(32)) >> np.uint64(plan.shift)


def thread_elements(plan, blocks):
    """In-chunk element of every (block, u, thread) the kernel runs for the
    given blockIdx.x values: first = block * (STEP_PER * threads) +
    threadIdx.x, o = first + u * threads, all in 32 bits.  Shape [blocks,
    STEP_PER, threads]."""
    T, per = kernels.STEP_THREADS, kernels.STEP_PER
    bx = np.asarray(blocks, dtype=np.uint64)[:, None, None]
    u = np.arange(per, dtype=np.uint64)[None, :, None]
    tid = np.arange(T, dtype=np.uint64)[None, None, :]
    first = u32(u32(bx * np.uint64(per * T)) + tid)
    return u32(first + u * np.uint64(T))


def chunk_elements(plan, rcap, W, z, blocks):
    """The kernel's view of chunk z: its first step row z_row (32-bit), its
    element count n, and the in-chunk elements o < n that the given blocks
    write, with their rows r and source elements src in the chunk's begins
    or ends."""
    z_row = int(u32(z * plan.chunk_rows))
    n = int(u32(min(plan.chunk_rows, int(u32(2 * rcap - z_row))) * W))
    o = thread_elements(plan, blocks).reshape(-1)
    o = o[o < np.uint64(n)]
    r = step_rows(o, plan)
    src = u32(o - u32(u32((r + np.uint64(1)) >> np.uint64(1)) * np.uint64(W)))
    return z_row, n, o, r, src


def model(runs_b, runs_e, runs_ver, plan):
    """rows, vals and each element's write count, as the kernel computes
    them under `plan`, grid (plan.blocks, K, plan.chunks)."""
    K, rcap, W = runs_b.shape
    b = runs_b.reshape(-1).numpy()
    e = runs_e.reshape(-1).numpy()
    rows = np.full(K * 2 * rcap * W, -7, np.int32)
    vals = np.full(K * 2 * rcap, -7, np.int32)
    row_writes = np.zeros(K * 2 * rcap * W, np.int64)
    val_writes = np.zeros(K * 2 * rcap, np.int64)
    for z in range(plan.chunks):  # blockIdx.z
        z_row, _n, o, r, src = chunk_elements(plan, rcap, W, z, range(plan.blocks))
        last = u32(o - u32(r * np.uint64(W))) == np.uint64(W - 1)
        odd = (r & np.uint64(1)).astype(bool)
        o, r, src = (x.astype(np.int64) for x in (o, r, src))
        for k in range(K):  # blockIdx.y
            row0 = 2 * k * rcap + z_row  # size_t in the kernel, even
            base = (row0 >> 1) * W
            v = np.where(odd, e[base + src], b[base + src])
            rows[row0 * W + o] = v
            np.add.at(row_writes, row0 * W + o, 1)
            live = ~odd[last] & (v[last] != SENT_LANE)
            vals[row0 + r[last]] = np.where(live, int(runs_ver[k]), 0)
            np.add.at(val_writes, row0 + r[last], 1)
    return (torch.from_numpy(rows.reshape(K, 2 * rcap, W)),
            torch.from_numpy(vals.reshape(K, 2 * rcap)), row_writes, val_writes)


def chunked(rcap, W, chunks):
    """plan_run_to_step's plan with a run cut into `chunks` balanced chunks,
    as it cuts a run of 2**31 step elements or more: the kernel takes any
    even chunk_rows, so small shapes exercise the cut."""
    plan = kernels.plan_run_to_step(rcap, W)
    rows = 2 * -(-rcap // chunks)
    return plan._replace(chunk_rows=rows, chunks=-(-2 * rcap // rows),
                         blocks=-(-rows * W // (kernels.STEP_THREADS * kernels.STEP_PER)))


def runs(seed, K, rcap, W):
    """K runs of random rows with sentinel tails; run 1 dead (version 0)
    where K > 1, run 2 all sentinel where K > 2."""
    rng = np.random.default_rng(seed)
    b = rng.integers(-(1 << 31), (1 << 31) - 1, size=(K, rcap, W), dtype=np.int64)
    e = rng.integers(-(1 << 31), (1 << 31) - 1, size=(K, rcap, W), dtype=np.int64)
    for k in range(K):
        live = int(rng.integers(0, rcap + 1))
        b[k, live:] = e[k, live:] = SENT_LANE
    ver = rng.integers(1, 1 << 20, K)
    if K > 1:
        ver[1] = 0
    if K > 2:
        b[2] = e[2] = SENT_LANE
    return (torch.from_numpy(b.astype(np.int32)), torch.from_numpy(e.astype(np.int32)),
            torch.from_numpy(ver.astype(np.int32)))


@pytest.mark.parametrize("W", [5, 17, 65, 4097])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_model_writes_each_element_once_and_equals_the_plain_version(K, W):
    rcap = 13 if W == 4097 else 509  # 2 rcap W is no multiple of a tile
    args = runs(10 * K + W, K, rcap, W)
    plan = kernels.plan_run_to_step(rcap, W)
    assert plan.chunks == 1 and plan.chunk_rows == 2 * rcap
    assert (2 * rcap * W) % (kernels.STEP_THREADS * kernels.STEP_PER) != 0
    rows, vals, row_writes, val_writes = model(*args, plan)
    assert (row_writes == 1).all() and (val_writes == 1).all()
    want_rows, want_vals = kernels.run_to_step_runs_plain(*args)
    assert torch.equal(rows, want_rows) and torch.equal(vals, want_vals)
    if K > 2:  # the dead run's and the all-sentinel run's values are 0
        assert not vals[1].any() and not vals[2].any()


@pytest.mark.parametrize("chunks", [1, 2, 3, 5])
@pytest.mark.parametrize("W", [1, 2, 3, 9])
def test_model_at_narrow_widths_and_in_chunks(chunks, W):
    """A run cut into row-aligned chunks, the last one shorter (37 row
    pairs in 2, 3 or 5), each element still written once, equal to the
    plain version."""
    args = runs(chunks + W, 3, 37, W)
    plan = chunked(37, W, chunks)
    assert plan.chunks == chunks and plan.chunk_rows % 2 == 0
    rows, vals, row_writes, val_writes = model(*args, plan)
    assert (row_writes == 1).all() and (val_writes == 1).all()
    want = kernels.run_to_step_runs_plain(*args)
    assert torch.equal(rows, want[0]) and torch.equal(vals, want[1])


def test_multiply_shift_divides_every_31_bit_index():
    """o // W by the plan's constants, at every width a set takes and
    others, on the indices around each multiple of W and at the ends of
    the 31-bit range."""
    rng = np.random.default_rng(0)
    widths = [1, 2, 3, 5, 7, 9, 17, 65, 129, 257, 513, 4097, 8193, 16385, 32769,
              65537, 131073, 262145, (1 << 30) + 1, (1 << 31) - 1,
              *rng.integers(2, 1 << 20, 40)]
    for W in map(int, widths):
        magic, shift = kernels.step_divisor(W)
        assert 0 <= magic < 1 << 32 and 0 <= shift < 32
        m = np.arange(0, (1 << 31) // W + 1, max(1, ((1 << 31) // W) // 2000),
                      dtype=np.uint64)
        o = np.concatenate([m * np.uint64(W), m * np.uint64(W) - np.uint64(1),
                            m * np.uint64(W) + np.uint64(W - 1),
                            rng.integers(0, 1 << 31, 2000).astype(np.uint64),
                            np.array([0, (1 << 31) - 1], np.uint64)])
        o = o[o < np.uint64(1 << 31)]
        got = step_rows(o, kernels.StepPlan(magic, shift, 2, 1, 1))
        assert np.array_equal(got, o // np.uint64(W)), W


def exact_offsets(plan, K, rcap, W, seed):
    """For runs 0, K // 2 and K - 1 and every chunk of `plan`, the kernel's
    output and input offsets of the elements of its first, last and random
    blocks, checked against the exact 64-bit formula (row and lane of the
    element in the [K, 2 rcap, W] rows; its input row is half the row),
    without allocating anything."""
    rng = np.random.default_rng(seed)
    blocks = [0, 1, plan.blocks - 1, *rng.integers(0, plan.blocks, 30)]
    for z in range(plan.chunks):
        z_row, n, o, r, src = chunk_elements(plan, rcap, W, z, blocks)
        assert n < 1 << 31 and int(o.max()) == n - 1
        lane = u32(o - u32(r * np.uint64(W)))
        o_i, r_i, src_i, lane_i = (x.astype(object) for x in (o, r, src, lane))
        for k in sorted({0, K // 2, K - 1}):
            row0 = 2 * k * rcap + z_row  # size_t in the kernel
            out = row0 * W + o_i          # rows + row0 W, then [o]
            inp = (row0 // 2) * W + src_i  # runs_b or runs_e + row0 / 2 W, then [src]
            flat = (2 * k * rcap + z * plan.chunk_rows) * W + o_i
            row, w = flat // W, flat % W
            assert (row == row0 + r_i).all() and (w == lane_i).all()
            assert (out == row * W + w).all()
            assert (inp == (row // 2) * W + w).all()


def test_offsets_past_2_31_output_elements():
    """8 runs of 4096 rows at W = 32769 (131072-byte keys): 2**31 + 65536
    step elements in all.  Each run's index stays 32-bit and below 2**31,
    a run one chunk; the kernel's 64-bit base plus it is the exact offset
    of the element's row and lane, in the rows and in the input."""
    K, rcap, W = 8, 4096, 32769
    plan = kernels.plan_run_to_step(rcap, W)
    n = 2 * rcap * W
    assert K * n == (1 << 31) + 65536 and n < 1 << 31
    assert plan.chunks == 1 and plan.chunk_rows == 2 * rcap
    tile = kernels.STEP_THREADS * kernels.STEP_PER
    assert plan.blocks == -(-n // tile) and plan.blocks * tile < 1 << 32
    exact_offsets(plan, K, rcap, W, 1)
    assert 2 * (K - 1) * rcap * W + n - 1 > (1 << 31) - 1  # needs the 64-bit base


def test_offsets_of_a_run_past_2_31_step_elements():
    """2 runs of 16384 rows at W = 65537 (262144-byte keys): each run's
    2**31 + 32768 step elements do not fit a 32-bit index, so the plan cuts
    each into 2 chunks of 16384 step rows, and every chunk's offsets are
    exact; 3 rows at W = 2**30 - 1 need a chunk a row pair."""
    K, rcap, W = 2, 16384, 65537
    plan = kernels.plan_run_to_step(rcap, W)
    assert 2 * rcap * W > (1 << 31) - 1
    assert plan.chunks == 2 and plan.chunk_rows == rcap
    assert plan.chunk_rows * W <= kernels.STEP_MAX_ELEMS
    exact_offsets(plan, K, rcap, W, 2)
    wide = kernels.plan_run_to_step(3, (1 << 30) - 1)
    assert wide.chunks == 3 and wide.chunk_rows == 2
    exact_offsets(wide, 2, 3, (1 << 30) - 1, 3)


def test_plan_is_a_pure_function_of_the_shapes():
    tile = kernels.STEP_THREADS * kernels.STEP_PER
    for rcap, W in ((16384, 5), (509, 17), (4096, 4097), (4096, 32769), (1, 1),
                    (16384, 65537), (37, (1 << 28) + 1)):
        plan = kernels.plan_run_to_step(rcap, W)
        kernels.plan_run_to_step.cache_clear()
        assert kernels.plan_run_to_step(rcap, W) == plan
        # the fewest chunks a 32-bit index allows, balanced, each even
        pairs = kernels.STEP_MAX_ELEMS // (2 * W)
        assert plan.chunks == -(-rcap // pairs)
        assert plan.chunk_rows == 2 * -(-rcap // plan.chunks)
        assert plan.chunk_rows * W <= kernels.STEP_MAX_ELEMS
        assert (plan.chunks - 1) * plan.chunk_rows < 2 * rcap <= plan.chunks * plan.chunk_rows
        assert plan == kernels.StepPlan(*kernels.step_divisor(W), plan.chunk_rows,
                                        plan.chunks, -(-plan.chunk_rows * W // tile))


def test_plan_raises_past_its_grid_and_index():
    kernels.plan_run_to_step(16384, 65535)  # 2**31 - 2 * 16384 elements: one chunk
    with pytest.raises(ValueError, match="at most"):
        kernels.plan_run_to_step(1, 1 << 30)  # a row pair past a 32-bit index
    with pytest.raises(ValueError, match="chunks"):
        kernels.plan_run_to_step(65536, (1 << 30) - 1)  # a chunk a row pair: 65536
    with pytest.raises(ValueError, match="one lane"):
        kernels.plan_run_to_step(64, 0)
