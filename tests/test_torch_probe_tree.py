"""K5's launch plan and a model of its kernel (csrc/conflict_kernels.cu:
tree_row, probe_tree_kernel), and the per-query referee's grid, kept here
and not in the package.

K5 runs a tile of reads a thread-block cluster, block c of it searching
runs c, c + C, ... for every read of the tile; a block stages the top L
levels of its run's binary-search tree breadth first (node e at the run
row tree_row(e, run_cap)), a warp copying consecutive lanes of 32 / W
rows a pass; a search descends the staged levels, finishes in global
memory and compares its begin with ends[rank - 1]; the leader block ORs
the verdicts.  The numpy model below follows that index map and is held
bit for bit against run_conflicts_plain, its ranks against lower_bound,
and against the JAX reference's Pallas probe in interpret mode, on seeded
inputs with sentinel tails, all-sentinel and dead runs, reads touching
run boundaries, run capacities that are not powers of two, ragged tiles
and R = 1."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from foundationdb_tpu.conflict import pallas_kernel as pk
from foundationdb_tpu_torch import keys
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.ops.search import lower_bound

SENT = 0xFFFFFFFF
P = kernels.ProbeTreePlan


# ---------------------------------------------------------------------------
# the planner


@pytest.mark.parametrize("W,levels", [(5, 7), (17, 5), (65, 4), (257, 2), (1023, 1),
                                      (1024, 0), (4097, 0)])
def test_plan_levels_by_width(W, levels):
    """The most levels (at most PROBE_TREE_LEVELS) whose nodes fit
    PROBE_TREE_BYTES; none where not even the root's does."""
    plan = kernels.plan_probe_tree(8, 16384, W)
    assert plan == P(levels, kernels.PROBE_TREE_READS, 8)
    assert kernels.probe_tree_bytes(levels, W) <= kernels.PROBE_TREE_BYTES
    if levels < kernels.PROBE_TREE_LEVELS:
        assert kernels.probe_tree_bytes(levels + 1, W) > kernels.PROBE_TREE_BYTES
    if levels == 0:
        assert 4 * (W + 1) > kernels.PROBE_TREE_BYTES


@pytest.mark.parametrize("run_cap,depth,levels", [(1, 1, 1), (2, 2, 2), (3, 2, 2),
                                                  (1000, 10, 7), (16383, 14, 7),
                                                  (16384, 15, 7)])
def test_plan_levels_never_pass_the_tree(run_cap, depth, levels):
    """A search of run_cap rows makes at most ceil(log2(run_cap + 1))
    compares: no plan stages deeper than that."""
    assert kernels.tree_depth(run_cap) == depth
    assert kernels.plan_probe_tree(8, run_cap, 5).levels == levels
    assert all(p.levels <= depth for p in kernels.probe_tree_plans(8, run_cap, 5))


@pytest.mark.parametrize("K,cluster", [(0, 1), (1, 1), (2, 2), (8, 8), (9, 9), (16, 16),
                                       (17, 9), (32, 16), (33, 11), (100, 15)])
def test_plan_cluster_deals_out_the_runs(K, cluster):
    """A block a run up to 16 runs; past that the fewest runs a block, and
    no block without a run."""
    plan = kernels.plan_probe_tree(K, 16384, 5)
    assert plan.cluster == cluster <= kernels.PROBE_TREE_MAX_CLUSTER
    if K:
        per_block = -(-K // cluster)
        assert per_block == -(-K // kernels.PROBE_TREE_MAX_CLUSTER)
        assert (cluster - 1) * per_block < K  # the last block has a run


def test_plan_is_a_pure_function_of_the_shapes():
    assert kernels.plan_probe_tree(8, 16384, 5) is kernels.plan_probe_tree(8, 16384, 5)


@pytest.mark.parametrize("K,run_cap,W", [(8, 16384, 5), (1, 1, 5), (9, 1000, 17),
                                         (17, 64, 65), (3, 13, 4097)])
def test_every_sweep_plan_is_taken(K, run_cap, W):
    """probe_tree_plans: the planned plan first, no plan twice, every one
    taken by the kernel (check_probe_tree_plan, the C entry's rules)."""
    plans = kernels.probe_tree_plans(K, run_cap, W)
    assert plans[0] == kernels.plan_probe_tree(K, run_cap, W)
    assert len(set(plans)) == len(plans)
    for plan in plans:
        kernels.check_probe_tree_plan(plan, 16384, W)
    assert {p.levels for p in plans} >= {0, plans[0].levels}


@pytest.mark.parametrize("plan,R,W", [
    (P(17, 256, 8), 100, 5), (P(-1, 256, 8), 100, 5), (P(7, 48, 8), 100, 5),
    (P(7, 2048, 8), 100, 5), (P(7, 16, 8), 100, 5), (P(7, 256, 0), 100, 5),
    (P(7, 256, 17), 100, 5), (P(14, 256, 8), 100, 5),  # 16383 x 24 B
    (P(1, 256, 8), 100, 60000),  # one node past a block
    (P(7, 256, 8), 65535 * 256 + 1, 5),  # 65536 tiles
])
def test_check_raises_where_the_kernel_refuses(plan, R, W):
    with pytest.raises(ValueError):
        kernels.check_probe_tree_plan(plan, R, W)


def test_check_takes_the_edges():
    kernels.check_probe_tree_plan(P(0, 32, 1), 1, 1)
    kernels.check_probe_tree_plan(P(7, 1024, 16), 65535 * 1024, 5)
    kernels.check_probe_tree_plan(P(11, 256, 8), 100, 5)  # 2047 x 24 + 1024 B


# ---------------------------------------------------------------------------
# a model of the kernel


def tree_row(e, n):
    """The kernel's tree_row: the run row of breadth-first node e, or -1."""
    lo, hi = 0, n
    for d in range(e.bit_length() - 2, -1, -1):
        if lo >= hi:
            return -1
        mid = lo + (hi - lo) // 2
        if (e >> d) & 1:
            lo = mid + 1
        else:
            hi = mid
    return lo + (hi - lo) // 2 if lo < hi else -1


def less(a, b):
    """Row-wise a < b over the last axis, lexicographic on int32 lanes."""
    diff = a != b
    first = np.where(diff.any(-1), diff.argmax(-1), 0)
    at = lambda x: np.take_along_axis(x, first[..., None], -1)[..., 0]  # noqa: E731
    return diff.any(-1) & (at(a) < at(b))


def staging_pass(W, reads, nodes):
    """(node, lane) of each copy a block of `reads` threads issues to stage
    `nodes` nodes, as the kernel maps them: a warp copies g = 32 // W rows
    a pass, lane l lane l % W of row l // W (W <= 32), or lanes l, l + 32,
    ... of one row."""
    g = 32 // W if W <= 32 else 1
    step_w = W if W <= 32 else 32
    out = []
    for tid in range(reads):
        lane = tid & 31
        sub = lane // W if W <= 32 else 0
        lane_w = lane - sub * (W if W <= 32 else 0)
        if sub >= g:
            continue
        for r in range((tid >> 5) * g + sub, nodes, (reads >> 5) * g):
            out.extend((r, w) for w in range(lane_w, W, step_w))
    return out


def model_probe(rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, plan):
    """K5 as the kernel computes it, with a record of what it read:
    returns (out, ranks {(read, run): rank}, staged {(tile, run)})."""
    levels, reads, C = plan
    R, W = rb.shape
    K, run_cap, _ = runs_b.shape
    nodes = (1 << levels) - 1
    pos = np.array([tree_row(e, run_cap) for e in range(1, nodes + 1)], np.int64)
    out = np.zeros(R, bool)
    ranks, staged = {}, set()
    for tile in range(-(-R // reads)):
        i = np.arange(tile * reads, min((tile + 1) * reads, R))
        live = r_ok[i]
        hit = np.zeros(len(i), bool)  # the leader's verdicts
        for c in range(C):
            conflict = np.zeros(len(i), bool)
            for k in range(c, K, C):
                need = live & ~conflict & (runs_ver[k] > snap[i])
                if levels:
                    if not need.any():
                        continue  # the block stages nothing of run k
                    staged.add((tile, k))
                    tree = np.full((nodes, W), 0x5A5A5A5A, np.int64)  # unstaged: garbage
                    for r, w in staging_pass(W, reads, nodes):
                        if pos[r] >= 0:
                            tree[r, w] = runs_b[k, pos[r], w]
                for j in np.nonzero(need)[0]:
                    q = re_[i[j]]
                    lo, hi, e = 0, run_cap, 1
                    for _d in range(levels):
                        if lo >= hi:
                            break
                        assert pos[e - 1] >= 0  # a search reads only staged nodes
                        below = bool(less(tree[e - 1], q))
                        mid = lo + (hi - lo) // 2
                        assert pos[e - 1] == mid
                        lo, hi, e = (mid + 1, hi, 2 * e + 1) if below else (lo, mid, 2 * e)
                    while lo < hi:
                        mid = lo + (hi - lo) // 2
                        if less(runs_b[k, mid], q):
                            lo = mid + 1
                        else:
                            hi = mid
                    ranks[(int(i[j]), k)] = lo
                    if lo > 0:
                        conflict[j] = bool(less(rb[i[j]], runs_e[k, lo - 1]))
            hit |= conflict
        out[i] = hit
    return out, ranks, staged


def _rows(rng, n, W, hi=1 << 10):
    """n sorted distinct key rows (uint32 layout), sentinel-padded."""
    words = rng.integers(0, hi, size=(n, W - 1)).astype(np.uint32)
    live = np.unique(np.concatenate([words, np.full((n, 1), 16, np.uint32)], 1), axis=0)
    return np.concatenate([live, np.full((n - len(live), W), SENT, np.uint32)])


def _run(rng, run_cap, n_live, W):
    """A sorted disjoint run of n_live intervals, sentinel-padded."""
    live = _rows(rng, max(2 * n_live, 1), W)
    live = live[live[:, -1] != SENT]
    m = min(len(live) // 2, run_cap)
    b = np.full((run_cap, W), SENT, np.uint32)
    e = b.copy()
    b[:m], e[:m] = live[0:2 * m:2], live[1:2 * m:2]
    return b, e


def _probe_case(seed, K=4, run_cap=64, R=200, W=5):
    """Seeded uint32 inputs: runs of different fill (one all sentinel),
    run 0 dead (version 0), reads half on run keys, a third touching run
    boundaries (end == a begin, begin == an end), sentinel reads."""
    rng = np.random.default_rng(seed)
    fills = [run_cap, run_cap // 2, 0, max(run_cap // 3, 1)]
    runs = [_run(rng, run_cap, fills[k % 4], W) for k in range(K)]
    runs_b = np.stack([r[0] for r in runs])
    runs_e = np.stack([r[1] for r in runs])
    runs_ver = rng.integers(1, 12, K).astype(np.int32)
    runs_ver[0] = 0
    q = _rows(rng, 2 * R, W)[rng.permutation(2 * R)]
    rb, re_ = np.minimum(q[:R], q[R:]), np.maximum(q[:R], q[R:])
    live_b = runs_b[runs_b[..., -1] != SENT]
    live_e = runs_e[runs_e[..., -1] != SENT]
    if len(live_b) > 1:
        on = rng.random(R) < 0.5
        rb[on] = np.minimum(rb[on], live_b[rng.integers(0, len(live_b), int(on.sum()))])
        n = R // 3
        j = rng.integers(0, len(live_b) - 1, n)
        rb[:n // 2], re_[:n // 2] = live_e[j[:n // 2]], live_b[j[:n // 2] + 1]
        rb[n // 2:n], re_[n // 2:n] = live_b[j[n // 2:]], live_b[j[n // 2:] + 1]
    rb[-2:] = re_[-2:] = SENT  # padding reads: end at the sentinel
    snap = rng.integers(0, 12, R).astype(np.int32)
    r_ok = rng.random(R) < 0.85
    r_ok[-1] = False
    return rb, re_, snap, r_ok, runs_b, runs_e, runs_ver


def _lanes(args):
    """(int64 numpy lanes for the model, torch tensors for the plain
    version) of _probe_case's inputs."""
    rb, re_, snap, r_ok, runs_b, runs_e, runs_ver = args
    t = (keys.to_lanes(rb), keys.to_lanes(re_), torch.from_numpy(snap),
         torch.from_numpy(r_ok), keys.to_lanes(runs_b), keys.to_lanes(runs_e),
         torch.from_numpy(runs_ver))
    return [x.numpy().astype(np.int64) if x.dtype == torch.int32 else x.numpy()
            for x in t], t


@pytest.mark.parametrize("n", [1, 2, 3, 7, 13, 64, 1000, 1023, 1024])
def test_tree_rows_are_the_search_tree(n):
    """Every row is the mid of exactly one node of the full tree, and each
    node lies between its children (a binary search tree of the run)."""
    depth = kernels.tree_depth(n)
    rows = {e: tree_row(e, n) for e in range(1, 1 << depth)}
    live = [r for r in rows.values() if r >= 0]
    assert sorted(live) == list(range(n))
    for e, r in rows.items():
        for child, side in ((2 * e, -1), (2 * e + 1, 1)):
            if r >= 0 and rows.get(child, -1) >= 0:
                assert (rows[child] - r) * side > 0
            if r < 0:
                assert rows.get(child, -1) < 0  # below an empty node, only empty


@pytest.mark.parametrize("W", [1, 2, 5, 17, 32, 33, 65, 257])
@pytest.mark.parametrize("reads", [32, 256, 1024])
def test_staging_copies_every_lane_of_every_node_once(W, reads):
    nodes = 127
    got = staging_pass(W, reads, nodes)
    assert sorted(got) == [(r, w) for r in range(nodes) for w in range(W)]


CASES = [  # (seed, K, run_cap, R, W, plan)
    (0, 4, 64, 200, 5, None),
    (1, 8, 1000, 300, 5, None),  # run_cap not a power of two: the whole tree staged
    (2, 3, 13, 77, 5, P(4, 32, 3)),
    (3, 9, 100, 130, 17, None),  # 9 blocks: non-portable cluster
    (4, 17, 50, 64, 5, None),  # 9 blocks, two runs a block
    (5, 4, 1, 40, 5, None),  # run_cap = 1
    (6, 4, 64, 1, 5, None),  # R = 1
    (7, 5, 200, 300, 9, P(0, 64, 5)),  # no staging
    (8, 5, 200, 300, 9, P(8, 128, 1)),  # one block: every run in turn
    (9, 2, 128, 257, 65, None),
]


@pytest.mark.parametrize("seed,K,run_cap,R,W,plan", CASES)
def test_model_equals_plain_bit_for_bit(seed, K, run_cap, R, W, plan):
    args = _probe_case(seed, K, run_cap, R, W)
    (rb, re_, snap, r_ok, runs_b, runs_e, runs_ver), t = _lanes(args)
    plan = plan or kernels.plan_probe_tree(K, run_cap, W)
    kernels.check_probe_tree_plan(plan, R, W)
    out, ranks, staged = model_probe(rb, re_, snap, r_ok, runs_b, runs_e, runs_ver, plan)
    want = kernels.run_conflicts_plain(*t).numpy()
    assert np.array_equal(out, want)
    # every rank is the lower bound; a pair is searched iff it has r_ok and
    # a snapshot below the run's version (stopping at a read's first conflict
    # inside a block)
    for k in range(K):
        lb = lower_bound(t[4][k], t[1]).numpy()
        for (i, kk), rank in ranks.items():
            if kk == k:
                assert rank == lb[i]
    assert all(r_ok[i] and runs_ver[k] > snap[i] for i, k in ranks)
    assert not any(runs_ver[k] == 0 for _t, k in staged)  # a dead run stages nothing
    if R > 1 and K > 2:
        assert out.any() and not out.all()


def test_sentinel_read_ends_rank_at_the_live_rows():
    """Sentinel rows tie: a read whose end is the sentinel ranks at the
    run's live rows, even across its sentinel tail."""
    args = _probe_case(11, 4, 64, 50, 5)
    (rb, re_, snap, r_ok, runs_b, runs_e, runs_ver), _t = _lanes(args)
    r_ok[:] = True
    snap[:] = 0
    runs_ver[:] = 5
    _out, ranks, _s = model_probe(rb, re_, snap, r_ok, runs_b, runs_e, runs_ver,
                                  kernels.plan_probe_tree(4, 64, 5))
    for k in range(4):
        n_live = int((runs_b[k][:, -1] != keys.SENT_LANE).sum())
        assert ranks[(49, k)] == n_live  # the last read: sentinel begin and end


@pytest.mark.parametrize("seed", [21, 22])
def test_model_equals_the_reference_pallas_probe(seed):
    """The model (and the plain version) against the JAX reference's
    _probe_kernel in interpret mode on the same seeded rows."""
    args = _probe_case(seed, 3, 128, 64, 5)
    (rb, re_, snap, r_ok, runs_b, runs_e, runs_ver), t = _lanes(args)
    want = np.asarray(pk.run_conflicts(*map(jnp.asarray, args), impl="interpret"))
    out, _r, _s = model_probe(rb, re_, snap, r_ok, runs_b, runs_e, runs_ver,
                              kernels.plan_probe_tree(3, 128, 5))
    assert np.array_equal(out, want)
    assert np.array_equal(kernels.run_conflicts(*t).numpy(), want)
    assert want.any() and not want.all()


# ---------------------------------------------------------------------------
# the per-query referee's grid


def referee_reads(R, threads):
    """The read each (block, thread) of the referee's grid takes, as the
    kernel maps them: ceil(R / threads) blocks, i = block * threads +
    thread, threads past R idle."""
    got = [b * threads + t for b in range(-(-R // threads)) for t in range(threads)]
    return [i for i in got if i < R]


@pytest.mark.parametrize("R", [1, 300, 16384, 49152])
def test_referee_grid_covers_every_read_once(R):
    got = referee_reads(R, kernels.QUERY_THREADS)
    assert len(got) == R and sorted(got) == list(range(R))
    assert -(-R // kernels.QUERY_THREADS) == {1: 1, 300: 2, 16384: 64, 49152: 192}[R]
