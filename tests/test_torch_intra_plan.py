"""K2's launch plans (kernels.plan_intra) and a numpy model of the cluster
plan's kernel (intra_cluster_kernel in csrc/conflict_kernels.cu), on the CPU.

The model follows the kernel's index map: which block stages each read and
write and owns each txn, which block holds each tree node (block c holds
ranks [c S, (c + 1) S) as its own tree; the levels above the slice roots
are not stored), which of an item's node accesses are local and which go
to another block's shared memory, and the phases of an iteration (A: the
committed writes' offers; the trees settled; B: the reads' minimums and
the hits; C: the new bits and the stop rule).  It is held bit for bit
against intra_fixpoint_plain (bits and iteration count) on the cases of
the gpu tests' _fixpoint_case at every cluster size, and against the JAX
reference's phase_intra (XLA and Pallas interpret mode) on seeded batches.
All integer: equality is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from foundationdb_tpu.conflict import device as jdev
from foundationdb_tpu_torch.conflict import device as tdev
from foundationdb_tpu_torch.conflict import kernels
from tests.test_torch_cuda import FIXPOINT_CASES, _fixpoint_case
from tests.test_torch_kernels import _intra_chain, _intra_random, _t

I32_MAX = 0x7FFFFFFF
CPU = torch.device("cpu")


def _cdiv(a, b):
    return -(-a // b)


def slice_nodes(S, a, b):
    """The (local node, halvings from the leaves) pairs the kernel's
    slice_min / slice_offer visit for leaves [a, b) of one block's tree
    (the bottom-up walk)."""
    out = []
    lo, hi, k = S + a, S + b, 0
    while lo < hi:
        if lo & 1:
            out.append((lo, k))
            lo += 1
        if hi & 1:
            hi -= 1
            out.append((hi, k))
        lo >>= 1
        hi >>= 1
        k += 1
    return out


TOP = 31  # the kernel's kTop: a root offered to from another block's span


def cluster_nodes(S, a, b):
    """(block, local node, halvings) triples that cluster_min /
    cluster_offer visit for ranks [a, b): the end blocks' walks and the
    roots of the blocks between (at TOP halvings: a query walks to the
    root)."""
    ca, cb = a // S, (b - 1) // S
    if ca == cb:
        return [(ca, x, k) for x, k in slice_nodes(S, a - ca * S, b - ca * S)]
    return ([(ca, x, k) for x, k in slice_nodes(S, a - ca * S, S)]
            + [(cb, x, k) for x, k in slice_nodes(S, 0, b - cb * S)]
            + [(c, 1, TOP) for c in range(ca + 1, cb)])


def ranks_under(S, block, x):
    """The ranks under local node x of `block`'s tree (its leaves S .. 2S-1
    below x: not one interval where S is not a power of two)."""
    out, todo = [], [x]
    while todo:
        y = todo.pop()
        if y >= S:
            out.append(block * S + y - S)
        else:
            todo += [2 * y, 2 * y + 1]
    return out


def place(owner, live, C, cap):
    """claim_slot in item order: each live item in the block that holds its
    begin rank or, where that one holds `cap` already, the next with room;
    -1 for a dead item (not staged).  The kernel claims in whatever order
    its threads run; any order places each item once, within capacity."""
    where = np.full(len(owner), -1)
    count = np.zeros(C, int)
    for i in np.flatnonzero(live):
        for k in range(C):
            c = (owner[i] + k) % C
            if count[c] < cap:
                where[i], count[c] = c, count[c] + 1
                break
    return where


def path_nodes(S, leaf):
    """A leaf's path to its tree's root (local nodes S + leaf, ..., 1)."""
    out, x = [], S + leaf
    while x >= 1:
        out.append(x)
        x >>= 1
    return out


class ClusterModel:
    """intra_cluster_kernel at `cluster` blocks on K2's arguments `fx`
    (as kernels.intra_fixpoint takes them).  Node g = block * 2 S + local
    node of the block's tree; every block's copy of the txn state bytes is
    the same, so one array stands for them.  Tree 1's walk up with early
    exit leaves every node on a write's path at the min of the offers
    under it, which offering to the whole path gives too."""

    def __init__(self, fx, cluster):
        *tensors, B = fx
        (rb_r, re_r, wb_r, we_r, r_ok, w_ok, r_idx, w_idx, w_tx, active,
         hist) = [t.cpu().numpy() for t in tensors]
        R, Wn, C = len(rb_r), len(wb_r), cluster
        n = 2 * (R + Wn)
        self.B, self.C, self.n = B, C, n
        self.leaves = kernels.intra_leaves(n, C)
        self.S = S = self.leaves // C
        self.Rc, self.Wc, self.Bc = _cdiv(R, C), _cdiv(Wn, C), _cdiv(B, C)
        last_rank, last_txn = max(n - 1, 0), max(B - 1, 0)
        self.rb = np.clip(rb_r, 0, last_rank).astype(np.int64)
        self.re = np.clip(re_r, 0, n).astype(np.int64)
        self.rt = np.where(r_ok & (B > 0), np.clip(r_idx, 0, last_txn), -1)
        self.wb = np.clip(wb_r, 0, last_rank).astype(np.int64)
        self.we = np.clip(we_r, 0, n).astype(np.int64)
        self.wt = np.where(w_ok & (B > 0), np.clip(w_idx, 0, last_txn), -1)
        self.wv = w_tx.astype(np.int64)
        self.base = (active & ~hist).astype(np.uint8)
        # staging: a live item in its begin's block or the next with room;
        # block t // Bc writes out txn t's bit
        self.r_room = kernels.intra_room(R, C)
        self.w_room = kernels.intra_room(Wn, C)
        self.read_block = place(self.rb // S, self.rt >= 0, C, self.r_room)
        self.write_block = place(self.wb // S, self.wt >= 0, C, self.w_room)
        self.txn_block = np.arange(B) // max(self.Bc, 1)
        node = lambda c, x: c * 2 * S + x  # noqa: E731
        # A: a write's path in tree 1, and its span's nodes in tree 2
        up = [[node(b // S, x) for x in path_nodes(S, b % S)] for b in self.wb]
        self.w_up_seg = np.repeat(np.arange(Wn), [len(u) for u in up])
        self.w_up = np.array([g for u in up for g in u], np.int64)
        span = [cluster_nodes(S, int(a), int(b)) if a < b else []
                for a, b in zip(self.wb, self.we)]
        self.w_seg = np.repeat(np.arange(Wn), [len(s) for s in span])
        self.w_nodes = np.array([node(c, x) for s in span for c, x, _k in s], np.int64)
        self.w_node_k = np.array([k for s in span for _c, _x, k in s], np.int64)
        # B: a read's path in tree 2, and tree 1's nodes over (rb, re)
        path = [[node(b // S, x) for x in path_nodes(S, b % S)] for b in self.rb]
        self.r_path_seg = np.repeat(np.arange(R), [len(p) for p in path])
        self.r_path = np.array([g for p in path for g in p], np.int64)
        self.r_path_k = np.array([k for p in path for k in range(len(p))], np.int64)
        rng_ = [cluster_nodes(S, int(a) + 1, int(b)) if a + 1 < b else []
                for a, b in zip(self.rb, self.re)]
        self.r_seg = np.repeat(np.arange(R), [len(s) for s in rng_])
        self.r_nodes = np.array([node(c, x) for s in rng_ for c, x, _k in s], np.int64)
        # tree 1 is kept only where some live read's rank range is not empty
        self.tree1 = bool(((self.rt >= 0) & (self.rb + 1 < self.re)).any())

    def remote(self):
        """Per kind of access, (local, remote) counts over the live items:
        a node or a txn's byte in the block that staged the item, or in
        another block's shared memory."""
        blk = lambda g: g // (2 * self.S)  # noqa: E731

        def split(owner, by):
            live = by >= 0
            far = int(((owner != by) & live).sum())
            return int(live.sum()) - far, far

        return {
            "tree1_walk": split(blk(self.w_up), self.write_block[self.w_up_seg]),
            "tree2_offer": split(blk(self.w_nodes), self.write_block[self.w_seg]),
            "tree2_path": split(blk(self.r_path), self.read_block[self.r_path_seg]),
            "tree1_range": split(blk(self.r_nodes), self.read_block[self.r_seg]),
        }

    def run(self):
        """The fixpoint: (intra bool[B], iterations).  Iteration i's
        committed writes are those of txns active, not history-conflicted
        and not hit in iteration i - 1; its hits are the intra bits after
        it, and the stop rule compares them with the last ones."""
        B, n_nodes = self.B, self.C * 2 * self.S
        hit_last = np.zeros(B, bool)
        wt = np.clip(self.wt, 0, None)
        span = self.wb < self.we
        it = 0
        while True:
            t1 = np.full(n_nodes, I32_MAX, np.int64)
            t2 = np.full(n_nodes, I32_MAX, np.int64)
            # A: every committed write offers its txn index to both trees
            com = ((self.wt >= 0) & self.base[wt].astype(bool) & ~hit_last[wt]
                   if B else np.zeros_like(span))
            if self.tree1:
                sel = com[self.w_up_seg]
                np.minimum.at(t1, self.w_up[sel], self.wv[self.w_up_seg[sel]])
            sel = (com & span)[self.w_seg]
            np.minimum.at(t2, self.w_nodes[sel], self.wv[self.w_seg[sel]])
            # each block's tree 2 height: the most halvings offered to
            high = np.zeros(self.C, np.int64)
            np.maximum.at(high, self.w_nodes[sel] // (2 * self.S), self.w_node_k[sel])
            # B: each live read's minimum, against its own txn: tree 2 up
            # to one past its block's height (its leaf alone at height 0),
            # tree 1 over its range
            m = np.full(len(self.rb), I32_MAX, np.int64)
            top = high[self.r_path // (2 * self.S)]
            walk = self.r_path_k <= np.where(top > 0, top + 1, 0)
            np.minimum.at(m, self.r_path_seg[walk], t2[self.r_path[walk]])
            np.minimum.at(m, self.r_seg, t1[self.r_nodes])
            hit = np.zeros(B, bool)
            hit[self.rt[(self.rt >= 0) & (m < self.rt)]] = True
            # the stop rule: did any bit change?
            moved = bool((hit != hit_last).any())
            hit_last = hit
            it += 1
            if not moved or it >= B + 2:
                return hit, it


def _plain(fx):
    bits, n = kernels.intra_fixpoint_plain(*fx)
    return bits.numpy(), int(n[0])


# --------------------------------------------------------------------------
# the planner


# (R, Wn, B) at each cluster size's largest batch of the stream's mix (2
# reads and 1 write a txn: n = 6 B ranks) and the next one up
BOUNDARIES = [(1190, 1), (1191, 2), (2275, 2), (2276, 4), (4421, 4), (4422, 8),
              (8365, 8), (8366, 16), (15096, 16), (15097, 0), (32768, 0)]


@pytest.mark.parametrize("B,cluster", BOUNDARIES)
def test_plan_intra_takes_the_least_cluster_that_holds_the_batch(B, cluster):
    plan = kernels.plan_intra(2 * B, B, B)
    assert plan.cluster == cluster
    if cluster:
        assert plan.smem == kernels.intra_cluster_bytes(2 * B, B, B, cluster)
        assert plan.smem <= kernels.SMEM_MAX
        assert kernels.plan_intra_cluster(2 * B, B, B, cluster) == plan
    else:
        assert plan == kernels.INTRA_GRID_PLAN
    for smaller in kernels.INTRA_CLUSTERS:  # no smaller cluster holds it
        if cluster and smaller >= cluster:
            break
        assert kernels.intra_cluster_bytes(2 * B, B, B, smaller) > kernels.SMEM_MAX
        with pytest.raises(ValueError):
            kernels.plan_intra_cluster(2 * B, B, B, smaller)


def test_plan_intra_at_the_stream_and_the_chain():
    """The stream's batch (16384 reads, 8192 writes, 8192 txns: 49152
    ranks) takes 8 blocks of 6144 ranks: three trees of 48 KB, room for
    2304 reads (36 KB) and 1152 writes (18 KB), the counts (288 B), 24 KB
    of state and hit bytes; the 1024-txn chain one block, with room for
    no more than its items."""
    assert kernels.plan_intra(16384, 8192, 8192) == kernels.IntraPlan(8, 227616)
    assert kernels.intra_room(16384, 8) == 2048 + 256
    assert 4 * (3 * 12288 + 4 * 2304 + 4 * 1152 + 72) + 3 * 8192 == 227616
    assert kernels.plan_intra(1024, 1024, 1024) == kernels.IntraPlan(1, 4 * (
        3 * 8192 + 4 * 1024 + 4 * 1024 + 72) + 3 * 1024)
    assert kernels.intra_leaves(49152, 8) == 49152 and kernels.intra_leaves(49152, 0) == 65536
    assert kernels.plan_name(kernels.plan_intra(1024, 1024, 1024)) == "cluster1"
    assert kernels.plan_name(kernels.INTRA_GRID_PLAN) == "grid"


@pytest.mark.parametrize("R,Wn,B,cluster", [
    (0, 0, 0, 1), (1, 0, 1, 1), (1, 1, 2, 1),
    (1, 1, 77344, 1), (1, 1, 77345, 2),  # every block holds 3 bytes of every txn
    (1, 1, 77360, 2), (1, 1, 77361, 0)])
def test_plan_intra_with_few_ranges_is_set_by_the_txn_bytes(R, Wn, B, cluster):
    """Few reads and writes among many txns: the txns' state and hit
    bytes, which every block holds (3 B), set the plan; more blocks buy
    only the rounding of the trees' room."""
    plan = kernels.plan_intra(R, Wn, B)
    assert plan.cluster == cluster
    if cluster:
        assert kernels.intra_cluster_bytes(R, Wn, B, cluster) <= kernels.SMEM_MAX
    if cluster != 1:
        assert kernels.intra_cluster_bytes(R, Wn, B, 1) > kernels.SMEM_MAX


def test_plan_intra_cluster_refuses_other_sizes():
    with pytest.raises(ValueError):
        kernels.plan_intra_cluster(64, 32, 32, 3)
    with pytest.raises(ValueError):
        kernels.plan_intra_cluster(64, 32, 32, 32)
    forced = kernels.plan_intra_cluster(64, 32, 32, 16)  # 12 ranks a block
    assert forced.cluster == 16 and kernels.intra_leaves(192, 16) == 192
    assert kernels.intra_leaves(0, 1) == 1 and kernels.intra_leaves(2, 16) == 16


# --------------------------------------------------------------------------
# the index map


@pytest.mark.parametrize("S,C", [(1, 1), (1, 4), (8, 1), (6, 2), (5, 3), (16, 8), (7, 16)])
def test_cluster_nodes_cover_each_rank_once(S, C):
    """The nodes of [a, b) (in its end blocks' trees and the roots of the
    blocks between) cover every rank of [a, b) exactly once and none
    outside it, at any slice size S; a node offered to at k halvings is
    reached from each of its leaves within k + 1 halvings (the query's
    walk) and lies in [S >> k, 2 S) (the reset's range); at most 2 (log2 S
    + 1) in each end block and C - 2 roots; a leaf's path has
    floor(log2(S + j)) + 1 nodes."""
    L = C * S
    rng = np.random.default_rng(S * 31 + C)
    pairs = [(a, b) for a in range(L) for b in range(a + 1, L + 1)]
    if len(pairs) > 600:
        pairs = [pairs[i] for i in rng.choice(len(pairs), 600, replace=False)]
    for a, b in pairs:
        nodes = cluster_nodes(S, a, b)
        covered = np.zeros(L, int)
        for c, x, k in nodes:
            assert 0 <= c < C and 1 <= x < 2 * S
            under = ranks_under(S, c, x)
            covered[under] += 1
            # reached from each leaf under it within k + 1 halvings, and
            # at or above S >> k (what the reset clears)
            assert k == TOP or all(
                any((S + r % S) >> d == x for d in range(k + 2)) for r in under)
            assert k == TOP or x >= S >> k
        assert (covered[a:b] == 1).all() and covered.sum() == b - a, (a, b)
        assert len(nodes) <= 4 * ((2 * S - 1).bit_length()) + max(C - 2, 0)
    for j in range(S):
        assert len(path_nodes(S, j)) == (S + j).bit_length()
        assert all(j in [r % S for r in ranks_under(S, 0, x)] for x in path_nodes(S, j))


@pytest.mark.parametrize("C", kernels.INTRA_CLUSTERS)
@pytest.mark.parametrize("case", ["ragged", "stream", "hot"])
def test_staged_owners_partition_the_batch(case, C):
    """Each live read and write is staged by exactly one block, within the
    block's room (what intra_cluster_bytes reserves), and each txn owned
    by one; at one block every access is local; where the begins are
    spread (the stream) the reads and writes sit in the block holding
    their begin rank, so their tree accesses are local; where they pile
    on one rank (`hot`: every read and write of one key) the staging
    spills to the next blocks and stays within their room."""
    fx = _fixpoint_case(np.random.default_rng(7), CPU, "stream" if case == "hot" else case)
    if case == "hot":
        fx = tuple(torch.full_like(t, 7) if i < 4 else t for i, t in enumerate(fx))
    model = ClusterModel(fx, C)
    for where, share, live in ((model.read_block, model.r_room, model.rt >= 0),
                               (model.write_block, model.w_room, model.wt >= 0)):
        assert ((where >= 0) == live).all() and (where < C).all()
        assert np.bincount(where[live], minlength=C).max() <= share
    assert np.bincount(model.txn_block, minlength=C).max() <= model.Bc
    assert model.leaves == model.C * model.S >= model.n
    remote = model.remote()
    if C == 1:
        assert all(far == 0 for _near, far in remote.values()), remote
    elif case == "stream":
        for kind in ("tree1_walk", "tree2_offer", "tree2_path"):
            near, far = remote[kind]
            assert far / (near + far) < 0.01, (kind, remote)
    elif case == "hot":
        near, far = remote["tree2_path"]
        assert near == model.r_room * len(path_nodes(model.S, 7)) and far > 0


# --------------------------------------------------------------------------
# the model against the plain fixpoint and the reference


@pytest.mark.parametrize("C", kernels.INTRA_CLUSTERS)
@pytest.mark.parametrize("case", [c for c in FIXPOINT_CASES if c != "side_stream"])
def test_cluster_model_matches_plain(case, C):
    """The model of the cluster plan at C blocks gives intra_fixpoint_plain's
    bits and iteration count on every case of the gpu tests."""
    fx = _fixpoint_case(np.random.default_rng(40 + FIXPOINT_CASES.index(case)), CPU, case)
    bits, n = ClusterModel(fx, C).run()
    want_bits, want_n = _plain(fx)
    assert np.array_equal(bits, want_bits) and n == want_n
    if case == "chain":
        assert n >= 1000 and bits.sum() == 512
    if case == "tiny":
        assert n == 2 and bits.tolist() == [False, True]
    if case == "hot" and C > 1:  # one block's ranks: the staging spills
        assert (ClusterModel(fx, C).read_block != 0).any()


@pytest.mark.parametrize("C", [1, 2, 16])
@pytest.mark.parametrize("source", ["random0", "random1", "chain_padded"])
def test_cluster_model_matches_the_reference(source, C):
    """On seeded key rows, the model on the port's ranks equals the JAX
    reference's phase_intra, its XLA path and its Pallas kernel in
    interpret mode, in bits and iteration count."""
    if source == "chain_padded":
        host, B = _intra_chain(32, 23)
    else:
        host, B = _intra_random(int(source[-1]))
    jargs = tuple(map(jnp.asarray, host)) + (B,)
    targs = tuple(map(_t, host))
    fx = (*tdev._intra_setup(*targs[:4]), *targs[4:], B)
    bits, n = ClusterModel(fx, C).run()
    for impl in ("xla", "interpret"):
        ref_bits, ref_n = jdev.phase_intra(*jargs, impl=impl)
        assert np.array_equal(np.asarray(ref_bits), bits), impl
        assert int(np.asarray(ref_n).reshape(-1)[0]) == n, impl


def test_out_of_domain_inputs_are_clamped_not_written_astray():
    """Ranks past n and below 0, a txn index past B and a live read in a
    batch of no txn: the model (the kernel's clamps) stays inside every
    buffer and still runs to a stop."""
    fx = list(_fixpoint_case(np.random.default_rng(3), CPU, "random"))
    fx[0] = fx[0].clone()
    fx[0][:5] = 10 ** 6
    fx[1] = fx[1].clone()
    fx[1][5:9] = -3
    fx[6] = fx[6].clone()
    fx[6][:3] = 10 ** 5
    got = []
    for C in (1, 4):
        model = ClusterModel(tuple(fx), C)
        assert model.rb.max() < model.n and model.re.max() <= model.n
        assert model.rt.max() < model.B
        got.append(model.run())
        assert 1 <= got[-1][1] <= model.B + 2
    assert np.array_equal(got[0][0], got[1][0]) and got[0][1] == got[1][1]
    # live reads and writes in a batch of no txn: every one is dead
    one = lambda *v: torch.tensor(v)  # noqa: E731
    none = torch.zeros(0, dtype=torch.bool)
    fx = (one(0), one(1), one(0), one(1), one(True), one(True), one(0), one(0),
          one(0).int(), none, none, 0)
    model = ClusterModel(fx, 2)
    assert (model.rt == -1).all() and (model.wt == -1).all()
    bits, n = model.run()
    assert bits.shape == (0,) and n == 1


def test_wrapper_on_the_cpu_takes_the_plain_version_under_any_plan():
    """On CPU tensors `plan=` changes nothing and launches nothing: the
    wrapper runs the plain fixpoint."""
    fx = _fixpoint_case(np.random.default_rng(5), CPU, "ragged")
    before = kernels.launch_counts()
    want = _plain(fx)
    for plan in (None, kernels.INTRA_GRID_PLAN, kernels.plan_intra_cluster(1000, 333, 300, 4)):
        bits, n = kernels.intra_fixpoint(*fx, plan=plan)
        assert np.array_equal(bits.numpy(), want[0]) and int(n[0]) == want[1]
    assert kernels.launch_counts() == before
