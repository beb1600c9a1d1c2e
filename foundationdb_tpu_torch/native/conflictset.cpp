// Native CPU ConflictSet: a skip-list step function over byte-string key space.
//
// This is the CPU baseline the device kernel is measured against, covering the
// reference's SkipList-based ConflictSet (fdbserver/SkipList.cpp, semantics
// at fdbserver/ConflictSet.h:27-60): batched OCC over key ranges with an MVCC
// version window.  Written fresh for this framework: the committed-write
// history is a step function (sorted boundary keys; each node's value is the
// version of the gap [node.key, next.key)) — the same mathematical object the
// device kernel keeps as tensors — stored in a skip list:
//   read check   QueryMax(b, e): O(log n) descent + walk over the gaps the
//                range actually covers (short ranges cover 1-2 gaps)
//   write insert Assign(b, e, v): O(log n + interior boundaries removed)
//   GC           ClampBelow(v):   amortized, driven by remove_before
// Exposed as a C ABI loaded via ctypes behind the plugin seam
// (conflict/plugin.py; pattern: fdbrpc/LoadPlugin.h:30-44).  A copy of the
// reference package's native/conflictset.cpp; conflict/native.py builds it
// on first use.
//
// Determinism: tower heights come from a private xorshift64 RNG seeded at
// construction, and verdicts are height-independent, so the abort set is a
// pure function of the batch stream.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <utility>
#include <vector>

namespace {

using Key = std::string;  // byte strings; std::string order == memcmp order

constexpr int kMaxLevel = 26;

struct Node {
  Key key;              // boundary: this node's gap is [key, next[0]->key)
  int64_t gap_version;  // version of that gap (0 = never written / GC'd)
  int level;            // tower height, 1..kMaxLevel
  Node* next[1];        // flexible tower: next[0..level-1]

  static Node* make(const Key& k, int64_t v, int level) {
    Node* n = static_cast<Node*>(
        std::malloc(sizeof(Node) + (level - 1) * sizeof(Node*)));
    new (&n->key) Key(k);
    n->gap_version = v;
    n->level = level;
    std::memset(n->next, 0, level * sizeof(Node*));
    return n;
  }
  static void destroy(Node* n) {
    n->key.~Key();
    std::free(n);
  }
};

class SkipListStepFunction {
 public:
  explicit SkipListStepFunction(uint64_t seed) : rng_(seed | 1) {
    head_ = Node::make(Key(), 0, kMaxLevel);  // "" boundary, version 0
  }
  ~SkipListStepFunction() {
    Node* n = head_;
    while (n) {
      Node* nx = n->next[0];
      Node::destroy(n);
      n = nx;
    }
  }

  // max gap version over [begin, end)
  int64_t QueryMax(const Key& begin, const Key& end) const {
    if (begin >= end) return 0;
    const Node* n = head_;
    for (int l = kMaxLevel - 1; l >= 0; --l)
      while (n->next[l] && n->next[l]->key <= begin) n = n->next[l];
    // n = boundary of the gap containing begin; walk the covered gaps.
    int64_t mx = n->gap_version;
    for (n = n->next[0]; n && n->key < end; n = n->next[0])
      if (mx < n->gap_version) mx = n->gap_version;
    return mx;
  }

  // Assign `version` over [begin, end).  Versions are assigned monotonically
  // (enforced by ResolveBatch), so plain overwrite: split at end, drop
  // interior boundaries, set/insert the begin boundary.
  void Assign(const Key& begin, const Key& end, int64_t version) {
    if (begin >= end) return;
    Node* update[kMaxLevel];
    Node* n = head_;
    for (int l = kMaxLevel - 1; l >= 0; --l) {
      while (n->next[l] && n->next[l]->key < begin) n = n->next[l];
      update[l] = n;
    }
    // n = last boundary with key < begin; its gap covers begin unless an
    // exact-match node exists.
    Node* at_begin =
        (n->next[0] && n->next[0]->key == begin) ? n->next[0] : nullptr;
    if (at_begin)  // fold into update[] so interior unlinks see the true
      for (int l = 0; l < at_begin->level; ++l) update[l] = at_begin;
    // Value the keyspace resumes with at `end`: the version of the gap that
    // currently contains end.
    int64_t resume = (at_begin ? at_begin : n)->gap_version;
    Node* scan = (at_begin ? at_begin : n)->next[0];
    bool saw_end_exact = false;
    while (scan && scan->key <= end) {
      if (scan->key == end) {
        saw_end_exact = true;
        break;
      }
      resume = scan->gap_version;
      Node* nx = scan->next[0];
      Unlink_(update, scan);
      Node::destroy(scan);
      scan = nx;
    }
    if (at_begin) {
      at_begin->gap_version = version;
    } else if (n->gap_version != version) {  // left-coalesce if equal
      Node* nb = InsertAfter_(update, begin, version);
      for (int l = 0; l < nb->level; ++l) update[l] = nb;
    }
    if (!saw_end_exact && resume != version) InsertAfter_(update, end, resume);
    if (saw_end_exact && scan->gap_version == version) {
      // coalesce: the end boundary now carries the same value as [begin,end)
      Unlink_(update, scan);
      Node::destroy(scan);
    }
  }

  // GC: gaps older than the MVCC floor can never conflict a live snapshot
  // (TOO_OLD is decided first), so zero them and coalesce equal neighbours.
  void ClampBelow(int64_t floor) {
    Node* update[kMaxLevel];
    for (int l = 0; l < kMaxLevel; ++l) update[l] = head_;
    Node* n = head_;
    while (n) {
      if (n->gap_version < floor) n->gap_version = 0;
      Node* nx = n->next[0];
      if (n != head_ && n->gap_version == PrevValue_(update)) {
        Unlink_(update, n);
        Node::destroy(n);
      } else {
        for (int l = 0; l < n->level; ++l) update[l] = n;
      }
      n = nx;
    }
  }

  size_t NodeCount() const {
    size_t c = 0;
    for (Node* n = head_; n; n = n->next[0]) ++c;
    return c;
  }

 private:
  static int64_t PrevValue_(Node* const* update) {
    return update[0]->gap_version;
  }

  int RandomLevel_() {
    uint64_t x = rng_;
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    rng_ = x;
    int lvl = 1;
    while ((x & 3) == 0 && lvl < kMaxLevel) {  // p = 1/4 promotion
      ++lvl;
      x >>= 2;
    }
    return lvl;
  }

  // Insert a new node right after the positions recorded in update[].
  Node* InsertAfter_(Node* const* update, const Key& key, int64_t version) {
    int lvl = RandomLevel_();
    Node* nn = Node::make(key, version, lvl);
    for (int l = 0; l < lvl; ++l) {
      nn->next[l] = update[l]->next[l];
      update[l]->next[l] = nn;
    }
    return nn;
  }

  // Unlink `target`, known to be the immediate successor of update[l] at
  // every level it occupies.
  static void Unlink_(Node* const* update, Node* target) {
    for (int l = 0; l < target->level; ++l)
      if (update[l]->next[l] == target) update[l]->next[l] = target->next[l];
  }

  Node* head_;
  uint64_t rng_;
};

// Matches fdbserver/ConflictSet.h:36-40 TransactionCommitResult ordering
// (min-combine across resolvers relies on it; see conflict/api.py Verdict).
enum Verdict : uint8_t { kConflict = 0, kTooOld = 1, kCommitted = 2 };

class ConflictSetImpl {
 public:
  explicit ConflictSetImpl(int64_t oldest)
      : history_(0x5DEECE66DULL), oldest_(oldest), last_commit_(oldest) {}

  // Batch layout (see conflict/native.py): all range-endpoint keys of the
  // batch concatenated into key_bytes, delimited by key_offsets[n_keys+1],
  // ordered txn-by-txn as (read b,e)*nr then (write b,e)*nw.
  int ResolveBatch(int64_t commit_version, int32_t n_txn,
                   const int64_t* snapshots, const int32_t* n_read_ranges,
                   const int32_t* n_write_ranges, const uint8_t* key_bytes,
                   const int64_t* key_offsets, uint8_t* out_verdicts) {
    if (commit_version <= last_commit_) return -1;
    last_commit_ = commit_version;
    size_t key_idx = 0;
    auto next_key = [&]() {
      const int64_t b = key_offsets[key_idx], e = key_offsets[key_idx + 1];
      ++key_idx;
      return Key(reinterpret_cast<const char*>(key_bytes) + b,
                 static_cast<size_t>(e - b));
    };
    batch_writes_.clear();
    committed_writes_.clear();
    for (int32_t t = 0; t < n_txn; ++t) {
      const int32_t nr = n_read_ranges[t], nw = n_write_ranges[t];
      if (snapshots[t] < oldest_) {  // decided at add time, SkipList.cpp:985
        out_verdicts[t] = kTooOld;
        key_idx += 2 * (nr + nw);
        continue;
      }
      bool conflict = false;
      for (int32_t i = 0; i < nr; ++i) {
        Key b = next_key(), e = next_key();
        if (conflict || b >= e) continue;
        if (history_.QueryMax(b, e) > snapshots[t] || BatchOverlap_(b, e))
          conflict = true;
      }
      if (conflict) {
        out_verdicts[t] = kConflict;
        key_idx += 2 * nw;
        continue;
      }
      out_verdicts[t] = kCommitted;
      for (int32_t i = 0; i < nw; ++i) {
        Key b = next_key(), e = next_key();
        if (b >= e) continue;
        BatchInsert_(b, e);
        committed_writes_.emplace_back(std::move(b), std::move(e));
      }
    }
    for (auto& [b, e] : committed_writes_)
      history_.Assign(b, e, commit_version);
    return 0;
  }

  void RemoveBefore(int64_t version) {
    if (version <= oldest_) return;
    oldest_ = version;
    history_.ClampBelow(version);
  }

  int64_t oldest() const { return oldest_; }
  size_t node_count() const { return history_.NodeCount(); }

 private:
  // Intra-batch committed-writes index: coalesced disjoint intervals in a
  // flat map (covers the reference MiniConflictSet's ordered "later txns see
  // earlier committed writes" semantics, SkipList.cpp:1028-1152).
  bool BatchOverlap_(const Key& b, const Key& e) const {
    auto it = batch_writes_.upper_bound(b);
    if (it != batch_writes_.begin()) {
      auto prev = std::prev(it);
      if (b < prev->second) return true;  // interval starting <= b covers b
    }
    return it != batch_writes_.end() && it->first < e;
  }

  void BatchInsert_(const Key& b, const Key& e) {
    Key nb = b, ne = e;
    auto it = batch_writes_.upper_bound(b);
    if (it != batch_writes_.begin()) {
      auto prev = std::prev(it);
      if (prev->second >= b) {  // merge with left neighbour
        nb = prev->first;
        if (prev->second > ne) ne = prev->second;
        batch_writes_.erase(prev);
      }
    }
    it = batch_writes_.lower_bound(nb);
    while (it != batch_writes_.end() && it->first <= ne) {
      if (it->second > ne) ne = it->second;
      it = batch_writes_.erase(it);
    }
    batch_writes_.emplace(std::move(nb), std::move(ne));
  }

  SkipListStepFunction history_;
  std::map<Key, Key> batch_writes_;  // begin -> end, disjoint, coalesced
  std::vector<std::pair<Key, Key>> committed_writes_;
  int64_t oldest_;
  int64_t last_commit_;
};

}  // namespace

extern "C" {

// Plugin ABI (loaded via conflict/plugin.py; pattern: fdbrpc/LoadPlugin.h).
const char* fdbtpu_conflictset_backend_name() { return "skiplist-cpp"; }

void* fdbtpu_conflictset_create(int64_t oldest_version) {
  return new ConflictSetImpl(oldest_version);
}

void fdbtpu_conflictset_destroy(void* cs) {
  delete static_cast<ConflictSetImpl*>(cs);
}

int fdbtpu_conflictset_resolve(void* cs, int64_t commit_version, int32_t n_txn,
                               const int64_t* snapshots,
                               const int32_t* n_read_ranges,
                               const int32_t* n_write_ranges,
                               const uint8_t* key_bytes,
                               const int64_t* key_offsets,
                               uint8_t* out_verdicts) {
  return static_cast<ConflictSetImpl*>(cs)->ResolveBatch(
      commit_version, n_txn, snapshots, n_read_ranges, n_write_ranges,
      key_bytes, key_offsets, out_verdicts);
}

void fdbtpu_conflictset_remove_before(void* cs, int64_t version) {
  static_cast<ConflictSetImpl*>(cs)->RemoveBefore(version);
}

int64_t fdbtpu_conflictset_oldest(void* cs) {
  return static_cast<ConflictSetImpl*>(cs)->oldest();
}

int64_t fdbtpu_conflictset_node_count(void* cs) {
  return static_cast<int64_t>(static_cast<ConflictSetImpl*>(cs)->node_count());
}

}  // extern "C"
