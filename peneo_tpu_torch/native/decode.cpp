// Native host-side kv-pair decoder (C ABI, loaded via ctypes).
//
// The chain-walk half of PEneo decoding is inherently sequential host work
// (reference: pipeline/decode.py:9-378, a pure-python loop; the torch stack
// hides equivalent native loops inside its C++ DataLoader/ops). The device
// half ships compact top-k spot arrays (models/decoder.py compact_spots);
// this module consumes those raw arrays
// directly — no per-spot Python tuple materialization — and runs:
//
//   1. link-map construction with CPython-dict ORDER semantics
//      (insertion-ordered keys, overwrite keeps position, strict-> keeps the
//      first-seen tie winner) so outputs are bit-identical to the python
//      path in pipeline/decode.py (randomized equivalence test),
//   2. the line-grouping chain walk with the LE/LG agreement checks and the
//      1000-hop runaway guard,
//   3. the entity-linking tail-to-tail final cross-check.
//
// Outputs are flat int32 index arrays; the python wrapper slices text/boxes.
//
// Build: g++ -O2 -fPIC -shared decode.cpp -o libpeneo_decode.so
// (native/__init__.py builds it lazily into .native_build/).

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <utility>
#include <vector>

using std::size_t;

namespace {

constexpr int kMaxChain = 1000;  // reference pipeline/decode.py:260-261

struct Spots {
  const int32_t* i;
  const int32_t* j;
  const int8_t* tag;
  const float* sc;
  int n;
};

// Insertion-ordered int->int map mirroring CPython dict semantics: first
// insertion fixes the position; overwrites keep it; iteration follows
// positions.
struct OrderedMap {
  std::vector<int32_t> keys;
  std::vector<int32_t> val;
  std::vector<float> score;
  std::unordered_map<int32_t, size_t> pos;

  // keep-best with strict > (ties keep the first seen)
  void insert_better(int32_t k, int32_t v, float s) {
    auto it = pos.find(k);
    if (it == pos.end()) {
      pos.emplace(k, keys.size());
      keys.push_back(k);
      val.push_back(v);
      score.push_back(s);
    } else if (s > score[it->second]) {
      val[it->second] = v;
      score[it->second] = s;
    }
  }

  // plain dict assignment
  void set(int32_t k, int32_t v) {
    auto it = pos.find(k);
    if (it == pos.end()) {
      pos.emplace(k, keys.size());
      keys.push_back(k);
      val.push_back(v);
      score.push_back(0.f);
    } else {
      val[it->second] = v;
    }
  }

  const int32_t* find(int32_t k) const {
    auto it = pos.find(k);
    return it == pos.end() ? nullptr : &val[it->second];
  }
};

// build_link_map(top_score_only=True): bijective head->tail
// (decode.py:68-80)
OrderedMap build_top_map(const Spots& s, bool triu, float thresh) {
  OrderedMap best_tail;
  for (int n = 0; n < s.n; ++n) {
    if (s.tag[n] == 0 || s.sc[n] < thresh) continue;
    int32_t h = s.i[n], t = s.j[n];
    if (triu && s.tag[n] == 2) std::swap(h, t);
    best_tail.insert_better(h, t, s.sc[n]);
  }
  OrderedMap best_head;  // tail -> (head, score)
  for (size_t m = 0; m < best_tail.keys.size(); ++m)
    best_head.insert_better(best_tail.val[m], best_tail.keys[m],
                            best_tail.score[m]);
  OrderedMap out;  // {h: t for t, (h, _) in best_head.items()}
  for (size_t m = 0; m < best_head.keys.size(); ++m)
    out.set(best_head.val[m], best_head.keys[m]);
  return out;
}

// _walk_chain (decode.py:83-116) on index level; appends (start, end)
// segments. Returns the final line's tail index.
int32_t walk_chain(int32_t first_head, int32_t first_tail,
                   const OrderedMap& le, const OrderedMap& lg_head,
                   const OrderedMap& lg_tail, std::vector<int32_t>* segs) {
  segs->push_back(first_head);
  segs->push_back(first_tail);
  int32_t cur_head = first_head, cur_tail = first_tail;
  const int32_t* nxt = lg_head.find(cur_head);
  int hops = 0;
  while (nxt != nullptr) {
    ++hops;
    if (hops > kMaxChain || *nxt == cur_head) break;
    const int32_t* le_tail = le.find(*nxt);
    const int32_t* succ = lg_tail.find(cur_tail);
    if (le_tail == nullptr || succ == nullptr || *succ != *le_tail) break;
    segs->push_back(*nxt);
    segs->push_back(*le_tail);
    cur_head = *nxt;
    cur_tail = *le_tail;
    nxt = lg_head.find(cur_head);
  }
  return cur_tail;
}

void dump(const OrderedMap& m, int32_t* out, int32_t* n) {
  for (size_t k = 0; k < m.keys.size(); ++k) {
    out[2 * k] = m.keys[k];
    out[2 * k + 1] = m.val[k];
  }
  *n = static_cast<int32_t>(m.keys.size());
}

}  // namespace

extern "C" {

// Decode one sample's five compact spot lists (already filtered to valid +
// in-range and sorted by flat index — decode.py spot order).
//
// Output buffers (caller-allocated):
//   le_items / lgh_items / lgt_items : 2*n capacity, (key, val) map dumps
//   elt_pairs : 2*elt_n, el_t2t list-map entries in append order
//   elh_pairs : 2*elh_n, (key_head, value_head) in append order
//   kv_meta   : 4*elh_n, per emitted kv pair
//               (key_head, value_head, key_n_segs, val_n_segs)
//   segs      : seg_cap int32s; per kv pair the key segments then the value
//               segments, each segment as (start, end)
//   out_sizes : [n_le, n_lgh, n_lgt, n_elt, n_elh, n_kv, n_seg_int32s]
// Returns 0, or -1 if segs would overflow seg_cap (caller falls back).
int peneo_decode_sample(
    const int32_t* le_i, const int32_t* le_j, const int8_t* le_tag,
    const float* le_sc, int le_n,
    const int32_t* elh_i, const int32_t* elh_j, const int8_t* elh_tag,
    const float* elh_sc, int elh_n,
    const int32_t* elt_i, const int32_t* elt_j, const int8_t* elt_tag,
    const float* elt_sc, int elt_n,
    const int32_t* lgh_i, const int32_t* lgh_j, const int8_t* lgh_tag,
    const float* lgh_sc, int lgh_n,
    const int32_t* lgt_i, const int32_t* lgt_j, const int8_t* lgt_tag,
    const float* lgt_sc, int lgt_n,
    float score_thresh,
    int32_t* le_items, int32_t* lgh_items, int32_t* lgt_items,
    int32_t* elt_pairs, int32_t* elh_pairs, int32_t* kv_meta,
    int32_t* segs, int seg_cap, int32_t* out_sizes) {
  Spots le{le_i, le_j, le_tag, le_sc, le_n};
  Spots elh{elh_i, elh_j, elh_tag, elh_sc, elh_n};
  Spots elt{elt_i, elt_j, elt_tag, elt_sc, elt_n};
  Spots lgh{lgh_i, lgh_j, lgh_tag, lgh_sc, lgh_n};
  Spots lgt{lgt_i, lgt_j, lgt_tag, lgt_sc, lgt_n};

  OrderedMap le_map = build_top_map(le, /*triu=*/false, score_thresh);
  OrderedMap lg_tail = build_top_map(lgt, /*triu=*/true, score_thresh);
  OrderedMap lg_head = build_top_map(lgh, /*triu=*/true, score_thresh);
  dump(le_map, le_items, &out_sizes[0]);
  dump(lg_head, lgh_items, &out_sizes[1]);
  dump(lg_tail, lgt_items, &out_sizes[2]);

  // el_tail list map (decode.py:151, build_link_map top_score_only=False,
  // triu) — append order preserved in the pair dump
  int32_t n_elt_pairs = 0;
  // membership for the final cross-check: (key_last_tail, val_last_tail)
  std::unordered_map<int32_t, std::vector<int32_t>> elt_lists;
  for (int n = 0; n < elt.n; ++n) {
    if (elt.tag[n] == 0 || elt.sc[n] < score_thresh) continue;
    int32_t h = elt.i[n], t = elt.j[n];
    if (elt.tag[n] == 2) std::swap(h, t);
    elt_pairs[2 * n_elt_pairs] = h;
    elt_pairs[2 * n_elt_pairs + 1] = t;
    ++n_elt_pairs;
    elt_lists[h].push_back(t);
  }
  out_sizes[3] = n_elt_pairs;

  // kv loop over el_h2h spots in spot order (decode.py:154-179)
  int32_t n_elh_pairs = 0, n_kv = 0;
  std::vector<int32_t> seg_buf;
  std::vector<int32_t> chain;
  for (int n = 0; n < elh.n; ++n) {
    if (elh.tag[n] == 0 || elh.sc[n] < score_thresh) continue;
    int32_t key_head = elh.i[n], value_head = elh.j[n];
    if (elh.tag[n] == 2) std::swap(key_head, value_head);
    elh_pairs[2 * n_elh_pairs] = key_head;
    elh_pairs[2 * n_elh_pairs + 1] = value_head;
    ++n_elh_pairs;

    const int32_t* key_first_tail = le_map.find(key_head);
    const int32_t* value_first_tail = le_map.find(value_head);
    if (key_first_tail == nullptr || value_first_tail == nullptr) continue;

    chain.clear();
    int32_t key_last_tail = walk_chain(key_head, *key_first_tail, le_map,
                                       lg_head, lg_tail, &chain);
    size_t key_segs = chain.size() / 2;
    int32_t val_last_tail = walk_chain(value_head, *value_first_tail, le_map,
                                       lg_head, lg_tail, &chain);
    size_t val_segs = chain.size() / 2 - key_segs;

    auto it = elt_lists.find(key_last_tail);
    bool ok = false;
    if (it != elt_lists.end())
      for (int32_t t : it->second)
        if (t == val_last_tail) {
          ok = true;
          break;
        }
    if (!ok) continue;

    kv_meta[4 * n_kv] = key_head;
    kv_meta[4 * n_kv + 1] = value_head;
    kv_meta[4 * n_kv + 2] = static_cast<int32_t>(key_segs);
    kv_meta[4 * n_kv + 3] = static_cast<int32_t>(val_segs);
    ++n_kv;
    seg_buf.insert(seg_buf.end(), chain.begin(), chain.end());
  }
  out_sizes[4] = n_elh_pairs;
  out_sizes[5] = n_kv;
  out_sizes[6] = static_cast<int32_t>(seg_buf.size());
  if (static_cast<int>(seg_buf.size()) > seg_cap) return -1;
  for (size_t k = 0; k < seg_buf.size(); ++k) segs[k] = seg_buf[k];
  return 0;
}

}  // extern "C"
