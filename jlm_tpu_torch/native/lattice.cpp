// Native lattice builder + bit-packer.
//
// C++ twin of jlm_tpu_torch/decoder/lattice.py (ref: JLM:decoder/decoder.py
// lattice construction, SURVEY.md §4.5) producing bit-for-bit the same
// packed int32 node tensor as pack_lattice_batch(build_lattice(...)).
// One call packs a whole chunk of sentences; each sentence is one pass over
// its start positions with no heap allocation, so the host's share of a
// chunk stays far below the device's.
//
// The lexicon is a trie over codepoints whose edges (parent, codepoint) sit
// in one open-addressed table; a node is the slot of the edge leading to it
// and holds its reading's word ids as a range of one flat array.  Walking
// from start i along kana[i], kana[i+1], ... meets every reading that
// starts at i in end-position order, with no key built or string hashed.
//
// One pass is exact: a node's lookahead index depends only on the nodes of
// the same start, in end-ascending then dictionary order -- the order the
// start-outer walk meets them -- and when start i is reached, frame j
// already holds every node of every earlier start, so its slot count (and
// with it the drop decision) is final.  Each kept node is written straight
// into its slot.
//
// Packing layout (must match engine.py): word | start<<17 | cand<<23 | 1<<29.
//
// Built with: g++ -O3 -shared -fPIC -std=c++17 lattice.cpp -o liblattice.so
// Loaded via ctypes (no pybind11 in the image).

#include <algorithm>
#include <cstdint>
#include <map>
#include <vector>

namespace {

constexpr int kStartShift = 17;
constexpr int kCidxShift = 23;
constexpr int kMaskShift = 29;
constexpr uint32_t kFree = 0xFFFFFFFFu;  // an edge slot's cp when unused

struct Edge {
  uint32_t parent, cp;
  int32_t id_begin, id_end;  // into Lexicon::ids: the words of the reading
};

struct Lexicon {
  std::vector<Edge> edges;  // a power of two slots, at most 3/4 used
  std::vector<int32_t> ids;  // frequency(id)-ascending per reading
  int32_t unk_id = 1;
  uint32_t mask = 0;
  int shift = 64;
  int max_reading_len = 1;

  uint32_t root() const { return mask + 1; }
  uint32_t slot(uint32_t parent, uint32_t cp) const {
    return (uint32_t)(((((uint64_t)parent << 21) | cp) *
                       0x9E3779B97F4A7C15ull) >> shift);
  }
  // The child of `node` along codepoint `cp`, or -1.
  int32_t child(uint32_t node, uint32_t cp) const {
    for (uint32_t h = slot(node, cp);; h = (h + 1) & mask) {
      const Edge& e = edges[h];
      if (e.cp == cp && e.parent == node) return (int32_t)h;
      if (e.cp == kFree) return -1;
    }
  }
};

// One sentence into out[W * N_max] (row j-1 = frame j; rows past W are not
// written).  `count` has room for T + 1 ints and `look` for C_max.  `out`
// must hold zeros.  Returns the nodes dropped beyond N_max (>= 0), or -1 if
// a start's lookahead row overflows C_max.
int32_t build_one(const Lexicon& lex, const uint32_t* kana, int32_t T,
                  int32_t W, int32_t N_max, int32_t C_max, int32_t M,
                  int32_t* out, int32_t* count, int32_t* look) {
  std::fill(count, count + T + 1, 0);
  int32_t dropped = 0;
  for (int32_t i = 0; i < T; ++i) {
    int32_t n_look = 0;
    // Place word `wid` spanning (i, j]; false on a lookahead overflow.
    auto emit = [&](int32_t wid, int32_t j) {
      int32_t& k = count[j];
      if (k >= N_max) {
        ++dropped;
        return true;
      }
      int32_t cidx = 0;  // the word's column in start i's lookahead row
      while (cidx < n_look && look[cidx] != wid) ++cidx;
      if (cidx == n_look) {
        if (n_look >= C_max) return false;
        look[n_look++] = wid;
      }
      if (j <= W)
        out[(j - 1) * N_max + k] = wid | (i << kStartShift) |
                                   (cidx << kCidxShift) | (1 << kMaskShift);
      ++k;
      return true;
    };
    const int32_t j_end = std::min(i + M, T);
    int32_t node = (int32_t)lex.root();
    for (int32_t j = i + 1; j <= j_end; ++j) {
      node = lex.child((uint32_t)node, kana[j - 1]);
      const Edge* n = node < 0 ? nullptr : &lex.edges[node];
      if (n == nullptr || n->id_begin == n->id_end) {
        // single-kana <unk> fallback keeps the lattice connected
        if (j == i + 1 && !emit(lex.unk_id, j)) return -1;
        if (n == nullptr) break;
        continue;
      }
      for (int32_t q = n->id_begin; q < n->id_end; ++q)
        if (!emit(lex.ids[q], j)) return -1;
    }
  }
  return dropped;
}

}  // namespace

extern "C" {

// readings: concatenated UTF-32 codepoints; reading_offsets[n+1] delimits
// reading i; word_ids grouped per reading via id_offsets[n+1]; unk_id: the
// word of the single-kana fallback.
void* jlm_lexicon_create(const uint32_t* readings,
                         const int32_t* reading_offsets,
                         const int32_t* word_ids, const int32_t* id_offsets,
                         int32_t n_readings, int32_t unk_id) {
  // Insert into a trie of ordered maps, then place its edges breadth first.
  struct Build {
    std::map<uint32_t, int32_t> kids;
    int32_t reading = -1;
  };
  std::vector<Build> tmp(1);
  auto* lex = new Lexicon();
  for (int32_t r = 0; r < n_readings; ++r) {
    int32_t node = 0;
    for (int32_t c = reading_offsets[r]; c < reading_offsets[r + 1]; ++c) {
      auto it = tmp[node].kids.find(readings[c]);
      if (it == tmp[node].kids.end()) {
        tmp[node].kids.emplace(readings[c], (int32_t)tmp.size());
        node = (int32_t)tmp.size();
        tmp.emplace_back();
      } else {
        node = it->second;
      }
    }
    tmp[node].reading = r;
    lex->max_reading_len = std::max<int>(
        lex->max_reading_len, reading_offsets[r + 1] - reading_offsets[r]);
  }
  int bits = 1;
  while ((size_t(1) << bits) < tmp.size() * 4 / 3) ++bits;
  lex->edges.assign(size_t(1) << bits, Edge{0, kFree, 0, 0});
  lex->mask = (uint32_t)((size_t(1) << bits) - 1);
  lex->shift = 64 - bits;
  std::vector<uint32_t> at(tmp.size());  // a built node's slot
  std::vector<int32_t> order{0};
  at[0] = lex->root();
  for (size_t q = 0; q < order.size(); ++q)
    for (const auto& kv : tmp[order[q]].kids) {
      uint32_t h = lex->slot(at[order[q]], kv.first);
      while (lex->edges[h].cp != kFree) h = (h + 1) & lex->mask;
      Edge& e = lex->edges[h];
      e.parent = at[order[q]];
      e.cp = kv.first;
      e.id_begin = (int32_t)lex->ids.size();
      const int32_t r = tmp[kv.second].reading;
      if (r >= 0)
        lex->ids.insert(lex->ids.end(), word_ids + id_offsets[r],
                        word_ids + id_offsets[r + 1]);
      e.id_end = (int32_t)lex->ids.size();
      at[kv.second] = h;
      order.push_back(kv.second);
    }
  lex->unk_id = unk_id;
  return lex;
}

void jlm_lexicon_destroy(void* p) { delete static_cast<Lexicon*>(p); }

// Build and pack S sentences into out[S * W * N_max] (row-major, zeroed by
// the caller).  kana: the sentences' UTF-32 codepoints concatenated,
// sentence s at [offsets[s], offsets[s+1]).  Frames past W are not written
// (their nodes still count toward drops and lookahead rows).  Returns the
// total of nodes dropped beyond the per-frame budget N_max (>= 0; 0 =
// lossless), or -(s + 1) if sentence s overflows a lookahead row of C_max
// (always fatal).  Drops must be surfaced, never swallowed: the reference's
// lattices are uncapped and a silent drop is a top-1 parity hazard
// (SURVEY.md §4.5).
int64_t jlm_build_packed_batch(const void* lex_p, const uint32_t* kana,
                               const int64_t* offsets, int32_t S, int32_t W,
                               int32_t N_max, int32_t C_max,
                               int32_t max_word_len, int32_t* out) {
  const auto& lex = *static_cast<const Lexicon*>(lex_p);
  const int32_t M = std::min<int32_t>(max_word_len, lex.max_reading_len);
  int64_t T_most = 0;
  for (int32_t s = 0; s < S; ++s)
    T_most = std::max<int64_t>(T_most, offsets[s + 1] - offsets[s]);
  std::vector<int32_t> count(T_most + 1), look(std::max(C_max, 1));
  const int64_t stride = (int64_t)W * N_max;
  int64_t dropped = 0;
  for (int32_t s = 0; s < S; ++s) {
    const int32_t rc = build_one(
        lex, kana + offsets[s], (int32_t)(offsets[s + 1] - offsets[s]), W,
        N_max, C_max, M, out + s * stride, count.data(), look.data());
    if (rc < 0) return -(int64_t)s - 1;
    dropped += rc;
  }
  return dropped;
}

}  // extern "C"
