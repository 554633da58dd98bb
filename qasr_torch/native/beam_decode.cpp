// Native (host-side) CTC prefix beam-search decoder.
//
// Capability parity: the reference decodes with its backend's native CPU beam
// search (K.ctc_decode(greedy=False, beam_width=W); SURVEY.md §2a C9, §3.4).
// qasr has two decoders: the jittable on-device lax.scan beam
// (qasr/decode/beam.py) and this C++ one for host-side batch eval, so decode
// can overlap with device training. Same algorithm, exact prefix merge via a
// hash map (no rolling-hash approximation), threaded over the batch.
//
// Within one frame, two distinct parents cannot extend to the same prefix
// (p1+a == p2+b implies p1==p2, a==b), so the only duplicate pairing is an
// extend-candidate hitting an existing beam prefix — identical merge
// structure to the device beam, hence bitwise-comparable hypotheses.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kNegInf = -1e30f;

inline float logaddexp(float a, float b) {
  if (a <= kNegInf / 2) return b;
  if (b <= kNegInf / 2) return a;
  float m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

// Prefixes live in a parent-pointer trie so beam copies are O(1).
struct TrieNode {
  int32_t parent;  // index into trie, -1 for root
  int32_t token;
  int32_t len;
};

struct Hyp {
  int32_t node;  // trie index (-1 = empty prefix)
  float pb;      // log P(prefix, ending in blank)
  float pnb;     // log P(prefix, ending in non-blank)
  float total() const { return logaddexp(pb, pnb); }
};

void decode_one(const float* logits, int T, int V, int length, int beam_width,
                int blank_id, int max_len, float prune_logp, int32_t* out_seq,
                int32_t* out_len, float* out_score) {
  std::vector<TrieNode> trie;
  trie.reserve(static_cast<size_t>(beam_width) * (length > 0 ? length : 1));

  std::vector<Hyp> beam{{-1, 0.0f, kNegInf}};
  std::vector<float> logp(V);

  // Next-step candidates keyed by the trie node of the RESULTING prefix
  // (stay: parent's own node; extend: the interned child node), so an
  // extend-candidate that equals another hypothesis's stay-candidate lands
  // on the same key and their mass merges exactly.
  struct Cand {
    float pb = kNegInf, pnb = kNegInf;
  };
  std::unordered_map<int32_t, Cand> next;
  std::unordered_map<int64_t, int32_t> child;  // (parent,token) -> trie idx

  auto intern = [&](int32_t parent, int32_t tok) -> int32_t {
    int64_t key = (static_cast<int64_t>(parent) << 20) | tok;
    auto it = child.find(key);
    if (it != child.end()) return it->second;
    int32_t plen = parent >= 0 ? trie[parent].len : 0;
    trie.push_back({parent, tok, plen + 1});
    int32_t node = static_cast<int32_t>(trie.size()) - 1;
    child.emplace(key, node);
    return node;
  };

  for (int t = 0; t < length && t < T; ++t) {
    const float* row = logits + static_cast<int64_t>(t) * V;
    float m = row[0];
    for (int v = 1; v < V; ++v) m = std::max(m, row[v]);
    float s = 0.0f;
    for (int v = 0; v < V; ++v) s += std::exp(row[v] - m);
    float lse = m + std::log(s);
    for (int v = 0; v < V; ++v) logp[v] = row[v] - lse;

    next.clear();
    for (const Hyp& h : beam) {
      int last = h.node >= 0 ? trie[h.node].token : -1;
      int plen = h.node >= 0 ? trie[h.node].len : 0;
      float ptot = h.total();

      // stay: blank emission plus collapsed repeat
      Cand& stay = next[h.node];
      stay.pb = logaddexp(stay.pb, ptot + logp[blank_id]);
      if (last >= 0)
        stay.pnb = logaddexp(stay.pnb, h.pnb + logp[last]);

      if (plen >= max_len) continue;
      for (int v = 0; v < V; ++v) {
        if (v == blank_id) continue;
        // emission pruning (same rule as the device beam's prune_logp):
        // low-probability tokens never extend a prefix
        if (logp[v] < prune_logp) continue;
        // after a repeat token, only the blank-ending mass extends
        float base = (v == last) ? h.pb : ptot;
        if (base <= kNegInf / 2) continue;
        Cand& c = next[intern(h.node, v)];
        c.pnb = logaddexp(c.pnb, base + logp[v]);
      }
    }

    // materialize candidates, keep top beam_width by total probability
    std::vector<std::pair<float, int32_t>> scored;
    scored.reserve(next.size());
    for (const auto& kv : next)
      scored.emplace_back(logaddexp(kv.second.pb, kv.second.pnb), kv.first);
    int keep = std::min<int>(beam_width, static_cast<int>(scored.size()));
    std::partial_sort(
        scored.begin(), scored.begin() + keep, scored.end(),
        [](const auto& a, const auto& b) { return a.first > b.first; });

    std::vector<Hyp> nbeam;
    nbeam.reserve(keep);
    for (int i = 0; i < keep; ++i) {
      const Cand& c = next[scored[i].second];
      nbeam.push_back({scored[i].second, c.pb, c.pnb});
    }
    beam.swap(nbeam);
  }

  const Hyp* best = &beam[0];
  for (const Hyp& h : beam)
    if (h.total() > best->total()) best = &h;

  int32_t len = best->node >= 0 ? trie[best->node].len : 0;
  len = std::min(len, max_len);
  for (int i = 0; i < max_len; ++i) out_seq[i] = -1;
  int32_t node = best->node;
  for (int i = len - 1; i >= 0 && node >= 0; --i) {
    out_seq[i] = trie[node].token;
    node = trie[node].parent;
  }
  *out_len = len;
  *out_score = best->total();
}

}  // namespace

extern "C" {

// logits: [B, T, V] raw (log-softmax applied internally);
// lengths: [B]; prune_logp: drop extend-candidates whose frame log-prob is
// below this (pass <= -1e30 to disable); out_seqs: [B, max_len] (-1 padded);
// out_lens/out_scores: [B].
void qasr_ctc_beam_decode(const float* logits, const int32_t* lengths, int B,
                          int T, int V, int beam_width, int blank_id,
                          int max_len, float prune_logp, int32_t* out_seqs,
                          int32_t* out_lens, float* out_scores) {
  int n_threads = std::min<int>(
      B, std::max(1u, std::thread::hardware_concurrency()));
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int w = 0; w < n_threads; ++w) {
    pool.emplace_back([&, w]() {
      for (int b = w; b < B; b += n_threads) {
        decode_one(logits + static_cast<int64_t>(b) * T * V, T, V,
                   std::min<int32_t>(lengths[b], T), beam_width, blank_id,
                   max_len, prune_logp,
                   out_seqs + static_cast<int64_t>(b) * max_len,
                   out_lens + b, out_scores + b);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
