// CPU encoder: greedy lowest-rank-first BPE encoding.
//
// The reference never implements encode (base.py:107-109); the contract is
// the standard one implied by its merges table + merge() semantics
// (base.py:22-36): repeatedly merge the pair with the lowest merge rank
// present in the word, consuming overlapping runs left-to-right, until no
// adjacent pair is a known merge.

#include "shred_native.hpp"

#include <cstring>
#include <thread>
#include <unordered_map>

namespace shred {

namespace {
inline uint64_t pack(int32_t a, int32_t b) {
  return ((uint64_t)(uint32_t)a << 32) | (uint64_t)(uint32_t)b;
}
}  // namespace

Encoder::Encoder(const int32_t* merges, int64_t n_merges)
    : n_merges_(n_merges) {
  pairs_.assign(merges, merges + 2 * n_merges);
  size_t cap = 16;
  while (cap < (size_t)n_merges * 2 + 2) cap <<= 1;
  keys_.assign(cap, 0);
  ranks_.assign(cap, -1);
  mask_ = cap - 1;
  for (int64_t m = 0; m < n_merges; m++) {
    uint64_t key = pack(merges[2 * m], merges[2 * m + 1]);
    size_t slot = (size_t)(fnv1a64(&key, 8) & mask_);
    while (ranks_[slot] != -1) {
      if (keys_[slot] == key) break;  // keep the earliest rank (first wins)
      slot = (slot + 1) & mask_;
    }
    if (ranks_[slot] == -1) {
      keys_[slot] = key;
      ranks_[slot] = (int32_t)m;
    }
  }
}

int32_t Encoder::rank_of(int32_t a, int32_t b) const {
  uint64_t key = pack(a, b);
  size_t slot = (size_t)(fnv1a64(&key, 8) & mask_);
  while (ranks_[slot] != -1) {
    if (keys_[slot] == key) return ranks_[slot];
    slot = (slot + 1) & mask_;
  }
  return -1;
}

void Encoder::encode_word(const uint8_t* bytes, size_t len,
                          std::vector<int32_t>* out) const {
  size_t start = out->size();
  for (size_t i = 0; i < len; i++) out->push_back((int32_t)bytes[i]);
  if (len < 2) return;

  // Work in place over out[start:].  Each round: find the minimum rank
  // among adjacent pairs, then substitute all its occurrences
  // left-to-right (overlaps consumed greedily).
  int32_t* ids = out->data() + start;
  size_t n = len;
  while (n >= 2) {
    int32_t best = -1;
    for (size_t i = 0; i + 1 < n; i++) {
      int32_t r = rank_of(ids[i], ids[i + 1]);
      if (r >= 0 && (best < 0 || r < best)) best = r;
    }
    if (best < 0) break;
    int32_t a = pairs_[2 * best], b = pairs_[2 * best + 1];
    int32_t new_id = 256 + best;
    size_t w = 0, i = 0;
    while (i < n) {
      if (i + 1 < n && ids[i] == a && ids[i + 1] == b) {
        ids[w++] = new_id;
        i += 2;
      } else {
        ids[w++] = ids[i++];
      }
    }
    n = w;
  }
  out->resize(start + n);
}

void Encoder::apply_to_tokens(const int32_t* ids_in, size_t len,
                              std::vector<int32_t>* out) const {
  // Same merge loop as encode_word but over an arbitrary int32 token
  // sequence (e.g. unk-mapped training words for checkpoint replay).
  size_t start = out->size();
  out->insert(out->end(), ids_in, ids_in + len);
  int32_t* ids = out->data() + start;
  size_t n = len;
  while (n >= 2) {
    int32_t best = -1;
    for (size_t i = 0; i + 1 < n; i++) {
      int32_t r = rank_of(ids[i], ids[i + 1]);
      if (r >= 0 && (best < 0 || r < best)) best = r;
    }
    if (best < 0) break;
    int32_t a = pairs_[2 * best], b = pairs_[2 * best + 1];
    int32_t new_id = 256 + best;
    size_t w = 0, i = 0;
    while (i < n) {
      if (i + 1 < n && ids[i] == a && ids[i + 1] == b) {
        ids[w++] = new_id;
        i += 2;
      } else {
        ids[w++] = ids[i++];
      }
    }
    n = w;
  }
  out->resize(start + n);
}

std::vector<int32_t> Encoder::encode_words(const uint8_t* bytes,
                                           const int64_t* offsets,
                                           int64_t n_words, bool cache) const {
  std::vector<int32_t> out;
  std::unordered_map<std::string, std::vector<int32_t>> memo;
  for (int64_t w = 0; w < n_words; w++) {
    const uint8_t* p = bytes + offsets[w];
    size_t len = (size_t)(offsets[w + 1] - offsets[w]);
    if (cache) {
      std::string key((const char*)p, len);
      auto it = memo.find(key);
      if (it == memo.end()) {
        std::vector<int32_t> ids;
        encode_word(p, len, &ids);
        it = memo.emplace(std::move(key), std::move(ids)).first;
      }
      out.insert(out.end(), it->second.begin(), it->second.end());
    } else {
      encode_word(p, len, &out);
    }
  }
  return out;
}

namespace {
inline bool enc_is_ws(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n';
}
}  // namespace

std::vector<int32_t> Encoder::encode_text_range(const uint8_t* data,
                                                int64_t begin, int64_t end,
                                                bool cache) const {
  // Encode [begin, end), which the caller guarantees starts and ends at
  // whitespace/word run boundaries: alternating word / whitespace runs,
  // every chunk pushed through the merge loop (whitespace chunks simply
  // have no applicable merges for whitespace-free models).
  std::vector<int32_t> out;
  out.reserve((size_t)(end - begin) / 3 + 16);
  std::unordered_map<std::string, std::vector<int32_t>> memo;
  memo.reserve(1 << 15);
  int64_t i = begin;
  std::string key;
  while (i < end) {
    int64_t j = i;
    bool ws = enc_is_ws(data[i]);
    while (j < end && enc_is_ws(data[j]) == ws) j++;
    size_t chunk_len = (size_t)(j - i);
    // single-byte chunks (most whitespace runs) need no merge loop and
    // no memo: a lone byte encodes to itself
    if (chunk_len == 1) {
      out.push_back((int32_t)data[i]);
      i = j;
      continue;
    }
    if (cache) {
      key.assign((const char*)data + i, chunk_len);
      auto it = memo.find(key);
      if (it == memo.end()) {
        std::vector<int32_t> ids;
        encode_word(data + i, chunk_len, &ids);
        it = memo.emplace(std::move(key), std::move(ids)).first;
      }
      out.insert(out.end(), it->second.begin(), it->second.end());
    } else {
      encode_word(data + i, chunk_len, &out);
    }
    i = j;
  }
  return out;
}

std::vector<int32_t> Encoder::encode_text(const uint8_t* data, int64_t len,
                                          bool cache, int nthreads) const {
  // Whole-text encode with the lossless whitespace chunking of
  // pretokenize.whitespace_keep_split.  Large inputs split into
  // per-thread ranges at run boundaries (a run never spans two ranges),
  // so the concatenated result is bit-identical to the single-thread
  // pass regardless of thread count.
  constexpr int64_t kMinPerThread = 1 << 20;  // 1 MB
  int nt = auto_threads(nthreads);
  int64_t max_by_size = len / kMinPerThread;
  if (max_by_size < (int64_t)nt) nt = (int)max_by_size;
  if (nt < 2) return encode_text_range(data, 0, len, cache);

  std::vector<int64_t> splits(nt + 1, len);
  splits[0] = 0;
  for (int t = 1; t < nt; t++) {
    int64_t p = len * t / nt;
    if (p <= splits[t - 1]) p = splits[t - 1];
    // advance to the next run boundary
    while (p < len && p > 0 && enc_is_ws(data[p - 1]) == enc_is_ws(data[p]))
      p++;
    splits[t] = p;
  }
  std::vector<std::vector<int32_t>> parts(nt);
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; t++) {
    workers.emplace_back([&, t] {
      parts[t] = encode_text_range(data, splits[t], splits[t + 1], cache);
    });
  }
  for (auto& w : workers) w.join();
  size_t total = 0;
  for (auto& p : parts) total += p.size();
  std::vector<int32_t> out;
  out.reserve(total);
  for (auto& p : parts) out.insert(out.end(), p.begin(), p.end());
  return out;
}

}  // namespace shred
