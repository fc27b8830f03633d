// Faithful BPE trainer — the conformance oracle / CPU backend.
//
// Reproduces the observable behavior of the reference trainer
// (the reference's shredword/csrc/bpe/bpe.cpp) including its
// equal-frequency tie-breaking, which is an artifact of:
//   * initial heap fill order  = BIMap iteration order (FNV-1a & 4095
//     buckets, first-touch append order; hash.cpp:104-130, bpe.cpp:358-366)
//   * per-merge re-push order  = FreqChangeMap iteration order (1024
//     buckets keyed by ((a<<32)|b) % 1024 with *prepend* chains, i.e.
//     reverse first-touch within bucket; bpe.cpp:10-58, 486-517)
//   * binary-heap sift rules   = strict '>' on pop, '>=' break on push
//     (heap.cpp:53-114)
// plus the reference's sign-extension quirk: delta keys are built as
// ((uint64)a << 32) | (uint64)b with b sign-extended, so with unk_id=-1
// every (x, unk) delta collapses into the single key 0xFFFF...F, decoded
// back as (-1,-1) (bpe.cpp:456-468, 491).  All of this is re-implemented
// from the derived spec (docs/CONFORMANCE.md), not copied.

#include "shred_native.hpp"

#include <cstdio>
#include <cstring>

namespace shred {

namespace {
constexpr int kBiBuckets = 4096;  // reference MIN_HEAP_SIZE, bpe.h:19
constexpr int kFreqBuckets = 1024;  // reference FREQ_CHANGE_BUCKETS, bpe.cpp:17
constexpr int32_t kBaseVocab = 256;  // INITIAL_VOCAB_SIZE, bpe.h:20

// FNV-1a (32-bit) over the 8 little-endian bytes of (a, b) — reference
// hash_pair, hash.cpp:7-16.
inline uint32_t pair_hash32(int32_t a, int32_t b) {
  uint8_t bytes[8];
  std::memcpy(bytes, &a, 4);
  std::memcpy(bytes + 4, &b, 4);
  uint32_t h = 2166136261u;
  for (int i = 0; i < 8; i++) {
    h ^= bytes[i];
    h *= 16777619u;
  }
  return h;
}

// Reference delta key: C implicit conversions sign-extend both halves
// (bpe.cpp:456).
inline uint64_t delta_key(int32_t a, int32_t b) {
  return ((uint64_t)(int64_t)a << 32) | (uint64_t)(int64_t)b;
}
}  // namespace

FaithfulTrainer::FaithfulTrainer(const Config& cfg) : cfg_(cfg) {
  // Defaulting parity with create_trainer (bpe.cpp:124-130).
  if (cfg_.character_coverage <= 0.0 || cfg_.character_coverage >= 1.0)
    cfg_.character_coverage = 0.995;
  if (cfg_.min_pair_freq == 0) cfg_.min_pair_freq = 2000;
  bimap_.resize(kBiBuckets);
}

void FaithfulTrainer::load(const Corpus& corpus) {
  coverage_ = compute_coverage(corpus, cfg_.character_coverage);
  size_t n = corpus.num_words();
  word_head_.assign(n, -1);
  word_counts_.assign(n, 0);
  uint64_t total = corpus.unique_bytes();
  ids_.reserve(total);
  nxt_.reserve(total);
  prv_.reserve(total);
  for (size_t wi = 0; wi < n; wi++) {
    const std::string& w = corpus.words[wi];
    word_counts_[wi] = corpus.counts[wi];
    int32_t prev = -1;
    for (size_t i = 0; i < w.size(); i++) {
      uint8_t c = (uint8_t)w[i];
      int32_t idx = (int32_t)ids_.size();
      // byte id if kept else unk (build_symbol_cb, histogram.cpp:15)
      ids_.push_back(coverage_.keep[c] ? (int32_t)c : cfg_.unk_id);
      prv_.push_back(prev);
      nxt_.push_back(-1);
      if (prev >= 0)
        nxt_[prev] = idx;
      else
        word_head_[wi] = idx;
      prev = idx;
    }
  }
  counted_ = false;
  merges_.clear();
}

FaithfulTrainer::BiEntry& FaithfulTrainer::bimap_get(int32_t a, int32_t b) {
  auto& bucket = bimap_[pair_hash32(a, b) & (kBiBuckets - 1)];
  for (auto& e : bucket)
    if (e.a == a && e.b == b) return e;
  bucket.push_back({a, b, 0, 0});
  return bucket.back();
}

void FaithfulTrainer::heap_push(int32_t a, int32_t b, uint64_t freq,
                                uint32_t version) {
  heap_.push_back({a, b, freq, version});
  size_t idx = heap_.size() - 1;
  while (idx > 0) {
    size_t p = (idx - 1) >> 1;
    if (heap_[p].freq >= heap_[idx].freq) break;  // heap.cpp:76
    std::swap(heap_[p], heap_[idx]);
    idx = p;
  }
}

FaithfulTrainer::HeapEntry FaithfulTrainer::heap_pop() {
  HeapEntry top = heap_[0];
  heap_[0] = heap_.back();
  heap_.pop_back();
  size_t size = heap_.size(), idx = 0;
  while (true) {
    size_t left = (idx << 1) + 1, right = left + 1, best = idx;
    if (left < size && heap_[left].freq > heap_[best].freq) best = left;
    if (right < size && heap_[right].freq > heap_[best].freq) best = right;
    if (best == idx) break;
    std::swap(heap_[idx], heap_[best]);
    idx = best;
  }
  return top;
}

// bpe_init + bpe_count_bigrams (bpe.cpp:171-185, 315-370): fresh count of
// all adjacent pairs (skipping unk on either side), then heap fill in BIMap
// iteration order for pairs with freq >= min_pair_freq.
void FaithfulTrainer::init_counts() {
  for (auto& bucket : bimap_) bucket.clear();
  heap_.clear();
  for (size_t wi = 0; wi < word_head_.size(); wi++) {
    uint64_t wc = word_counts_[wi];
    for (int32_t s = word_head_[wi]; s >= 0 && nxt_[s] >= 0; s = nxt_[s]) {
      int32_t a = ids_[s], b = ids_[nxt_[s]];
      if (a == cfg_.unk_id || b == cfg_.unk_id) continue;
      bimap_get(a, b).freq += wc;
    }
  }
  for (auto& bucket : bimap_)
    for (auto& e : bucket)
      if (e.freq >= cfg_.min_pair_freq) heap_push(e.a, e.b, e.freq, e.version);
  counted_ = true;
}

// One greedy merge step (the body of bpe_merge_batch, bpe.cpp:391-535).
// Returns false when the heap is exhausted.
bool FaithfulTrainer::merge_step() {
  uint64_t min_freq = cfg_.min_pair_freq;
  while (!heap_.empty()) {
    HeapEntry top = heap_pop();
    BiEntry& info0 = bimap_get(top.a, top.b);
    if (top.version != info0.version) continue;  // stale (bpe.cpp:412)
    uint64_t current_freq = info0.freq;
    if (current_freq < min_freq) continue;  // bpe.cpp:419

    int32_t new_id = kBaseVocab + (int32_t)merges_.size();
    int32_t ka = top.a, kb = top.b;
    merges_.push_back({ka, kb, current_freq});

    // Per-merge delta map with reference FreqChangeMap semantics:
    // 1024 buckets of ((a<<32)|b) % 1024, prepend chains => application
    // order is bucket-ascending, reverse first-touch within bucket.
    struct Delta {
      uint64_t key;
      int64_t delta;
    };
    std::vector<std::vector<Delta>> freq_changes(kFreqBuckets);
    auto add_delta = [&](uint64_t key, int64_t d) {
      auto& bucket = freq_changes[key % kFreqBuckets];
      for (auto& fc : bucket)
        if (fc.key == key) {
          fc.delta += d;
          return;
        }
      bucket.push_back({key, d});
    };

    // Full scan; splice in place; do not advance after a merge so
    // overlapping runs merge left-to-right (bpe.cpp:437-482).
    for (size_t wi = 0; wi < word_head_.size(); wi++) {
      uint64_t wc = word_counts_[wi];
      int32_t s = word_head_[wi];
      while (s >= 0 && nxt_[s] >= 0) {
        int32_t nx = nxt_[s];
        if (ids_[s] != ka || ids_[nx] != kb) {
          s = nx;
          continue;
        }
        if (prv_[s] >= 0)
          add_delta(delta_key(ids_[prv_[s]], ids_[s]), -(int64_t)wc),
              add_delta(delta_key(ids_[prv_[s]], new_id), (int64_t)wc);
        int32_t nn = nxt_[nx];
        if (nn >= 0)
          add_delta(delta_key(ids_[nx], ids_[nn]), -(int64_t)wc),
              add_delta(delta_key(new_id, ids_[nn]), (int64_t)wc);
        // splice: s absorbs nx
        ids_[s] = new_id;
        nxt_[s] = nn;
        if (nn >= 0) prv_[nn] = s;
      }
    }

    // Apply deltas; version-bump + re-push only at/above threshold
    // (bpe.cpp:486-517).
    for (int bkt = 0; bkt < kFreqBuckets; bkt++) {
      auto& chain = freq_changes[bkt];
      for (auto it = chain.rbegin(); it != chain.rend(); ++it) {
        int32_t pa = (int32_t)(it->key >> 32);
        int32_t pb = (int32_t)(it->key & 0xFFFFFFFFull);
        if (pa == ka && pb == kb) continue;  // merged pair handled below
        BiEntry& pe = bimap_get(pa, pb);
        if (it->delta < 0) {
          uint64_t ad = (uint64_t)(-it->delta);
          pe.freq = pe.freq >= ad ? pe.freq - ad : 0;
        } else {
          pe.freq += (uint64_t)it->delta;
        }
        if (pe.freq >= min_freq) {
          pe.version++;
          heap_push(pa, pb, pe.freq, pe.version);
        }
      }
    }

    // Retire the merged pair (re-fetch: bucket vectors may have grown).
    BiEntry& info = bimap_get(ka, kb);
    info.freq = 0;
    info.version++;
    return true;
  }
  return false;
}

int FaithfulTrainer::train(int max_merges) {
  if (!counted_) init_counts();
  int64_t target = cfg_.target_vocab_size - kBaseVocab;  // bpe.cpp:605
  int done = 0;
  while ((int64_t)merges_.size() < target &&
         (max_merges < 0 || done < max_merges)) {
    if (!merge_step()) break;
    done++;
  }
  return done;
}

void FaithfulTrainer::export_tokens(std::vector<int32_t>* tokens,
                                    std::vector<int32_t>* word_ids) const {
  tokens->clear();
  word_ids->clear();
  for (size_t wi = 0; wi < word_head_.size(); wi++)
    for (int32_t s = word_head_[wi]; s >= 0; s = nxt_[s]) {
      tokens->push_back(ids_[s]);
      word_ids->push_back((int32_t)wi);
    }
}

std::vector<uint64_t> FaithfulTrainer::token_frequencies() const {
  size_t T = (size_t)kBaseVocab + merges_.size();
  std::vector<uint64_t> freq(T, 0);
  for (size_t wi = 0; wi < word_head_.size(); wi++)
    for (int32_t s = word_head_[wi]; s >= 0; s = nxt_[s]) {
      int32_t id = ids_[s];
      if (id >= 0 && (size_t)id < T) freq[id] += word_counts_[wi];
    }
  return freq;
}

// Reference bpe_save formats (bpe.cpp:678-739).  Token strings are built
// with C-string concatenation semantics: byte 0's string is empty (the
// reference writes it via %s, so it contributes no bytes anywhere).
bool FaithfulTrainer::save(const char* model_path,
                           const char* vocab_path) const {
  size_t M = merges_.size();
  size_t T = (size_t)kBaseVocab + M;
  std::vector<std::string> toks(T);
  for (int i = 1; i < kBaseVocab; i++) toks[i] = std::string(1, (char)i);
  // toks[0] stays empty (reference C-string of byte 0 has strlen 0)
  for (size_t m = 0; m < M; m++) {
    // ids outside [0, T) cannot occur in merge ops recorded by the
    // reference except via the unk quirk; guard to avoid OOB.
    int32_t a = merges_[m].first, b = merges_[m].second;
    std::string sa = (a >= 0 && (size_t)a < T) ? toks[a] : std::string();
    std::string sb = (b >= 0 && (size_t)b < T) ? toks[b] : std::string();
    toks[kBaseVocab + m] = sa + sb;
  }
  std::vector<uint64_t> freq = token_frequencies();

  FILE* vf = fopen(vocab_path, "wb");
  if (!vf) return false;
  for (size_t i = 0; i < T; i++) {
    fwrite(toks[i].data(), 1, toks[i].size(), vf);
    fprintf(vf, " %llu\n", (unsigned long long)freq[i]);
  }
  fclose(vf);

  FILE* mf = fopen(model_path, "wb");
  if (!mf) return false;
  for (size_t m = 0; m < M; m++) {
    int32_t rec[3] = {merges_[m].first, merges_[m].second,
                      (int32_t)(kBaseVocab + m)};
    fwrite(rec, sizeof(int32_t), 3, mf);
  }
  fclose(mf);
  return true;
}

}  // namespace shred
