// shredword_tpu native runtime — internal declarations.
//
// This is a brand-new implementation (no code copied from the reference).
// The "faithful" trainer reproduces the *observable behavior* of the
// reference C++ trainer (see docs/CONFORMANCE.md for the derived spec;
// reference behaviors cited per function as file:line of
// the reference's shredword/csrc/...), so it can serve as the bit-exact
// conformance oracle and as a fast CPU backend.  The TPU path (JAX/Pallas)
// is the primary compute path; this runtime supplies corpus ingestion,
// the conformance oracle, and a fast CPU encoder.

#pragma once

#include <cstdint>
#include <cstddef>
#include <string>
#include <vector>

namespace shred {

// Worker-thread policy shared by the corpus loader and the encoder:
// explicit count if > 0, else hardware_concurrency - 2 (floor 1) — the
// reference's dormant threads.cpp:13-24 policy.  Defined in corpus.cpp.
int auto_threads(int nthreads);

// ---------------------------------------------------------------------------
// Config (parity with reference BPEConfig, bpe.h:43-48; defaulting rules
// mirror create_trainer, bpe.cpp:124-130).
// ---------------------------------------------------------------------------
struct Config {
  int64_t target_vocab_size = 8192;
  int32_t unk_id = -1;
  double character_coverage = 0.995;  // faithful path narrows to float
  uint64_t min_pair_freq = 2000;
};

// ---------------------------------------------------------------------------
// Corpus: unique whitespace-separated words with occurrence counts.
// Two orderings:
//   * faithful: reference StrMap iteration order (djb2 & 4095 bucket,
//     first-touch order within bucket) — required for oracle conformance.
//   * canonical: (count desc, bytes asc) — deterministic regardless of
//     thread count; used by the TPU trainer.
// ---------------------------------------------------------------------------
struct Corpus {
  std::vector<std::string> words;   // unique words, in chosen order
  std::vector<uint64_t> counts;     // per-word occurrence counts
  uint64_t total_raw_bytes = 0;     // bytes scanned from the input
  uint64_t total_word_occurrences = 0;

  size_t num_words() const { return words.size(); }
  uint64_t unique_bytes() const;
};

// Tokenize `data` by {' ', '\t', '\r', '\n'} (reference strtok delimiters,
// bpe.cpp:247) and deduplicate.  faithful_order selects ordering (above).
// nthreads <= 0 means auto (hardware_concurrency - 2, floor 1 — the policy
// of the reference's dormant threads.cpp:13-24, here actually used).
Corpus build_corpus(const uint8_t* data, int64_t len, bool faithful_order,
                    int nthreads);
// Bounded-memory streaming loader (block-wise reads; identical output
// to build_corpus on the same file, including faithful order).
Corpus build_corpus_streaming(const char* path, bool faithful_order,
                              int nthreads, int64_t block_bytes, bool* ok);
Corpus build_corpus_from_file(const char* path, bool faithful_order,
                              int nthreads, bool* ok);

// ---------------------------------------------------------------------------
// Character coverage: decide which byte values are kept (the rest map to
// unk_id).  Mirrors bpe_load_corpus steps 2-3 (bpe.cpp:256-279):
// histogram counts each byte once per *unique word* (not weighted by word
// frequency), iteration order is the reference char StrMap order
// ((165 + byte) & 255 ascending), sort is stable descending by count,
// keep = floor(n_unique_chars * float(coverage)).
// ---------------------------------------------------------------------------
struct CoverageResult {
  bool keep[256];
  int n_unique = 0;
  int n_kept = 0;
};
CoverageResult compute_coverage(const Corpus& corpus, double coverage);

// ---------------------------------------------------------------------------
// Faithful trainer (conformance oracle / CPU backend).
// ---------------------------------------------------------------------------
struct MergeRecord {
  int32_t first, second;
  uint64_t freq;  // frequency at merge time (for diagnostics)
};

class FaithfulTrainer {
 public:
  struct HeapEntry {
    int32_t a, b;
    uint64_t freq;
    uint32_t version;
  };

  explicit FaithfulTrainer(const Config& cfg);

  // Build symbol chains from corpus (applies coverage + unk mapping;
  // mirrors build_symbol_cb, histogram.cpp:7-27).
  void load(const Corpus& corpus);

  // Run merges until target vocab reached or no eligible pair remains.
  // Returns number of merges performed in this call.  max_merges < 0 means
  // "until done" (bpe_train semantics, bpe.cpp:597-655); >= 0 gives the
  // incremental/checkpointable form (bpe_merge_batch semantics).
  int train(int max_merges = -1);

  const std::vector<MergeRecord>& merges() const { return merges_; }
  const Config& config() const { return cfg_; }

  // Serialize in the reference formats (bpe_save, bpe.cpp:678-739):
  //   model: little-endian int32 triples (first, second, 256+m)
  //   vocab: "<token-bytes> <corpus-frequency>\n" for ids 0..255+M
  bool save(const char* model_path, const char* vocab_path) const;

  // Current live token stream (post-merge corpus state), flattened in word
  // order with per-token word ids — the hand-off format for the TPU path
  // and for conformance checks of merge application.
  void export_tokens(std::vector<int32_t>* tokens,
                     std::vector<int32_t>* word_ids) const;

  // Token frequencies over the final corpus (vocab file parity).
  std::vector<uint64_t> token_frequencies() const;

  int n_kept_chars() const { return coverage_.n_kept; }
  int n_unique_chars() const { return coverage_.n_unique; }

  // Test/debug hooks: run counting only and expose the raw heap array.
  void debug_init_counts() { init_counts(); }
  const std::vector<HeapEntry>& debug_heap() const { return heap_; }

 private:
  void init_counts();  // bpe_init + bpe_count_bigrams equivalent
  bool merge_step();   // one greedy merge; false when exhausted

  Config cfg_;
  CoverageResult coverage_;

  // Symbol arena: index-linked token chains (reference Symbol lists,
  // bpe.h:25-30, as flat arrays — same semantics, cache-friendly).
  std::vector<int32_t> ids_;
  std::vector<int32_t> nxt_;   // -1 = end
  std::vector<int32_t> prv_;   // -1 = start
  std::vector<int32_t> word_head_;
  std::vector<uint64_t> word_counts_;

  // Pair-count table with reference BIMap semantics (hash.cpp:94-130):
  // FNV-1a over the 8 key bytes, 4096 buckets, append-order chains.
  struct BiEntry {
    int32_t a, b;
    uint64_t freq;
    uint32_t version;
  };
  std::vector<std::vector<BiEntry>> bimap_;
  BiEntry& bimap_get(int32_t a, int32_t b);

  std::vector<HeapEntry> heap_;  // binary max-heap, reference sift rules
  void heap_push(int32_t a, int32_t b, uint64_t freq, uint32_t version);
  HeapEntry heap_pop();

  std::vector<MergeRecord> merges_;
  bool counted_ = false;
};

// ---------------------------------------------------------------------------
// CPU encoder: greedy lowest-merge-rank-first BPE encoding (the standard
// contract implied by the reference's merges table + base.py merge()
// semantics, base.py:22-36: overlapping runs consume left-to-right).
// ---------------------------------------------------------------------------
class Encoder {
 public:
  // merges: n x 2 int32 (first, second), rank m -> id 256+m.
  Encoder(const int32_t* merges, int64_t n_merges);

  // Encode one pre-token (byte string) into ids.
  void encode_word(const uint8_t* bytes, size_t len,
                   std::vector<int32_t>* out) const;

  // Encode many words with memoization of repeated words.
  // words are concatenated in `bytes` with `offsets` (n+1 entries).
  std::vector<int32_t> encode_words(const uint8_t* bytes,
                                    const int64_t* offsets, int64_t n_words,
                                    bool cache) const;

  // Apply the merge table to an int32 token sequence (checkpoint
  // replay over unk-mapped training words).
  void apply_to_tokens(const int32_t* ids_in, size_t len,
                       std::vector<int32_t>* out) const;

  // Whole-text encode: lossless whitespace chunking + memoized word
  // encode in one native pass; large inputs fan out over worker threads
  // split at run boundaries (bit-identical to single-thread).
  std::vector<int32_t> encode_text(const uint8_t* data, int64_t len,
                                   bool cache, int nthreads = 0) const;

  // One thread's share: encode [begin, end), both at run boundaries.
  std::vector<int32_t> encode_text_range(const uint8_t* data, int64_t begin,
                                         int64_t end, bool cache) const;

  int64_t n_merges() const { return n_merges_; }

 private:
  int32_t rank_of(int32_t a, int32_t b) const;  // -1 if not a merge
  int64_t n_merges_;
  std::vector<int32_t> pairs_;  // rank -> (a, b)
  // open-addressing hash table (power-of-two) pair -> rank
  std::vector<uint64_t> keys_;
  std::vector<int32_t> ranks_;
  uint64_t mask_;
};

uint64_t fnv1a64(const void* data, size_t len);

}  // namespace shred
