// extern "C" surface for ctypes (shredword_tpu/runtime/native.py).
//
// Unlike the reference's FFI (cbase.py declares struct layouts it never
// fills in — SURVEY.md §2.B caveat), every handle here is opaque and every
// array crosses the boundary as a caller-allocated buffer with explicit
// sizes queried first.

#include "shred_native.hpp"

#include <cstring>
#include <new>

using shred::Config;
using shred::Corpus;
using shred::Encoder;
using shred::FaithfulTrainer;

extern "C" {

struct ShredConfigC {
  int64_t target_vocab_size;
  int32_t unk_id;
  double character_coverage;
  uint64_t min_pair_freq;
};

// ---------------- corpus ----------------

void* shred_corpus_from_bytes(const uint8_t* data, int64_t len,
                              int faithful_order, int nthreads) {
  auto* c = new (std::nothrow) Corpus();
  if (!c) return nullptr;
  *c = shred::build_corpus(data, len, faithful_order != 0, nthreads);
  return c;
}

void* shred_corpus_from_file_streaming(const char* path, int faithful_order,
                                       int nthreads, int64_t block_bytes) {
  bool ok = false;
  Corpus corpus = shred::build_corpus_streaming(path, faithful_order != 0,
                                                nthreads, block_bytes, &ok);
  if (!ok) return nullptr;
  auto* c = new (std::nothrow) Corpus(std::move(corpus));
  return c;
}

void* shred_corpus_from_file(const char* path, int faithful_order,
                             int nthreads) {
  bool ok = false;
  Corpus corpus = shred::build_corpus_from_file(path, faithful_order != 0,
                                                nthreads, &ok);
  if (!ok) return nullptr;
  auto* c = new (std::nothrow) Corpus(std::move(corpus));
  return c;
}

int64_t shred_corpus_num_words(void* corpus) {
  return (int64_t)static_cast<Corpus*>(corpus)->num_words();
}

int64_t shred_corpus_unique_bytes(void* corpus) {
  return (int64_t)static_cast<Corpus*>(corpus)->unique_bytes();
}

int64_t shred_corpus_total_raw_bytes(void* corpus) {
  return (int64_t)static_cast<Corpus*>(corpus)->total_raw_bytes;
}

int64_t shred_corpus_total_occurrences(void* corpus) {
  return (int64_t)static_cast<Corpus*>(corpus)->total_word_occurrences;
}

// bytes_out: unique_bytes();  offsets_out: num_words()+1;  counts_out:
// num_words().
void shred_corpus_export(void* corpus, uint8_t* bytes_out,
                         int64_t* offsets_out, uint64_t* counts_out) {
  Corpus* c = static_cast<Corpus*>(corpus);
  int64_t off = 0;
  for (size_t i = 0; i < c->words.size(); i++) {
    offsets_out[i] = off;
    std::memcpy(bytes_out + off, c->words[i].data(), c->words[i].size());
    off += (int64_t)c->words[i].size();
    counts_out[i] = c->counts[i];
  }
  offsets_out[c->words.size()] = off;
}

void shred_corpus_free(void* corpus) { delete static_cast<Corpus*>(corpus); }

// Character-coverage keep mask (reference semantics; corpus.cpp
// compute_coverage).  keep_out: 256 bytes (0/1).  Returns n_unique<<8 |
// n_kept packed?  No — returns n_kept; n_unique via out param.
int shred_corpus_coverage(void* corpus, double coverage, uint8_t* keep_out,
                          int* n_unique_out) {
  auto res = shred::compute_coverage(*static_cast<Corpus*>(corpus), coverage);
  for (int i = 0; i < 256; i++) keep_out[i] = res.keep[i] ? 1 : 0;
  if (n_unique_out) *n_unique_out = res.n_unique;
  return res.n_kept;
}

// ---------------- faithful trainer ----------------

void* shred_trainer_create(const ShredConfigC* cfg) {
  Config c;
  c.target_vocab_size = cfg->target_vocab_size;
  c.unk_id = cfg->unk_id;
  c.character_coverage = cfg->character_coverage;
  c.min_pair_freq = cfg->min_pair_freq;
  return new (std::nothrow) FaithfulTrainer(c);
}

void shred_trainer_load(void* trainer, void* corpus) {
  static_cast<FaithfulTrainer*>(trainer)->load(*static_cast<Corpus*>(corpus));
}

int shred_trainer_train(void* trainer, int max_merges) {
  return static_cast<FaithfulTrainer*>(trainer)->train(max_merges);
}

int64_t shred_trainer_num_merges(void* trainer) {
  return (int64_t)static_cast<FaithfulTrainer*>(trainer)->merges().size();
}

// out: num_merges*2 int32 (first, second) in merge order.
void shred_trainer_get_merges(void* trainer, int32_t* out) {
  const auto& m = static_cast<FaithfulTrainer*>(trainer)->merges();
  for (size_t i = 0; i < m.size(); i++) {
    out[2 * i] = m[i].first;
    out[2 * i + 1] = m[i].second;
  }
}

void shred_trainer_get_merge_freqs(void* trainer, uint64_t* out) {
  const auto& m = static_cast<FaithfulTrainer*>(trainer)->merges();
  for (size_t i = 0; i < m.size(); i++) out[i] = m[i].freq;
}

int shred_trainer_save(void* trainer, const char* model_path,
                       const char* vocab_path) {
  return static_cast<FaithfulTrainer*>(trainer)->save(model_path, vocab_path)
             ? 0
             : -1;
}

int64_t shred_trainer_token_count(void* trainer) {
  std::vector<int32_t> toks, wids;
  static_cast<FaithfulTrainer*>(trainer)->export_tokens(&toks, &wids);
  return (int64_t)toks.size();
}

void shred_trainer_export_tokens(void* trainer, int32_t* tokens,
                                 int32_t* word_ids) {
  std::vector<int32_t> toks, wids;
  static_cast<FaithfulTrainer*>(trainer)->export_tokens(&toks, &wids);
  std::memcpy(tokens, toks.data(), toks.size() * sizeof(int32_t));
  std::memcpy(word_ids, wids.data(), wids.size() * sizeof(int32_t));
}

void shred_trainer_token_freqs(void* trainer, uint64_t* out, int64_t cap) {
  auto freq = static_cast<FaithfulTrainer*>(trainer)->token_frequencies();
  for (int64_t i = 0; i < cap && i < (int64_t)freq.size(); i++) out[i] = freq[i];
}

int shred_trainer_kept_chars(void* trainer) {
  return static_cast<FaithfulTrainer*>(trainer)->n_kept_chars();
}

int shred_trainer_unique_chars(void* trainer) {
  return static_cast<FaithfulTrainer*>(trainer)->n_unique_chars();
}

void shred_trainer_free(void* trainer) {
  delete static_cast<FaithfulTrainer*>(trainer);
}

// ---------------- encoder ----------------

void* shred_encoder_create(const int32_t* merges, int64_t n_merges) {
  return new (std::nothrow) Encoder(merges, n_merges);
}

// Encode words given as concatenated bytes + offsets (n_words+1 entries).
// Returns count written, or -(needed) if out_cap is too small (call again
// with a larger buffer).
int64_t shred_encode_words(void* encoder, const uint8_t* bytes,
                           const int64_t* offsets, int64_t n_words,
                           int use_cache, int32_t* out_ids, int64_t out_cap) {
  auto ids = static_cast<Encoder*>(encoder)->encode_words(
      bytes, offsets, n_words, use_cache != 0);
  if ((int64_t)ids.size() > out_cap) return -(int64_t)ids.size();
  std::memcpy(out_ids, ids.data(), ids.size() * sizeof(int32_t));
  return (int64_t)ids.size();
}

// Apply the merge table to int32 token words (checkpoint replay).
// tokens concatenated with offsets[n_words+1]; writes merged tokens and
// per-word output offsets.  Returns total written, or -(needed).
int64_t shred_apply_merges(void* encoder, const int32_t* tokens,
                           const int64_t* offsets, int64_t n_words,
                           int32_t* out_ids, int64_t out_cap,
                           int64_t* out_offsets) {
  auto* enc = static_cast<Encoder*>(encoder);
  std::vector<int32_t> out;
  out.reserve((size_t)offsets[n_words]);
  for (int64_t w = 0; w < n_words; w++) {
    out_offsets[w] = (int64_t)out.size();
    enc->apply_to_tokens(tokens + offsets[w],
                         (size_t)(offsets[w + 1] - offsets[w]), &out);
  }
  out_offsets[n_words] = (int64_t)out.size();
  if ((int64_t)out.size() > out_cap) return -(int64_t)out.size();
  std::memcpy(out_ids, out.data(), out.size() * sizeof(int32_t));
  return (int64_t)out.size();
}

// Whole-text encode (lossless whitespace chunking, native, threaded for
// large inputs; nthreads <= 0 = auto).  Returns count written or
// -(needed).
int64_t shred_encode_text(void* encoder, const uint8_t* data, int64_t len,
                          int use_cache, int32_t* out_ids,
                          int64_t out_cap, int nthreads) {
  auto ids = static_cast<Encoder*>(encoder)->encode_text(
      data, len, use_cache != 0, nthreads);
  if ((int64_t)ids.size() > out_cap) return -(int64_t)ids.size();
  std::memcpy(out_ids, ids.data(), ids.size() * sizeof(int32_t));
  return (int64_t)ids.size();
}

void shred_encoder_free(void* encoder) {
  delete static_cast<Encoder*>(encoder);
}

}  // extern "C"
