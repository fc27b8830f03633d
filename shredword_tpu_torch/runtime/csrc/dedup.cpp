// Span dedup for the device encoder.
//
// Natural text is heavily repetitive: after pre-tokenization most chunk
// occurrences are duplicates (zipf).  The device encoder only needs to
// encode each DISTINCT chunk once; the full id stream is then a cheap
// host-side gather.  On a bandwidth-constrained host<->device link this
// shrinks both directions of traffic by the duplication factor, and it
// shrinks device work the same way.  (The trainer applies the identical
// trick via its unique-word corpus — reference bpe.cpp:213-252.)

#include "shred_native.hpp"

#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Deduplicate n byte spans (data[off[i]] .. data[off[i]+lens[i]]).
// Writes inverse[i] = dense unique id of span i (first-occurrence
// order), uniq[j] = span index of unique j's first occurrence.
// Returns the number of unique spans.  uniq must have capacity n.
int64_t shred_dedup_spans(const uint8_t* data, const int64_t* off,
                          const int64_t* lens, int64_t n,
                          int32_t* inverse, int64_t* uniq) {
  size_t cap = 16;
  while (cap < (size_t)n * 2) cap <<= 1;
  const size_t mask = cap - 1;
  // slot -> unique id + 1 (0 = empty)
  std::vector<int32_t> table(cap, 0);
  int64_t n_uniq = 0;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* p = data + off[i];
    const int64_t len = lens[i];
    size_t slot = (size_t)(shred::fnv1a64(p, (size_t)len) & mask);
    for (;;) {
      int32_t u = table[slot];
      if (u == 0) {
        table[slot] = (int32_t)(n_uniq + 1);
        uniq[n_uniq] = i;
        inverse[i] = (int32_t)n_uniq;
        n_uniq++;
        break;
      }
      const int64_t j = uniq[u - 1];
      if (lens[j] == len && std::memcmp(data + off[j], p, len) == 0) {
        inverse[i] = u - 1;
        break;
      }
      slot = (slot + 1) & mask;
    }
  }
  return n_uniq;
}

// Fused whitespace-keep chunking + dedup: one pass over the raw text
// stream replaces the host-side numpy chunker followed by
// shred_dedup_spans (two passes + an index materialization).  Chunks
// are maximal runs of whitespace / non-whitespace bytes, ws = {' ',
// '\t', '\r', '\n'} — the byte-level mirror of the pure-Python
// whitespace_keep_split contract (which itself generalizes the
// reference's strtok delimiters, bpe.cpp:247).
//
// Writes inverse[i] = dense unique id of chunk i (first-occurrence
// order), uniq_off[j]/uniq_len[j] = unique chunk j's byte span in
// `data`, *n_chunks_out = number of chunks.  inverse must have
// capacity >= n (worst case: 1-byte chunks); uniq_off/uniq_len the
// same.  Returns the number of unique chunks.
namespace {

// branchless byte classifier: the 4-compare lambda cost ~4 ns/byte
// across the two passes on this host; a 256-entry table is one load
struct WsTable {
  uint8_t t[256] = {};
  WsTable() { t[' '] = t['\t'] = t['\r'] = t['\n'] = 1; }
};
const WsTable WS_;
#define WS WS_.t

// One [lo, hi) range of the stream deduped into its own table.
// Offsets are ABSOLUTE into `data`; ids are range-local,
// first-occurrence order.  Returns -1 on an int32-length overflow.
struct WsRange {
  std::vector<int32_t> table;   // slot -> local unique id + 1
  size_t mask = 0;
  std::vector<int64_t> uoff;
  std::vector<int32_t> ulen;
  std::vector<int32_t> inv;
  int rc = 0;
};

void ws_dedup_range(const uint8_t* data, int64_t lo, int64_t hi,
                    WsRange* r) {
  int64_t est_chunks = hi > lo ? 1 : 0;
  {
    uint8_t prev = hi > lo ? WS[data[lo]] : 0;
    for (int64_t k = lo + 1; k < hi; k++) {
      const uint8_t cur = WS[data[k]];
      est_chunks += cur != prev;
      prev = cur;
    }
  }
  size_t cap = 16;
  while (cap < (size_t)est_chunks * 2 + 16) cap <<= 1;
  r->table.assign(cap, 0);
  r->mask = cap - 1;
  r->inv.reserve((size_t)est_chunks);
  int64_t i = lo;
  while (i < hi) {
    const uint8_t ws = WS[data[i]];
    int64_t j = i + 1;
    while (j < hi && WS[data[j]] == ws) j++;
    const int64_t len = j - i;
    if (len > INT32_MAX) { r->rc = -1; return; }
    const uint8_t* p = data + i;
    size_t slot = (size_t)(shred::fnv1a64(p, (size_t)len) & r->mask);
    for (;;) {
      int32_t u = r->table[slot];
      if (u == 0) {
        r->table[slot] = (int32_t)(r->uoff.size() + 1);
        r->inv.push_back((int32_t)r->uoff.size());
        r->uoff.push_back(i);
        r->ulen.push_back((int32_t)len);
        break;
      }
      if (r->ulen[u - 1] == (int32_t)len &&
          std::memcmp(data + r->uoff[u - 1], p, (size_t)len) == 0) {
        r->inv.push_back(u - 1);
        break;
      }
      slot = (slot + 1) & r->mask;
    }
    i = j;
  }
}

}  // namespace

int64_t shred_ws_chunk_dedup(const uint8_t* data, int64_t n,
                             int32_t* inverse, int64_t* uniq_off,
                             int32_t* uniq_len, int64_t* n_chunks_out) {
  // Two-way threaded split on a chunk boundary (this host has 2
  // cores; corpus.cpp's loader uses the same pattern).  The global
  // result is BIT-IDENTICAL to the single-threaded scan: a unique
  // seen in both halves keeps its half-A id (A precedes B in the
  // stream, so A-first IS first-occurrence order), and B-only uniques
  // append in B's first-occurrence order.
  int64_t split = 0;
  if (n >= (1 << 20) && std::thread::hardware_concurrency() >= 2) {
    split = n / 2;
    // advance to the next class transition = a chunk start
    while (split < n && WS[data[split]] == WS[data[split - 1]]) split++;
  }
  WsRange a, b;
  if (split > 0 && split < n) {
    std::thread tb(ws_dedup_range, data, split, n, &b);
    ws_dedup_range(data, 0, split, &a);
    tb.join();
  } else {
    ws_dedup_range(data, 0, n, &a);
  }
  if (a.rc < 0 || b.rc < 0) return -1;

  // half A lands verbatim
  int64_t n_uniq = (int64_t)a.uoff.size();
  std::memcpy(uniq_off, a.uoff.data(), a.uoff.size() * sizeof(int64_t));
  std::memcpy(uniq_len, a.ulen.data(), a.ulen.size() * sizeof(int32_t));
  std::memcpy(inverse, a.inv.data(), a.inv.size() * sizeof(int32_t));
  int64_t n_chunks = (int64_t)a.inv.size();

  if (!b.uoff.empty()) {
    // remap half-B uniques: A-resident ones take A's id, the rest
    // append globally in B order
    std::vector<int32_t> remap(b.uoff.size());
    for (size_t u = 0; u < b.uoff.size(); u++) {
      const uint8_t* p = data + b.uoff[u];
      const int32_t len = b.ulen[u];
      int32_t gid = -1;
      size_t slot = (size_t)(shred::fnv1a64(p, (size_t)len) & a.mask);
      for (;;) {
        int32_t w = a.table[slot];
        if (w == 0) break;
        if (a.ulen[w - 1] == len &&
            std::memcmp(data + a.uoff[w - 1], p, (size_t)len) == 0) {
          gid = w - 1;
          break;
        }
        slot = (slot + 1) & a.mask;
      }
      if (gid < 0) {
        gid = (int32_t)n_uniq;
        uniq_off[n_uniq] = b.uoff[u];
        uniq_len[n_uniq] = len;
        n_uniq++;
      }
      remap[u] = gid;
    }
    for (size_t k = 0; k < b.inv.size(); k++)
      inverse[n_chunks + (int64_t)k] = remap[b.inv[k]];
    n_chunks += (int64_t)b.inv.size();
  }
  *n_chunks_out = n_chunks;
  return n_uniq;
}

// Fused marker-word splitting + dedup for the unigram encoder: one
// pass over NORMALIZED bytes (shred_normalize output, where the
// U+2581 marker E2 96 81 replaces whitespace) replaces the Python
// split-per-line/split-per-marker word loop.  Words are maximal runs
// delimited by '\n' or the exact 3-byte marker sequence; the implicit
// marker prefix every word carries is NOT part of the returned span
// (the caller prepends it when materializing the few UNIQUE words).
//
// Writes inverse[i] = dense unique id of word i (first-occurrence
// order), uniq_off[j]/uniq_len[j] = unique word j's RAW byte span,
// *n_words_out = total word count.  Buffers need capacity n/2 + 1
// (every word consumes >= 1 content byte + >= 1 delimiter byte,
// except possibly the last).  Returns the number of unique words.
int64_t shred_marker_word_dedup(const uint8_t* data, int64_t n,
                                int32_t* inverse, int64_t* uniq_off,
                                int32_t* uniq_len, int64_t* n_words_out) {
  auto is_marker = [&](int64_t k) {
    return k + 2 < n && data[k] == 0xE2 && data[k + 1] == 0x96 &&
           data[k + 2] == 0x81;
  };
  // count words for table sizing (delimiter transitions)
  int64_t est = 0;
  {
    bool in_word = false;
    for (int64_t k = 0; k < n;) {
      if (data[k] == '\n') { in_word = false; k++; }
      else if (is_marker(k)) { in_word = false; k += 3; }
      else { est += !in_word; in_word = true; k++; }
    }
  }
  size_t cap = 16;
  while (cap < (size_t)est * 2 + 16) cap <<= 1;
  std::vector<int32_t> table(cap, 0);  // slot -> unique id + 1
  const size_t mask = cap - 1;
  int64_t n_uniq = 0, n_words = 0;
  int64_t i = 0;
  while (i < n) {
    if (data[i] == '\n') { i++; continue; }
    if (is_marker(i)) { i += 3; continue; }
    int64_t j = i;
    while (j < n && data[j] != '\n' && !is_marker(j)) j++;
    const int64_t len = j - i;
    if (len > INT32_MAX) return -1;  // uniq_len is int32; refuse, don't wrap
    const uint8_t* p = data + i;
    size_t slot = (size_t)(shred::fnv1a64(p, (size_t)len) & mask);
    for (;;) {
      int32_t u = table[slot];
      if (u == 0) {
        table[slot] = (int32_t)(n_uniq + 1);
        uniq_off[n_uniq] = i;
        uniq_len[n_uniq] = (int32_t)len;
        inverse[n_words] = (int32_t)n_uniq;
        n_uniq++;
        break;
      }
      if (uniq_len[u - 1] == (int32_t)len &&
          std::memcmp(data + uniq_off[u - 1], p, (size_t)len) == 0) {
        inverse[n_words] = u - 1;
        break;
      }
      slot = (slot + 1) & mask;
    }
    n_words++;
    i = j;
  }
  *n_words_out = n_words;
  return n_uniq;
}

// Expand per-unique-chunk id runs back to the full chunk stream:
// out = concat over chunks i of ids_u[uoff[inverse[i]] ..
// uoff[inverse[i] + 1]).  The numpy repeat-gather formulation of this
// costs ~0.3 s per 2.3M output ids; here it is a memcpy loop at memory
// bandwidth.  Returns the number of ids written.
int64_t shred_expand_ids(const int32_t* ids_u, const int64_t* uoff,
                         const int32_t* inverse, int64_t n_chunks,
                         int32_t* out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n_chunks; i++) {
    const int32_t u = inverse[i];
    const int64_t o = uoff[u];
    const int64_t len = uoff[u + 1] - o;
    std::memcpy(out + pos, ids_u + o, (size_t)len * sizeof(int32_t));
    pos += len;
  }
  return pos;
}

// Byte-piece expansion (the decode hot loop): out = concat over i of
// flat[off[ids[i]] .. off[ids[i] + 1]).  ids must be pre-validated by
// the caller (the Python decode path masks unknown ids first).
// Returns the number of bytes written.
int64_t shred_expand_bytes(const uint8_t* flat, const int64_t* off,
                           const int32_t* ids, int64_t n, uint8_t* out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t o = off[ids[i]];
    const int64_t len = off[ids[i] + 1] - o;
    std::memcpy(out + pos, flat + o, (size_t)len);
    pos += len;
  }
  return pos;
}

}  // extern "C"
