// Unigram-trainer native support: normalizer, seed-vocabulary
// enumerator, and piece-lookup tables for the TPU lattice E-step.
//
// Behavior is derived from the reference's dormant normalize module
// (normalize.cpp:24-59 normalize_line; normalize.cpp:215-237
// add_subwords; normalize.cpp:171-213 insert semantics): lowercase
// ASCII, whitespace runs -> one U+2581 marker, leading run dropped and
// trailing marker stripped per line; substrings are enumerated at every
// byte position that does not START with the marker (they may still
// span markers), and only lengths 1..MAX_SUBWORD_LEN-1 are counted.
// Nothing here is copied code; see docs/CONFORMANCE.md for the
// derivation notes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr unsigned char kMarker[3] = {0xE2, 0x96, 0x81};
constexpr int kMaxSubwordLen = 16;  // reference MAX_SUBWORD_LEN (len < 16)

inline bool is_ws(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline bool is_marker(const unsigned char* p, const unsigned char* end) {
  return p + 3 <= end && p[0] == kMarker[0] && p[1] == kMarker[1] &&
         p[2] == kMarker[2];
}

// One normalized line appended to out (reference normalize_line
// semantics, unbounded output).
void normalize_one(const unsigned char* in, size_t len, std::string& out) {
  size_t start = out.size();
  bool in_space = true;  // leading whitespace dropped
  for (size_t i = 0; i < len; i++) {
    unsigned char c = in[i];
    if (is_ws(c)) {
      if (!in_space) {
        out.append(reinterpret_cast<const char*>(kMarker), 3);
        in_space = true;
      }
    } else {
      out.push_back((char)std::tolower(c));
      in_space = false;
    }
  }
  // strip one trailing marker if present
  if (out.size() - start >= 3 &&
      is_marker(reinterpret_cast<const unsigned char*>(out.data()) +
                    out.size() - 3,
                reinterpret_cast<const unsigned char*>(out.data()) +
                    out.size())) {
    out.resize(out.size() - 3);
  }
}

struct SeedVocab {
  std::unordered_map<std::string, uint64_t> counts;
  // export staging (sorted)
  std::vector<std::pair<std::string, uint64_t>> sorted;
  bool sorted_valid = false;
};

}  // namespace

extern "C" {

// Normalize a whole buffer line-by-line ('\n' separators preserved).
// Returns the number of bytes written, or -(needed) if out_cap is too
// small (call again with a bigger buffer).
int64_t shred_normalize(const uint8_t* in, int64_t len, uint8_t* out,
                        int64_t out_cap) {
  std::string acc;
  acc.reserve((size_t)len + 16);
  const unsigned char* p = in;
  const unsigned char* end = in + len;
  while (p < end) {
    const unsigned char* nl =
        (const unsigned char*)memchr(p, '\n', (size_t)(end - p));
    size_t line_len = nl ? (size_t)(nl - p) : (size_t)(end - p);
    normalize_one(p, line_len, acc);
    if (nl) acc.push_back('\n');
    p += line_len + (nl ? 1 : 0);
  }
  if ((int64_t)acc.size() > out_cap) return -(int64_t)acc.size();
  memcpy(out, acc.data(), acc.size());
  return (int64_t)acc.size();
}

void* shred_seed_vocab_create() { return new (std::nothrow) SeedVocab(); }

void shred_seed_vocab_free(void* h) { delete static_cast<SeedVocab*>(h); }

// Enumerate substrings of a NORMALIZED line into the count table
// (reference add_subwords semantics).  max_len is clamped by the
// reference's hard cap (counted lengths are 1..15).  `weight` extends
// the reference (always 1 there) so deduplicated corpora can be counted
// without re-expansion.
// skip_markers=1 reproduces the reference add_subwords behavior (no
// substring STARTS at a marker); 0 counts marker-prefixed substrings
// too, which the unigram trainer needs so word-boundary pieces
// ("\xe2\x96\x81word") can exist.
int shred_seed_vocab_add_ex(void* h, const uint8_t* line, int64_t len,
                            int64_t max_len, uint64_t weight,
                            int skip_markers) {
  auto* v = static_cast<SeedVocab*>(h);
  if (!v || !line) return -1;
  v->sorted_valid = false;
  const unsigned char* start = line;
  const unsigned char* end = line + len;
  std::string key;
  while (start < end) {
    if (skip_markers && is_marker(start, end)) {
      start += 3;
      continue;
    }
    int64_t cap = std::min<int64_t>(max_len, (int64_t)(end - start));
    for (int64_t l = 1; l <= cap; l++) {
      if (l >= kMaxSubwordLen) break;  // insert_or_increment len guard
      key.assign(reinterpret_cast<const char*>(start), (size_t)l);
      v->counts[key] += weight;
    }
    start++;
  }
  return 0;
}

int shred_seed_vocab_add(void* h, const uint8_t* line, int64_t len,
                         int64_t max_len, uint64_t weight) {
  return shred_seed_vocab_add_ex(h, line, len, max_len, weight, 1);
}

int64_t shred_seed_vocab_size(void* h) {
  return (int64_t)static_cast<SeedVocab*>(h)->counts.size();
}

// Total bytes of the top_k piece strings (for buffer sizing).
int64_t shred_seed_vocab_export_bytes(void* h, int64_t top_k) {
  auto* v = static_cast<SeedVocab*>(h);
  if (!v->sorted_valid) {
    v->sorted.assign(v->counts.begin(), v->counts.end());
    std::sort(v->sorted.begin(), v->sorted.end(),
              [](const auto& a, const auto& b) {
                if (a.second != b.second) return a.second > b.second;
                return a.first < b.first;  // deterministic tie-break
              });
    v->sorted_valid = true;
  }
  int64_t n = std::min<int64_t>(top_k, (int64_t)v->sorted.size());
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) total += (int64_t)v->sorted[i].first.size();
  return total;
}

// Export the top_k pieces by count (desc; lexicographic tie-break) as a
// concatenated byte blob + per-piece lengths + counts.  Returns the
// number of pieces written.
int64_t shred_seed_vocab_export(void* h, int64_t top_k, uint8_t* blob,
                                int32_t* lens, uint64_t* counts) {
  auto* v = static_cast<SeedVocab*>(h);
  shred_seed_vocab_export_bytes(h, top_k);  // ensure sorted
  int64_t n = std::min<int64_t>(top_k, (int64_t)v->sorted.size());
  uint8_t* bp = blob;
  for (int64_t i = 0; i < n; i++) {
    const auto& [s, c] = v->sorted[i];
    memcpy(bp, s.data(), s.size());
    bp += s.size();
    lens[i] = (int32_t)s.size();
    counts[i] = c;
  }
  return n;
}

// ---------------- piece-lookup tables for the lattice E-step ---------
//
// For every word w and position j and piece length l (1..max_piece_len),
// out_ids[(w*Lmax + j)*max_piece_len + (l-1)] = id of the piece equal to
// word[j : j+l], or -1.  Ids index the caller's piece list.  This is the
// host-side precompute feeding the TPU forward-backward DP.

int64_t shred_piece_table(const uint8_t* words_blob, const int64_t* offsets,
                          int64_t n_words, const uint8_t* pieces_blob,
                          const int32_t* piece_lens, int64_t n_pieces,
                          int64_t lmax, int64_t max_piece_len,
                          int32_t* out_ids) {
  std::unordered_map<std::string, int32_t> index;
  index.reserve((size_t)n_pieces * 2);
  {
    const uint8_t* p = pieces_blob;
    std::string key;
    for (int64_t i = 0; i < n_pieces; i++) {
      key.assign(reinterpret_cast<const char*>(p), (size_t)piece_lens[i]);
      index.emplace(std::move(key), (int32_t)i);
      p += piece_lens[i];
    }
  }
  std::string key;
  int64_t filled = 0;
  for (int64_t w = 0; w < n_words; w++) {
    const uint8_t* ws = words_blob + offsets[w];
    int64_t wl = offsets[w + 1] - offsets[w];
    for (int64_t j = 0; j < lmax; j++) {
      for (int64_t l = 1; l <= max_piece_len; l++) {
        int64_t idx = (w * lmax + j) * max_piece_len + (l - 1);
        int32_t id = -1;
        if (j < wl && j + l <= wl) {
          key.assign(reinterpret_cast<const char*>(ws + j), (size_t)l);
          auto it = index.find(key);
          if (it != index.end()) {
            id = it->second;
            filled++;
          }
        }
        out_ids[idx] = id;
      }
    }
  }
  return filled;
}

}  // extern "C"
