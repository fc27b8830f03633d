// GPT-pattern pre-tokenizer: single-pass scanner over utf-8 bytes.
//
// Implements the reference's documented GPT split pattern
// (base.py:41-56) as a maximal-munch scanner with the pattern's
// alternation priority, instead of a backtracking regex engine:
//
//   1. '(?i:[sdmt]|ll|ve|re)
//   2. [^\r\n\p{L}\p{N}]?+\p{L}+
//   3. \p{N}{1,3}
//   4.  ?[^\s\p{L}\p{N}]++[\r\n]*
//   5. \s*[\r\n]          (whitespace up to its LAST newline)
//   6. \s+(?!\S)          (trailing whitespace / run minus one)
//   7. \s+
//
// Character classes come from Python as a codepoint->class table built
// from the `regex` module itself (ops/pretok_ops.py), so \p{L}, \p{N},
// \s and the case-insensitive contraction letters match the regex
// engine exactly (including oddities like U+017F for (?i:s)).
// Exactness is enforced by differential tests against regex.findall.

#include <cstdint>

namespace {

enum Cls : int8_t {
  K_OTHER = 0, K_SPACE = 1, K_WS = 2, K_CR = 3, K_LF = 4, K_DIGIT = 5,
  K_LETTER = 6, K_APO = 7, K_S = 8, K_D = 9, K_M = 10, K_T = 11,
  K_L = 12, K_V = 13, K_R = 14, K_E = 15, K_EOF = 16,
};

inline bool is_letter(int8_t c) {
  return c >= K_LETTER && c <= K_E && c != K_APO;
}
inline bool is_punct(int8_t c) { return c == K_OTHER || c == K_APO; }
inline bool is_ws(int8_t c) { return c >= K_SPACE && c <= K_LF; }
inline bool is_nl(int8_t c) { return c == K_CR || c == K_LF; }
// alt-2 optional prefix class: [^\r\n\p{L}\p{N}]
inline bool is_prefix(int8_t c) {
  return c == K_OTHER || c == K_APO || c == K_SPACE || c == K_WS;
}

struct Scanner {
  const uint8_t* s;
  int64_t n;
  const int8_t* table;   // codepoint -> class
  int64_t pos = 0;       // byte position

  // decode the char at byte p; returns class, sets next byte position.
  // Malformed UTF-8 (stray continuation, out-of-range lead, bad
  // continuation byte, cp >= 0x110000) classifies as K_OTHER and advances
  // past the bytes consumed so far — never indexes table[] out of range.
  inline int8_t cls_at(int64_t p, int64_t* nxt) const {
    if (p >= n) { *nxt = p; return K_EOF; }
    uint8_t b0 = s[p];
    uint32_t cp;
    int len;
    if (b0 < 0x80) { cp = b0; len = 1; }
    else if (b0 < 0xC0 || b0 > 0xF4) { *nxt = p + 1; return K_OTHER; }
    else if (b0 < 0xE0) { cp = b0 & 0x1F; len = 2; }
    else if (b0 < 0xF0) { cp = b0 & 0x0F; len = 3; }
    else { cp = b0 & 0x07; len = 4; }
    for (int i = 1; i < len; i++) {
      if (p + i >= n || (s[p + i] & 0xC0) != 0x80) {
        *nxt = p + i;
        return K_OTHER;
      }
      cp = (cp << 6) | (s[p + i] & 0x3F);
    }
    *nxt = p + len;
    if (cp >= 0x110000) return K_OTHER;
    return table[cp];
  }
};

}  // namespace

extern "C" {

// Writes chunk-start BYTE offsets to out (capacity out_cap); returns the
// number of starts, or -needed if out_cap is too small.
int64_t shred_gpt_starts(const uint8_t* data, int64_t nbytes,
                         const int8_t* cls_table, int64_t* out,
                         int64_t out_cap) {
  Scanner sc{data, nbytes, cls_table};
  int64_t count = 0;
  int64_t p = 0;
  while (p < nbytes) {
    if (count < out_cap) out[count] = p;
    count++;
    int64_t p1, p2, p3;
    int8_t c0 = sc.cls_at(p, &p1);

    // ---- alt 1: contractions
    if (c0 == K_APO) {
      int8_t c1 = sc.cls_at(p1, &p2);
      if (c1 == K_S || c1 == K_D || c1 == K_M || c1 == K_T) {
        p = p2;
        continue;
      }
      int8_t c2 = sc.cls_at(p2, &p3);
      if ((c1 == K_L && c2 == K_L) || (c1 == K_V && c2 == K_E) ||
          (c1 == K_R && c2 == K_E)) {
        p = p3;
        continue;
      }
    }
    // ---- alt 2: optional 1-char prefix + letter run
    {
      int64_t after_first;           // position after the first letter
      int8_t c;
      if (is_prefix(c0)) {           // possessive: consume if possible
        int64_t qn;
        c = sc.cls_at(p1, &qn);
        after_first = qn;
      } else {
        c = c0;
        after_first = p1;
      }
      if (is_letter(c)) {
        int64_t r = after_first, rn;
        while (is_letter(sc.cls_at(r, &rn))) r = rn;
        p = r;
        continue;
      }
    }
    // ---- alt 3: 1-3 digits
    if (c0 == K_DIGIT) {
      int64_t q = p1, qn;
      for (int k = 1; k < 3; k++) {
        int8_t c = sc.cls_at(q, &qn);
        if (c != K_DIGIT) break;
        q = qn;
      }
      p = q;
      continue;
    }
    // ---- alt 4: optional space + punct run + newlines
    {
      int64_t q = p, qn = p1;
      int8_t c = c0;
      if (c0 == K_SPACE) {
        c = sc.cls_at(p1, &qn);
        q = p1;
        if (is_punct(c)) {
          // consume space; fall through with q at first punct
        } else {
          goto ws_rules;             // space not followed by punct
        }
      }
      if (is_punct(c)) {
        int64_t r = (q == p) ? p1 : qn, rn = r;
        int8_t cc = sc.cls_at(r, &rn);
        while (is_punct(cc)) {
          r = rn;
          cc = sc.cls_at(r, &rn);
        }
        while (is_nl(cc)) {          // [\r\n]*
          r = rn;
          cc = sc.cls_at(r, &rn);
        }
        p = r;
        continue;
      }
    }
  ws_rules:
    if (is_ws(c0)) {
      // scan the whitespace run: track the end of the last newline and
      // the start of the run's final char
      int64_t cur = p, curn = p1;
      int64_t last_nl_end = -1;
      int64_t last_ws_start = p;
      int8_t c = c0;
      while (is_ws(c)) {
        if (is_nl(c)) last_nl_end = curn;
        last_ws_start = cur;
        cur = curn;
        c = sc.cls_at(cur, &curn);
      }
      if (last_nl_end > p) {
        p = last_nl_end;             // alt 5: through the LAST newline
      } else if (c == K_EOF) {
        p = cur;                     // alt 6: \s+(?!\S) at EOF
      } else if (last_ws_start > p) {
        p = last_ws_start;           // alt 6: all but the last ws char
      } else {
        p = cur;                     // alt 7: the single ws char
      }
      continue;
    }
    // unreachable: every class is consumed by some alternative above
    p = p1;
  }
  return count;
}

}  // extern "C"
