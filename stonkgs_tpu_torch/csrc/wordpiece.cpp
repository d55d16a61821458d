// BERT WordPiece tokenizer, C++ batch implementation.
//
// The port's copy of the native tokenizer that HF's Rust
// BertTokenizerFast(vocab_file=...) is replaced by on the preprocessing
// path, loaded with ctypes by stonkgs_tpu_torch/data/fast_tokenizer.py.
// Semantics match transformers' BasicTokenizer (clean text, CJK spacing,
// lowercase + NFD accent stripping via tables generated from Python's
// unicodedata) + greedy longest-match WordPiece, and encode_plus with
// padding="max_length", truncation=True.
//
// NOTE: NFC pre-normalization is skipped — combining marks (Mn) are
// stripped by the lowercase path anyway, so composed vs decomposed inputs
// tokenize identically whenever do_lower_case=1 (the default).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread -o libwordpiece.so wordpiece.cpp

#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

constexpr uint8_t kWhitespace = 1;
constexpr uint8_t kControl = 2;
constexpr uint8_t kPunct = 4;
constexpr uint8_t kChinese = 8;
constexpr uint8_t kCased = 16;
constexpr uint8_t kCaseIgnorable = 32;

inline uint8_t char_class(uint32_t cp) {
  if (cp < 0x10000) return kCharClass[cp];
  // supplementary planes: binary search the generated range table so
  // astral CJK/format/unassigned chars classify like Python unicodedata
  int lo = 0, hi = kAstralClassCount - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < kAstralClass[mid].start) hi = mid - 1;
    else if (cp > kAstralClass[mid].end) lo = mid + 1;
    else return kAstralClass[mid].mask;
  }
  return 0;
}

// UTF-8 decode one code point; advances i. Invalid bytes -> U+FFFD.
inline uint32_t decode(const std::string& s, size_t& i) {
  uint8_t b0 = (uint8_t)s[i];
  if (b0 < 0x80) { i += 1; return b0; }
  if ((b0 >> 5) == 0x6 && i + 1 < s.size()) {
    uint32_t cp = ((b0 & 0x1F) << 6) | ((uint8_t)s[i + 1] & 0x3F);
    i += 2; return cp;
  }
  if ((b0 >> 4) == 0xE && i + 2 < s.size()) {
    uint32_t cp = ((b0 & 0x0F) << 12) | (((uint8_t)s[i + 1] & 0x3F) << 6)
                  | ((uint8_t)s[i + 2] & 0x3F);
    i += 3; return cp;
  }
  if ((b0 >> 3) == 0x1E && i + 3 < s.size()) {
    uint32_t cp = ((b0 & 0x07) << 18) | (((uint8_t)s[i + 1] & 0x3F) << 12)
                  | (((uint8_t)s[i + 2] & 0x3F) << 6) | ((uint8_t)s[i + 3] & 0x3F);
    i += 4; return cp;
  }
  i += 1; return 0xFFFD;
}

inline void encode_utf8(uint32_t cp, std::string& out) {
  if (cp < 0x80) {
    out.push_back((char)cp);
  } else if (cp < 0x800) {
    out.push_back((char)(0xC0 | (cp >> 6)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back((char)(0xE0 | (cp >> 12)));
    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    out.push_back((char)(0xF0 | (cp >> 18)));
    out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  }
}

// lowercase + strip accents for one cp, appending mapped cps.
// Special case: U+03A3 GREEK CAPITAL SIGMA lowers context-dependently in
// Python str.lower() (final position -> U+03C2); handled by the caller.
constexpr uint32_t kStripSentinel = 0x110000;  // "maps to nothing"

inline void map_cps(const uint32_t* offsets, const uint32_t* data,
                    uint32_t cp, std::vector<uint32_t>& out) {
  if (cp >= 0x10000) { out.push_back(cp); return; }
  uint32_t a = offsets[cp], b = offsets[cp + 1];
  if (a == b) { out.push_back(cp); return; }  // identity encoding
  for (uint32_t k = a; k < b; ++k)
    if (data[k] != kStripSentinel) out.push_back(data[k]);
}

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  bool lower = true;
  int32_t unk_id = 0, cls_id = 0, sep_id = 0, pad_id = 0;
  int max_word_chars = 100;

  int32_t lookup(const std::string& t) const {
    auto it = vocab.find(t);
    return it == vocab.end() ? -1 : it->second;
  }

  // Basic-tokenize one text into words (as code point vectors).
  void basic_tokenize(const std::string& text,
                      std::vector<std::vector<uint32_t>>& words) const {
    // pass 1: clean + CJK spacing into a cp stream with break markers
    std::vector<uint32_t> cps;
    std::vector<uint8_t> is_break;  // whitespace positions
    size_t i = 0;
    while (i < text.size()) {
      uint32_t cp = decode(text, i);
      uint8_t cls = char_class(cp);
      if (cp == 0 || cp == 0xFFFD || (cls & kControl)) continue;
      if (cls & kWhitespace) { cps.push_back(' '); continue; }
      if (cls & kChinese) {
        cps.push_back(' '); cps.push_back(cp); cps.push_back(' ');
        continue;
      }
      cps.push_back(cp);
    }
    // pass 2: split on spaces, lowercase+strip, split on punctuation
    std::vector<uint32_t> cur;
    auto flush_word = [&](std::vector<uint32_t>& raw) {
      if (raw.empty()) return;
      std::vector<uint32_t> mapped;
      mapped.reserve(raw.size());
      if (lower) {
        for (size_t k = 0; k < raw.size(); ++k) {
          uint32_t cp = raw[k];
          if (cp == 0x3A3) {  // capital sigma: Unicode Final_Sigma context
            // preceded by cased (skipping case-ignorable) AND not followed
            // by cased (skipping case-ignorable)
            bool preceded = false;
            for (size_t m = k; m-- > 0;) {
              uint8_t c = char_class(raw[m]);
              if (c & kCaseIgnorable) continue;
              preceded = (c & kCased) != 0;
              break;
            }
            bool followed = false;
            for (size_t m = k + 1; m < raw.size(); ++m) {
              uint8_t c = char_class(raw[m]);
              if (c & kCaseIgnorable) continue;
              followed = (c & kCased) != 0;
              break;
            }
            mapped.push_back(preceded && !followed ? 0x3C2 : 0x3C3);
            continue;
          }
          map_cps(kLowerStripOffsets, kLowerStripData, cp, mapped);
        }
      } else {
        mapped = raw;
      }
      // split on punctuation
      std::vector<uint32_t> piece;
      for (uint32_t cp : mapped) {
        if (char_class(cp) & kPunct) {
          if (!piece.empty()) { words.push_back(piece); piece.clear(); }
          words.push_back({cp});
        } else {
          piece.push_back(cp);
        }
      }
      if (!piece.empty()) words.push_back(piece);
      raw.clear();
    };
    for (uint32_t cp : cps) {
      if (cp == ' ') flush_word(cur);
      else cur.push_back(cp);
    }
    flush_word(cur);
  }

  // Greedy longest-match WordPiece on one word; appends token ids.
  void wordpiece(const std::vector<uint32_t>& word,
                 std::vector<int32_t>& ids) const {
    if ((int)word.size() > max_word_chars) { ids.push_back(unk_id); return; }
    // byte offsets of each cp
    std::string bytes;
    std::vector<size_t> starts;
    for (uint32_t cp : word) { starts.push_back(bytes.size()); encode_utf8(cp, bytes); }
    starts.push_back(bytes.size());
    size_t n = word.size(), start = 0;
    std::vector<int32_t> out;
    std::string probe;
    while (start < n) {
      size_t end = n;
      int32_t found = -1;
      while (start < end) {
        probe.clear();
        if (start > 0) probe = "##";
        probe.append(bytes, starts[start], starts[end] - starts[start]);
        int32_t id = lookup(probe);
        if (id >= 0) { found = id; break; }
        --end;
      }
      if (found < 0) { ids.push_back(unk_id); return; }
      out.push_back(found);
      start = end;
    }
    ids.insert(ids.end(), out.begin(), out.end());
  }

  // Special tokens are matched literally before basic tokenization
  // (HF registers them as added tokens).
  static const std::vector<std::string>& special_tokens() {
    static const std::vector<std::string> kSpecials = {
        "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"};
    return kSpecials;
  }

  void tokenize_segment(const std::string& text,
                        std::vector<int32_t>& ids, int32_t max_length) const {
    std::vector<std::vector<uint32_t>> words;
    basic_tokenize(text, words);
    for (const auto& w : words) {
      wordpiece(w, ids);
      if ((int32_t)ids.size() >= max_length - 2) break;
    }
  }

  // NOTE: max_length must be >= 2 ([CLS] + [SEP]); smaller values write
  // what fits and pad/skip the rest (no out-of-bounds stores).
  void encode(const std::string& text, int32_t max_length,
              int32_t* out_ids, int32_t* out_mask) const {
    if (max_length <= 0) return;
    if (max_length == 1) { out_ids[0] = cls_id; out_mask[0] = 1; return; }
    std::vector<int32_t> ids;
    ids.reserve(max_length);
    // scan for literal special tokens; tokenize the spans between them
    size_t scan = 0;
    while (scan < text.size() && (int32_t)ids.size() < max_length - 2) {
      size_t best = std::string::npos;
      const std::string* best_tok = nullptr;
      for (const auto& tok : special_tokens()) {
        size_t found = text.find(tok, scan);
        if (found != std::string::npos
            && (best == std::string::npos || found < best)) {
          best = found;
          best_tok = &tok;
        }
      }
      if (best == std::string::npos) {
        tokenize_segment(text.substr(scan), ids, max_length);
        break;
      }
      if (best > scan) {
        tokenize_segment(text.substr(scan, best - scan), ids, max_length);
      }
      if ((int32_t)ids.size() < max_length - 2) {
        int32_t id = lookup(*best_tok);
        ids.push_back(id >= 0 ? id : unk_id);
      }
      scan = best + best_tok->size();
    }
    if ((int32_t)ids.size() > max_length - 2) ids.resize(max_length - 2);
    int32_t pos = 0;
    out_ids[pos] = cls_id; out_mask[pos] = 1; ++pos;
    for (int32_t id : ids) { out_ids[pos] = id; out_mask[pos] = 1; ++pos; }
    out_ids[pos] = sep_id; out_mask[pos] = 1; ++pos;
    for (; pos < max_length; ++pos) { out_ids[pos] = pad_id; out_mask[pos] = 0; }
  }
};

}  // namespace

extern "C" {

void* wp_create(const char* vocab_path, int do_lower_case) {
  auto* t = new Tokenizer();
  t->lower = do_lower_case != 0;
  std::ifstream f(vocab_path);
  if (!f) { delete t; return nullptr; }
  std::string line;
  int32_t idx = 0;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    t->vocab.emplace(line, idx++);
  }
  auto get = [&](const char* tok) {
    auto it = t->vocab.find(tok);
    return it == t->vocab.end() ? 0 : it->second;
  };
  t->unk_id = get("[UNK]");
  t->cls_id = get("[CLS]");
  t->sep_id = get("[SEP]");
  t->pad_id = get("[PAD]");
  return t;
}

void wp_free(void* h) { delete (Tokenizer*)h; }

int32_t wp_vocab_size(void* h) { return (int32_t)((Tokenizer*)h)->vocab.size(); }

int32_t wp_token_id(void* h, const char* token) {
  return ((Tokenizer*)h)->lookup(token);
}

// texts: n UTF-8 strings (lengths in text_lens); outputs (n, max_length).
void wp_encode_batch(void* h, const char** texts, const int64_t* text_lens,
                     int64_t n, int32_t max_length, int32_t n_threads,
                     int32_t* out_ids, int32_t* out_mask) {
  auto* t = (Tokenizer*)h;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = (int32_t)(n > 0 ? n : 1);
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::string s(texts[i], (size_t)text_lens[i]);
      t->encode(s, max_length, out_ids + i * max_length,
                out_mask + i * max_length);
    }
  };
  if (n_threads == 1) { work(0, n); return; }
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t k = 0; k < n_threads; ++k) {
    int64_t lo = k * chunk, hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
