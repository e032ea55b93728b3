// Native wordpiece tokenizer core.
//
// The port's copy of the JAX package's native/tokenizer_core.cc, built by
// tpu_pipelines_torch/ops/_build.py (g++) and bound with ctypes by
// tpu_pipelines_torch/transform/native_tokenizer.py.  The hot host-side
// loop of the BERT Transform: pretokenize (whitespace + punctuation split,
// the BERT basic-tokenizer convention) and greedy longest-match-first
// wordpiece, batch-encoding rows of text into fixed-length [CLS] ... [SEP]
// id arrays.  The Python engine (transform/graph.py `_tokenize_core`)
// remains the reference semantics; the binding routes pure-ASCII rows here
// (identical output by construction: Python's \w and str.lower() need
// unicode tables the non-ASCII rows keep using Python for).
//
// C ABI (ctypes):
//   tok_create(vocab_buf, vocab_len, lowercase) -> handle
//       vocab_buf: '\n'-joined vocab entries, id = line index.
//   tok_encode_batch(handle, data, offsets, n_rows, max_len, out)
//       data: concatenated UTF-8 row bytes; offsets: int64[n_rows + 1];
//       out: int32[n_rows * max_len], 0-padded ([PAD] = 0).
//   tok_destroy(handle)
//
// Analysis-pass counter (the vocab-BUILD side of the same pretokenizer —
// the full-corpus stage the reference ran Beam-parallel, SURVEY.md §2b):
//   tok_counter_create(lowercase) -> handle
//   tok_counter_add(handle, data, offsets, n_rows)
//       accumulates pretoken counts across calls (chunked corpora).
//   tok_counter_serialize(handle, out, cap) -> needed_bytes
//       "token\tcount\n" lines; call with cap=0 to size, then again with a
//       buffer of that size.  Deterministic output not required — the
//       Python side merges into its own dict.
//   tok_counter_destroy(handle)

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <thread>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> table;
  bool has_wordpiece = false;
  bool lowercase = true;
  int32_t unk = 1, cls = 2, sep = 3;

  int32_t lookup_or(const std::string &key, int32_t fallback) const {
    auto it = table.find(key);
    return it == table.end() ? fallback : it->second;
  }
};

struct TokenCounter {
  std::unordered_map<std::string, int64_t> counts;
  bool lowercase = true;
};

inline bool is_word_char(unsigned char c) {
  // ASCII subset of Python's \w: [A-Za-z0-9_].  Non-ASCII rows never reach
  // this code (the binding routes them to the Python engine).
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_';
}

inline bool is_space_char(unsigned char c) {
  // Python's \s over the ASCII range: space, \t-\r (0x09-0x0D), AND the
  // file/group/record/unit separators 0x1C-0x1F (re's unicode whitespace).
  return c == ' ' || (c >= 0x09 && c <= 0x0D) || (c >= 0x1C && c <= 0x1F);
}

// Greedy longest-match-first wordpiece; whole-token hit short-circuits.
// Appends ids; a token with any unmatchable tail contributes a single [UNK].
void wordpiece(const Tokenizer &t, std::string_view tok,
               std::vector<int32_t> &ids, std::string &scratch) {
  scratch.assign(tok);
  auto whole = t.table.find(scratch);
  if (whole != t.table.end()) {
    ids.push_back(whole->second);
    return;
  }
  size_t start = 0;
  size_t before = ids.size();
  while (start < tok.size()) {
    size_t end = tok.size();
    int32_t piece = -1;
    while (start < end) {
      if (start == 0) {
        scratch.assign(tok.substr(start, end - start));
      } else {
        scratch.assign("##");
        scratch.append(tok.substr(start, end - start));
      }
      auto it = t.table.find(scratch);
      if (it != t.table.end()) {
        piece = it->second;
        break;
      }
      --end;
    }
    if (piece < 0) {
      ids.resize(before);
      ids.push_back(t.unk);
      return;
    }
    ids.push_back(piece);
    start = end;
  }
}

}  // namespace

extern "C" {

void *tok_create(const char *vocab_buf, int64_t vocab_len, int lowercase) {
  auto *t = new Tokenizer();
  t->lowercase = lowercase != 0;
  std::string_view buf(vocab_buf, static_cast<size_t>(vocab_len));
  int32_t id = 0;
  size_t pos = 0;
  while (pos <= buf.size()) {
    size_t nl = buf.find('\n', pos);
    size_t end = (nl == std::string_view::npos) ? buf.size() : nl;
    if (end > pos || nl != std::string_view::npos) {
      std::string entry(buf.substr(pos, end - pos));
      if (!entry.empty()) {
        if (entry.compare(0, 2, "##") == 0) t->has_wordpiece = true;
        t->table[std::move(entry)] = id;  // duplicate entry: last id wins,
                                          // matching Python's dict build
      }
      ++id;
    }
    if (nl == std::string_view::npos) break;
    pos = nl + 1;
  }
  t->unk = t->lookup_or("[UNK]", 1);
  t->cls = t->lookup_or("[CLS]", 2);
  t->sep = t->lookup_or("[SEP]", 3);
  return t;
}

void tok_destroy(void *h) { delete static_cast<Tokenizer *>(h); }

int tok_has_wordpiece(void *h) {
  return static_cast<Tokenizer *>(h)->has_wordpiece ? 1 : 0;
}

namespace {

// Encode one ALREADY-LOWERCASED row into out[0..max_len): pretokenize (runs
// of word chars, single punctuation chars otherwise — the ASCII projection
// of  \w+|[^\w\s] , same split, same order), then vocab/wordpiece lookup.
void encode_prepared_row(const Tokenizer &t, const char *row, size_t len,
                         int32_t max_len, int32_t *dst,
                         std::vector<int32_t> &ids, std::string &scratch) {
  const size_t budget = static_cast<size_t>(max_len) - 1;  // room for [SEP]
  ids.clear();
  ids.push_back(t.cls);
  size_t i = 0;
  while (i < len && ids.size() < budget) {
    unsigned char c = static_cast<unsigned char>(row[i]);
    if (is_space_char(c)) {
      ++i;
      continue;
    }
    size_t start = i;
    if (is_word_char(c)) {
      while (i < len && is_word_char(static_cast<unsigned char>(row[i])))
        ++i;
    } else {
      ++i;  // single punctuation character token
    }
    std::string_view tok(row + start, i - start);
    if (t.has_wordpiece) {
      wordpiece(t, tok, ids, scratch);
    } else {
      scratch.assign(tok);
      ids.push_back(t.lookup_or(scratch, t.unk));
    }
  }
  if (ids.size() > budget) ids.resize(budget);
  ids.push_back(t.sep);
  std::memset(dst, 0, sizeof(int32_t) * static_cast<size_t>(max_len));
  std::memcpy(dst, ids.data(), sizeof(int32_t) * ids.size());
}

}  // namespace

void tok_encode_batch(void *h, const char *data, const int64_t *offsets,
                      int64_t n_rows, int32_t max_len, int32_t *out) {
  const Tokenizer &t = *static_cast<Tokenizer *>(h);
  std::vector<int32_t> ids;
  std::string lowered;
  std::string scratch;
  for (int64_t r = 0; r < n_rows; ++r) {
    const char *row = data + offsets[r];
    size_t len = static_cast<size_t>(offsets[r + 1] - offsets[r]);
    if (t.lowercase) {
      lowered.assign(row, len);
      for (char &c : lowered)
        if (c >= 'A' && c <= 'Z') c += 'a' - 'A';
      row = lowered.data();
    }
    encode_prepared_row(t, row, len, max_len, out + r * max_len, ids,
                        scratch);
  }
}


// ------------------------------------------------------------ count kernel

void *tok_counter_create(int lowercase) {
  auto *c = new TokenCounter();
  c->lowercase = lowercase != 0;
  return c;
}

void tok_counter_destroy(void *h) { delete static_cast<TokenCounter *>(h); }

namespace {

// Same ASCII projection of  \w+|[^\w\s]  as tok_encode_batch.  The row must
// already be lowercased if the counter wants that (see count_row).
inline void count_row_raw(TokenCounter &c, const char *row, size_t len,
                          std::string &scratch) {
  size_t i = 0;
  while (i < len) {
    unsigned char ch = static_cast<unsigned char>(row[i]);
    if (is_space_char(ch)) {
      ++i;
      continue;
    }
    size_t start = i;
    if (is_word_char(ch)) {
      while (i < len && is_word_char(static_cast<unsigned char>(row[i])))
        ++i;
    } else {
      ++i;
    }
    scratch.assign(row + start, i - start);
    ++c.counts[scratch];
  }
}

inline void count_row(TokenCounter &c, const char *row, size_t len,
                      std::string &lowered, std::string &scratch) {
  if (c.lowercase) {
    lowered.assign(row, len);
    for (char &ch : lowered)
      if (ch >= 'A' && ch <= 'Z') ch += 'a' - 'A';
    row = lowered.data();
  }
  count_row_raw(c, row, len, scratch);
}

}  // namespace

void tok_counter_add(void *h, const char *data, const int64_t *offsets,
                     int64_t n_rows) {
  TokenCounter &c = *static_cast<TokenCounter *>(h);
  std::string lowered;
  std::string scratch;
  for (int64_t r = 0; r < n_rows; ++r) {
    count_row(c, data + offsets[r],
              static_cast<size_t>(offsets[r + 1] - offsets[r]), lowered,
              scratch);
  }
}

// Fixed-width UCS4 rows straight out of a numpy 'U<width>' array (the
// caller has verified every code point is < 128 with one vectorized max):
// no encode pass, no per-row Python objects — the unicode buffer itself
// crosses the FFI.  Trailing NULs are padding (numpy's U dtype cannot
// represent them anyway); embedded NULs are real characters and count as
// punctuation, matching Python's [^\w\s].
namespace {

void count_ucs4_range(TokenCounter &c, const uint32_t *data, int64_t begin,
                      int64_t end, size_t w) {
  std::string scratch;
  std::string ascii_row;
  const bool lower = c.lowercase;
  for (int64_t r = begin; r < end; ++r) {
    const uint32_t *row = data + r * w;
    size_t len = w;
    while (len > 0 && row[len - 1] == 0) --len;
    ascii_row.resize(len);
    // Narrow UCS4 -> char and lowercase in the same pass, so count_row_raw
    // needs no second copy.
    if (lower) {
      for (size_t i = 0; i < len; ++i) {
        uint32_t ch = row[i];
        ascii_row[i] = static_cast<char>(
            ch >= 'A' && ch <= 'Z' ? ch + ('a' - 'A') : ch);
      }
    } else {
      for (size_t i = 0; i < len; ++i)
        ascii_row[i] = static_cast<char>(row[i]);
    }
    count_row_raw(c, ascii_row.data(), len, scratch);
  }
}

}  // namespace

void tok_counter_add_ucs4(void *h, const uint32_t *data, int64_t n_rows,
                          int64_t width_chars) {
  TokenCounter &c = *static_cast<TokenCounter *>(h);
  const size_t w = static_cast<size_t>(width_chars);
  // Counting is embarrassingly parallel over rows (the Beam CombinePerKey
  // shape): thread-local maps, one merge.  Small chunks stay serial — the
  // thread spawn would cost more than the work.
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = static_cast<int64_t>(hw ? (hw < 8 ? hw : 8) : 1);
  if (n_rows < 16384 || n_threads <= 1) {
    count_ucs4_range(c, data, 0, n_rows, w);
    return;
  }
  std::vector<TokenCounter> locals(static_cast<size_t>(n_threads));
  std::vector<std::thread> threads;
  const int64_t step = (n_rows + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t begin = t * step;
    int64_t end = begin + step < n_rows ? begin + step : n_rows;
    if (begin >= end) break;
    locals[static_cast<size_t>(t)].lowercase = c.lowercase;
    threads.emplace_back(count_ucs4_range,
                         std::ref(locals[static_cast<size_t>(t)]), data,
                         begin, end, w);
  }
  for (auto &th : threads) th.join();
  for (auto &local : locals)
    for (auto &kv : local.counts) c.counts[kv.first] += kv.second;
}

int64_t tok_counter_serialize(void *h, char *out, int64_t cap) {
  const TokenCounter &c = *static_cast<TokenCounter *>(h);
  int64_t needed = 0;
  for (const auto &kv : c.counts) {
    needed += static_cast<int64_t>(kv.first.size()) + 2 +
              static_cast<int64_t>(std::to_string(kv.second).size());
  }
  if (out == nullptr || cap < needed) return needed;
  char *p = out;
  for (const auto &kv : c.counts) {
    std::memcpy(p, kv.first.data(), kv.first.size());
    p += kv.first.size();
    *p++ = '\t';
    std::string n = std::to_string(kv.second);
    std::memcpy(p, n.data(), n.size());
    p += n.size();
    *p++ = '\n';
  }
  return needed;
}

}  // extern "C"
