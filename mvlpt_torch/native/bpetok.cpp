// Native CLIP BPE tokenizer core (ASCII fast path).
//
// The reference tokenizes every prompt through a pure-Python BPE
// (clip/simple_tokenizer.py:62-132): regex word split + greedy pairwise
// merges. That costs ~50 us/text in Python — ~4 s of setup for an
// ImageNet-scale zero-shot prompt table (1000 classes x 80 templates).
// This core reimplements the word splitter and merge loop in C++ for
// already-cleaned, lowercased, pure-ASCII text (every benchmark
// classname/template); tokenizer/bpe.py dispatches here when the input
// qualifies and keeps the Python path (with full Unicode handling)
// otherwise. Outputs are bit-identical to the Python encoder — asserted
// against the golden tests in tests/test_native_bpe.py.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 bpetok.cpp
// (driven by mvlpt_tpu/native/__init__.py, cached by source hash).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Bpe {
  std::unordered_map<std::string, int32_t> encoder;
  std::unordered_map<std::string, int32_t> ranks;  // "left\x01right" -> rank
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::mutex mu;
  int32_t sot = -1, eot = -1;
};

// GPT-2 byte->unicode: printable ASCII bytes map to themselves, so for
// ASCII input the mapped word IS the word. (The non-ASCII rows of the
// table only matter for the Python path.)

void split_merge_line(const std::string& line, std::string* a,
                      std::string* b) {
  size_t sp = line.find(' ');
  *a = line.substr(0, sp);
  *b = line.substr(sp + 1);
}

Bpe* build(const char* merges_txt, int64_t len) {
  // merges_txt: full text of bpe_simple_vocab_16e6.txt (gunzipped).
  // Layout mirrors tokenizer/bpe.py: line 0 is a header; the next
  // 49152-256-2 lines are merge rules.
  auto* bpe = new Bpe();
  const int kNumMerges = 49152 - 256 - 2;

  // Base vocab: the 256 byte->unicode chars in table order. For the
  // ASCII path we only need correct ids for printable ASCII, but the
  // full order determines every id, so reproduce it: bytes 33..126,
  // 161..172, 174..255 keep their (UTF-8 encoded) char; the remaining
  // 68 bytes get chars 256+i. All stored as UTF-8 strings.
  std::vector<std::string> base;
  auto push_codepoint = [&base](int cp) {
    std::string s;
    if (cp < 0x80) {
      s += static_cast<char>(cp);
    } else if (cp < 0x800) {
      s += static_cast<char>(0xC0 | (cp >> 6));
      s += static_cast<char>(0x80 | (cp & 0x3F));
    } else {
      s += static_cast<char>(0xE0 | (cp >> 12));
      s += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      s += static_cast<char>(0x80 | (cp & 0x3F));
    }
    base.push_back(s);
  };
  for (int b = 33; b <= 126; b++) push_codepoint(b);
  for (int b = 161; b <= 172; b++) push_codepoint(b);
  for (int b = 174; b <= 255; b++) push_codepoint(b);
  for (int i = 0; i < 68; i++) push_codepoint(256 + i);

  int32_t id = 0;
  for (const auto& c : base) bpe->encoder[c] = id++;
  for (const auto& c : base) bpe->encoder[c + "</w>"] = id++;

  // Parse merge lines
  const char* p = merges_txt;
  const char* end = merges_txt + len;
  // skip header line
  while (p < end && *p != '\n') p++;
  if (p < end) p++;
  int parsed = 0;
  std::string a, b;
  while (p < end && parsed < kNumMerges) {
    const char* eol = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!eol) eol = end;
    std::string line(p, eol);
    p = eol < end ? eol + 1 : end;
    if (line.empty()) continue;
    split_merge_line(line, &a, &b);
    bpe->ranks[a + '\x01' + b] = parsed;
    bpe->encoder[a + b] = id++;
    parsed++;
  }
  if (parsed != kNumMerges) {
    delete bpe;
    return nullptr;
  }
  bpe->sot = id++;
  bpe->eot = id++;
  bpe->encoder["<|startoftext|>"] = bpe->sot;
  bpe->encoder["<|endoftext|>"] = bpe->eot;
  return bpe;
}

// Greedy BPE on one ASCII word; appends ids to out. Returns false when a
// resulting symbol is missing from the vocab (cannot happen for valid
// merges; defensive).
bool apply_bpe(Bpe* bpe, const std::string& word,
               std::vector<int32_t>* out) {
  {
    std::lock_guard<std::mutex> lock(bpe->mu);
    auto it = bpe->cache.find(word);
    if (it != bpe->cache.end()) {
      out->insert(out->end(), it->second.begin(), it->second.end());
      return true;
    }
  }
  std::vector<std::string> parts;
  parts.reserve(word.size());
  for (size_t i = 0; i + 1 < word.size(); i++)
    parts.emplace_back(1, word[i]);
  parts.push_back(std::string(1, word.back()) + "</w>");

  std::string key;
  while (parts.size() > 1) {
    int best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < parts.size(); i++) {
      key.assign(parts[i]);
      key += '\x01';
      key += parts[i + 1];
      auto it = bpe->ranks.find(key);
      if (it != bpe->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    // merge every non-overlapping occurrence of the best pair,
    // scanning left to right (same as the Python loop)
    const std::string first = parts[best_i];
    const std::string second = parts[best_i + 1];
    std::vector<std::string> merged;
    merged.reserve(parts.size());
    size_t i = 0;
    while (i < parts.size()) {
      if (i + 1 < parts.size() && parts[i] == first &&
          parts[i + 1] == second) {
        merged.push_back(first + second);
        i += 2;
      } else {
        merged.push_back(parts[i]);
        i += 1;
      }
    }
    parts.swap(merged);
  }

  std::vector<int32_t> ids;
  ids.reserve(parts.size());
  for (const auto& t : parts) {
    auto it = bpe->encoder.find(t);
    if (it == bpe->encoder.end()) return false;
    ids.push_back(it->second);
  }
  out->insert(out->end(), ids.begin(), ids.end());
  std::lock_guard<std::mutex> lock(bpe->mu);
  bpe->cache.emplace(word, std::move(ids));
  return true;
}

inline bool is_lower(char c) { return c >= 'a' && c <= 'z'; }
inline bool is_digit(char c) { return c >= '0' && c <= '9'; }
inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

// The CLIP word pattern, restricted to cleaned lowercase ASCII:
//   <|startoftext|> | <|endoftext|> | 's|'t|'re|'ve|'m|'ll|'d
//   | [a-z]+ | [0-9] | [^\s a-z 0-9]+
// Alternatives tried in order at each position (regex alternation).
size_t next_token(const char* s, size_t n, size_t pos, std::string* tok) {
  static const char* kSpecials[] = {"<|startoftext|>", "<|endoftext|>"};
  for (const char* sp : kSpecials) {
    size_t l = strlen(sp);
    if (pos + l <= n && memcmp(s + pos, sp, l) == 0) {
      tok->assign(sp);
      return pos + l;
    }
  }
  if (s[pos] == '\'') {
    static const char* kContractions[] = {"'s", "'t", "'re", "'ve",
                                          "'m", "'ll", "'d"};
    // longest-listed first isn't needed: regex tries in written order
    for (const char* c : kContractions) {
      size_t l = strlen(c);
      if (pos + l <= n && memcmp(s + pos, c, l) == 0) {
        tok->assign(c);
        return pos + l;
      }
    }
  }
  if (is_lower(s[pos])) {
    size_t e = pos;
    while (e < n && is_lower(s[e])) e++;
    tok->assign(s + pos, e - pos);
    return e;
  }
  if (is_digit(s[pos])) {
    tok->assign(1, s[pos]);
    return pos + 1;
  }
  // punctuation run — [^\s\p{L}\p{N}]+ is greedy, so an apostrophe
  // mid-run stays in the run (the regex only retries alternatives at
  // the position AFTER a match, never inside one)
  size_t e = pos;
  while (e < n && !is_space(s[e]) && !is_lower(s[e]) && !is_digit(s[e]))
    e++;
  tok->assign(s + pos, e - pos);
  return e;
}

}  // namespace

extern "C" {

void* mvlpt_bpe_create(const char* merges_txt, int64_t len) {
  return build(merges_txt, len);
}

void mvlpt_bpe_destroy(void* h) { delete static_cast<Bpe*>(h); }

int32_t mvlpt_bpe_sot(void* h) { return static_cast<Bpe*>(h)->sot; }
int32_t mvlpt_bpe_eot(void* h) { return static_cast<Bpe*>(h)->eot; }

// text: cleaned (_clean_text + lower) pure-ASCII UTF-8. Returns the
// number of ids written, or -1 when out_cap is too small (caller retries
// with a bigger buffer), or -2 on non-ASCII / internal miss (caller uses
// the Python path).
int32_t mvlpt_bpe_encode(void* h, const char* text, int64_t len,
                         int32_t* out, int32_t out_cap) {
  Bpe* bpe = static_cast<Bpe*>(h);
  std::vector<int32_t> ids;
  ids.reserve(32);
  std::string tok;
  size_t pos = 0;
  size_t n = static_cast<size_t>(len);
  while (pos < n) {
    unsigned char c = static_cast<unsigned char>(text[pos]);
    if (is_space(static_cast<char>(c))) {
      pos++;
      continue;
    }
    // Python-path territory: non-ASCII, control chars (valid punct-run
    // members whose byte->unicode image is non-identity), uppercase
    // (can't occur after .lower(); defensive)
    if (c >= 0x80 || c < 0x20 || c == 0x7F || (c >= 'A' && c <= 'Z'))
      return -2;
    pos = next_token(text, n, pos, &tok);
    if (tok == "<|startoftext|>") {
      ids.push_back(bpe->sot);
    } else if (tok == "<|endoftext|>") {
      ids.push_back(bpe->eot);
    } else if (!apply_bpe(bpe, tok, &ids)) {
      return -2;
    }
  }
  if (static_cast<int32_t>(ids.size()) > out_cap) return -1;
  std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<int32_t>(ids.size());
}

}  // extern "C"
