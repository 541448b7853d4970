// Native text analysis for the ingest hot path.
//
// The reference delegates its heavy lifting to native dependencies
// (pgvector's C operators, torch, tiktoken's Rust tokenizer — SURVEY.md
// §2.9).  This library is the framework's own native component: the
// BM25 lexical analyzer (basic tokenize → lowercase → stopword filter →
// optional Porter stem) and the WordPiece encoder, both hot per-document
// loops during ingestion on a host CPU.
//
// Contract: for pure-ASCII input these produce byte-identical output to the
// Python implementations (archi_tpu/engine/bm25.py analyze(),
// archi_tpu/models/tokenizer.py WordPieceTokenizer) — enforced by parity
// tests.  Texts containing non-ASCII bytes are routed to the Python path by
// the caller, so Unicode normalization stays in one place.
//
// Build: g++ -O3 -shared -fPIC text_analyzer.cc -o libtext_analyzer.so

#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

const std::unordered_set<std::string>& stopwords() {
  static const std::unordered_set<std::string> kStop = {
      "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
      "in", "into", "is", "it", "no", "not", "of", "on", "or", "such",
      "that", "the", "their", "then", "there", "these", "they", "this",
      "to", "was", "will", "with"};
  return kStop;
}

inline bool is_punct(char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// basic tokenize, ASCII: control chars (except \t\n\r) dropped, lowercase,
// whitespace split, punctuation split into separate tokens.
std::vector<std::string> basic_tokenize(const char* text) {
  std::vector<std::string> out;
  std::string cur;
  auto flush = [&]() {
    if (!cur.empty()) {
      out.push_back(cur);
      cur.clear();
    }
  };
  for (const char* p = text; *p; ++p) {
    unsigned char c = static_cast<unsigned char>(*p);
    if (c < 32 && c != '\t' && c != '\n' && c != '\r') continue;
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      flush();
    } else if (is_punct(static_cast<char>(c))) {
      flush();
      out.push_back(std::string(1, static_cast<char>(c)));
    } else {
      char lc = static_cast<char>(c);
      if (lc >= 'A' && lc <= 'Z') lc = static_cast<char>(lc - 'A' + 'a');
      cur.push_back(lc);
    }
  }
  flush();
  return out;
}

// ---------------------------------------------------------------- Porter
// Port of archi_tpu/utils/stemmer.py (classic Porter 1980); must match it
// exactly on ASCII words.

bool is_cons(const std::string& w, size_t i) {
  char ch = w[i];
  if (ch == 'a' || ch == 'e' || ch == 'i' || ch == 'o' || ch == 'u')
    return false;
  if (ch == 'y') return i == 0 ? true : !is_cons(w, i - 1);
  return true;
}

int measure(const std::string& stem) {
  int m = 0;
  bool prev_c = true, started = false;
  for (size_t i = 0; i < stem.size(); ++i) {
    bool c = is_cons(stem, i);
    if (!c) started = true;
    if (started && c && !prev_c) ++m;
    prev_c = c;
  }
  return m;
}

bool has_vowel(const std::string& s) {
  for (size_t i = 0; i < s.size(); ++i)
    if (!is_cons(s, i)) return true;
  return false;
}

bool ends_double_cons(const std::string& s) {
  size_t n = s.size();
  return n >= 2 && s[n - 1] == s[n - 2] && is_cons(s, n - 1);
}

bool cvc(const std::string& s) {
  size_t n = s.size();
  if (n < 3) return false;
  if (!(is_cons(s, n - 3) && !is_cons(s, n - 2) && is_cons(s, n - 1)))
    return false;
  char last = s[n - 1];
  return last != 'w' && last != 'x' && last != 'y';
}

bool ends_with(const std::string& s, const char* suf) {
  size_t l = std::strlen(suf);
  return s.size() >= l && s.compare(s.size() - l, l, suf) == 0;
}

std::string porter_stem(std::string w) {
  if (w.size() <= 2) return w;

  // Step 1a
  if (ends_with(w, "sses")) w.erase(w.size() - 2);
  else if (ends_with(w, "ies")) w.erase(w.size() - 2);
  else if (ends_with(w, "ss")) {}
  else if (ends_with(w, "s")) w.erase(w.size() - 1);

  // Step 1b
  bool flag_1b = false;
  if (ends_with(w, "eed")) {
    if (measure(w.substr(0, w.size() - 3)) > 0) w.erase(w.size() - 1);
  } else if (ends_with(w, "ed")) {
    if (has_vowel(w.substr(0, w.size() - 2))) {
      w.erase(w.size() - 2);
      flag_1b = true;
    }
  } else if (ends_with(w, "ing")) {
    if (has_vowel(w.substr(0, w.size() - 3))) {
      w.erase(w.size() - 3);
      flag_1b = true;
    }
  }
  if (flag_1b) {
    if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz")) {
      w += 'e';
    } else if (ends_double_cons(w) && !ends_with(w, "l") &&
               !ends_with(w, "s") && !ends_with(w, "z")) {
      w.erase(w.size() - 1);
    } else if (measure(w) == 1 && cvc(w)) {
      w += 'e';
    }
  }

  // Step 1c
  if (ends_with(w, "y") && has_vowel(w.substr(0, w.size() - 1)))
    w[w.size() - 1] = 'i';

  // Step 2
  static const std::pair<const char*, const char*> step2[] = {
      {"ational", "ate"}, {"tional", "tion"}, {"enci", "ence"},
      {"anci", "ance"},   {"izer", "ize"},    {"abli", "able"},
      {"alli", "al"},     {"entli", "ent"},   {"eli", "e"},
      {"ousli", "ous"},   {"ization", "ize"}, {"ation", "ate"},
      {"ator", "ate"},    {"alism", "al"},    {"iveness", "ive"},
      {"fulness", "ful"}, {"ousness", "ous"}, {"aliti", "al"},
      {"iviti", "ive"},   {"biliti", "ble"}};
  for (const auto& sr : step2) {
    if (ends_with(w, sr.first)) {
      std::string stem = w.substr(0, w.size() - std::strlen(sr.first));
      if (measure(stem) > 0) w = stem + sr.second;
      break;
    }
  }

  // Step 3
  static const std::pair<const char*, const char*> step3[] = {
      {"icate", "ic"}, {"ative", ""}, {"alize", "al"}, {"iciti", "ic"},
      {"ical", "ic"},  {"ful", ""},   {"ness", ""}};
  for (const auto& sr : step3) {
    if (ends_with(w, sr.first)) {
      std::string stem = w.substr(0, w.size() - std::strlen(sr.first));
      if (measure(stem) > 0) w = stem + sr.second;
      break;
    }
  }

  // Step 4
  static const char* step4[] = {"al",  "ance", "ence", "er",    "ic",
                                "able", "ible", "ant",  "ement", "ment",
                                "ent",  "ou",   "ism",  "ate",   "iti",
                                "ous",  "ive",  "ize"};
  bool matched4 = false;
  for (const char* suf : step4) {
    if (ends_with(w, suf)) {
      matched4 = true;
      std::string stem = w.substr(0, w.size() - std::strlen(suf));
      if (measure(stem) > 1) w = stem;
      break;
    }
  }
  if (!matched4 && ends_with(w, "ion") && w.size() > 3) {
    char before = w[w.size() - 4];
    if ((before == 's' || before == 't') &&
        measure(w.substr(0, w.size() - 3)) > 1) {
      w.erase(w.size() - 3);
    }
  }

  // Step 5a
  if (ends_with(w, "e")) {
    std::string stem = w.substr(0, w.size() - 1);
    int m = measure(stem);
    if (m > 1 || (m == 1 && !cvc(stem))) w = stem;
  }
  // Step 5b
  if (measure(w) > 1 && ends_double_cons(w) && ends_with(w, "l"))
    w.erase(w.size() - 1);

  return w;
}

bool all_alnum(const std::string& s) {
  for (char c : s)
    if (!((c >= 'a' && c <= 'z') || (c >= '0' && c <= '9'))) return false;
  return true;
}

bool all_digit(const std::string& s) {
  for (char c : s)
    if (!(c >= '0' && c <= '9')) return false;
  return true;
}

struct WordPiece {
  std::unordered_map<std::string, int> vocab;
  int max_chars_per_word = 200;
};

}  // namespace

extern "C" {

// BM25 analyze: '\x01'-joined terms written to out; returns bytes written
// (excluding NUL) or -1 if out too small.  stem != 0 applies Porter.
int ta_analyze(const char* text, int stem, char* out, int cap) {
  std::string result;
  for (auto& tok : basic_tokenize(text)) {
    if (tok.size() <= 1) continue;
    if (all_digit(tok)) continue;
    if (!all_alnum(tok)) continue;
    if (stopwords().count(tok)) continue;
    std::string term = stem ? porter_stem(tok) : tok;
    if (!result.empty()) result += '\x01';
    result += term;
  }
  if (static_cast<int>(result.size()) + 1 > cap) return -1;
  std::memcpy(out, result.c_str(), result.size() + 1);
  return static_cast<int>(result.size());
}

// vocab_lines: '\n'-separated vocabulary, id = line index.
void* wp_create(const char* vocab_lines) {
  auto* wp = new WordPiece();
  int id = 0;
  const char* p = vocab_lines;
  while (*p) {
    const char* nl = std::strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
    wp->vocab.emplace(std::string(p, len), id++);
    if (!nl) break;
    p = nl + 1;
  }
  return wp;
}

void wp_free(void* h) { delete static_cast<WordPiece*>(h); }

// Encode text -> [cls] pieces [sep], truncated to max_len; returns count or
// -1 if out too small.
int wp_encode(void* h, const char* text, int max_len, int* out_ids, int cap,
              int cls_id, int sep_id, int unk_id) {
  auto* wp = static_cast<WordPiece*>(h);
  std::vector<int> ids;
  ids.push_back(cls_id);
  for (auto& word : basic_tokenize(text)) {
    if (static_cast<int>(ids.size()) >= max_len - 1) break;
    if (static_cast<int>(word.size()) > wp->max_chars_per_word) {
      ids.push_back(unk_id);
      continue;
    }
    // greedy longest match with ## continuation
    std::vector<int> pieces;
    size_t start = 0;
    bool bad = false;
    while (start < word.size()) {
      size_t end = word.size();
      int found = -1;
      while (start < end) {
        std::string sub = word.substr(start, end - start);
        if (start > 0) sub = "##" + sub;
        auto it = wp->vocab.find(sub);
        if (it != wp->vocab.end()) {
          found = it->second;
          break;
        }
        --end;
      }
      if (found < 0) {
        bad = true;
        break;
      }
      pieces.push_back(found);
      start = end;
    }
    if (bad) {
      ids.push_back(unk_id);
    } else {
      for (int pid : pieces) ids.push_back(pid);
    }
  }
  if (static_cast<int>(ids.size()) > max_len - 1)
    ids.resize(max_len - 1);
  ids.push_back(sep_id);
  if (static_cast<int>(ids.size()) > cap) return -1;
  std::memcpy(out_ids, ids.data(), ids.size() * sizeof(int));
  return static_cast<int>(ids.size());
}

}  // extern "C"
