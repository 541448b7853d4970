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
// ti_* is the ingest form of the analyzer: a table of term ids (term → id,
// ids dense from 0 in the order terms were first seen) and one call that
// analyses a batch of texts into the flat ids of their terms, so a batch
// crosses into Python as integers and only the terms new to the table come
// back as text.
//
// Build: g++ -O3 -shared -fPIC text_analyzer.cc -o libtext_analyzer.so

#include <cstdint>
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

// Character classes of basic tokenize: control characters but \t \n \r
// are dropped; whitespace and punctuation end a token (a punctuation token
// is one character, never a term); letters are lowercased; anything else
// (DEL, bytes >= 128) stays in the token and keeps it from being a term.
enum : unsigned char { kDrop, kSplit, kDigit, kAlpha, kOther };

struct CharClass {
  unsigned char cls[256];
  char lower[256];
  CharClass() {
    for (int c = 0; c < 256; ++c) {
      char ch = static_cast<char>(c);
      lower[c] = ch;
      if (c < 32 && c != '\t' && c != '\n' && c != '\r') {
        cls[c] = kDrop;
      } else if (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                 is_punct(ch)) {
        cls[c] = kSplit;
      } else if (c >= '0' && c <= '9') {
        cls[c] = kDigit;
      } else if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z')) {
        cls[c] = kAlpha;
        if (c <= 'Z') lower[c] = static_cast<char>(c - 'A' + 'a');
      } else {
        cls[c] = kOther;
      }
    }
  }
};

const CharClass& char_class() {
  static const CharClass k;
  return k;
}

// the n <= 8 bytes at p as one little-endian integer
inline uint64_t pack(const char* p, size_t n) {
  uint64_t w = 0;
  for (size_t i = 0; i < n; ++i)
    w |= static_cast<uint64_t>(static_cast<unsigned char>(p[i])) << (8 * i);
  return w;
}

// stopwords() of two to five letters, packed into integers by length
struct StopTable {
  std::vector<uint64_t> by_len[6];
  StopTable() {
    for (const auto& w : stopwords())
      if (w.size() < 6) by_len[w.size()].push_back(pack(w.data(), w.size()));
  }
};

inline bool is_stopword(const char* p, size_t n) {
  static const StopTable t;
  if (n > 5) return false;
  uint64_t w = pack(p, n);
  for (uint64_t s : t.by_len[n])
    if (s == w) return true;
  return false;
}

// The BM25 terms of the text [p, end), in order, to emit(data, size):
// basic tokenize; drop one-character tokens, digits only, anything not
// alphanumeric and stopwords; Porter when stem != 0.
template <class Emit>
void for_each_term(const char* p, const char* end, int stem, Emit&& emit) {
  const CharClass& cc = char_class();
  std::string cur;
  bool digits = true, alnum = true;
  auto flush = [&]() {
    size_t n = cur.size();
    if (n > 1 && !digits && alnum && !is_stopword(cur.data(), n)) {
      if (stem) {
        std::string term = porter_stem(cur);
        emit(term.data(), term.size());
      } else {
        emit(cur.data(), n);
      }
    }
    cur.clear();
    digits = alnum = true;
  };
  for (; p < end; ++p) {
    unsigned char c = static_cast<unsigned char>(*p);
    switch (cc.cls[c]) {
      case kDrop:
        break;
      case kSplit:
        if (!cur.empty()) flush();
        break;
      case kDigit:
        cur.push_back(static_cast<char>(c));
        break;
      case kAlpha:
        cur.push_back(cc.lower[c]);
        digits = false;
        break;
      default:
        cur.push_back(static_cast<char>(c));
        digits = alnum = false;
    }
  }
  if (!cur.empty()) flush();
}

// Term → id, ids dense from 0 in the order terms were added: open
// addressing over slots that hold a term's first 8 bytes, its length and
// its id, so most lookups read one slot; the terms' bytes in one arena.
class TermTable {
 public:
  size_t size() const { return starts_.size() - 1; }

  // The term's id; a new term takes the next id and sets *added.
  int intern(const char* p, size_t n, bool* added) {
    if (2 * (size() + 1) > slots_.size()) grow();
    uint64_t head = pack(p, n < 8 ? n : 8);
    size_t mask = slots_.size() - 1;
    for (size_t i = hash(head, p, n) & mask;; i = (i + 1) & mask) {
      Slot& s = slots_[i];
      if (s.id1 == 0) {
        s = Slot{head, static_cast<uint32_t>(n),
                 static_cast<uint32_t>(size() + 1)};
        arena_.append(p, n);
        starts_.push_back(arena_.size());
        *added = true;
        return static_cast<int>(s.id1 - 1);
      }
      if (s.head == head && s.len == n &&
          (n <= 8 || std::memcmp(arena_.data() + starts_[s.id1 - 1] + 8,
                                 p + 8, n - 8) == 0)) {
        *added = false;
        return static_cast<int>(s.id1 - 1);
      }
    }
  }

 private:
  struct Slot {
    uint64_t head;  // the first 8 bytes, packed
    uint32_t len;
    uint32_t id1;   // id + 1; 0: empty
  };

  static uint64_t hash(uint64_t head, const char* p, size_t n) {
    const uint64_t k = 0x9FB21C651E98DF25ull;
    uint64_t h = (head ^ (n * 0x9E3779B97F4A7C15ull)) * k;
    for (size_t i = 8; i < n; i += 8) {
      h ^= h >> 29;
      h = (h ^ pack(p + i, n - i < 8 ? n - i : 8)) * k;
    }
    h ^= h >> 32;
    h *= k;
    return h ^ (h >> 29);
  }

  void grow() {
    std::vector<Slot> slots(slots_.empty() ? 1024 : 2 * slots_.size(),
                            Slot{0, 0, 0});
    size_t mask = slots.size() - 1;
    for (const Slot& s : slots_) {
      if (s.id1 == 0) continue;
      const char* p = arena_.data() + starts_[s.id1 - 1];
      size_t i = hash(s.head, p, s.len) & mask;
      while (slots[i].id1) i = (i + 1) & mask;
      slots[i] = s;
    }
    slots_.swap(slots);
  }

  std::vector<Slot> slots_;
  std::vector<size_t> starts_{0};  // by id: where its bytes start in arena_
  std::string arena_;
};

struct WordPiece {
  std::unordered_map<std::string, int> vocab;
  int max_chars_per_word = 200;
};

struct TermIds {
  TermTable ids;
  std::vector<int> out;   // ids of the last ti_analyze, until ti_take
  std::string fresh;      // its terms new to the table, '\x01'-joined
};

}  // namespace

extern "C" {

// BM25 analyze: '\x01'-joined terms written to out; returns bytes written
// (excluding NUL) or -1 if out too small.  stem != 0 applies Porter.
int ta_analyze(const char* text, int stem, char* out, int cap) {
  std::string result;
  for_each_term(text, text + std::strlen(text), stem,
                [&](const char* term, size_t n) {
                  if (!result.empty()) result += '\x01';
                  result.append(term, n);
                });
  if (static_cast<int>(result.size()) + 1 > cap) return -1;
  std::memcpy(out, result.c_str(), result.size() + 1);
  return static_cast<int>(result.size());
}

void* ti_create() { return new TermIds(); }

void ti_free(void* h) { delete static_cast<TermIds*>(h); }

// Append n terms (lens[i] bytes each, packed in blob) with the next ids;
// returns the table's new size, or -1 (table unchanged past the terms
// before it) when a term is already there.
int ti_push(void* h, const char* blob, const int* lens, int n) {
  auto* t = static_cast<TermIds*>(h);
  bool added;
  for (int i = 0; i < n; ++i) {
    t->ids.intern(blob, lens[i], &added);
    if (!added) return -1;
    blob += lens[i];
  }
  return static_cast<int>(t->ids.size());
}

// Analyse n NUL-separated ASCII texts in [texts, texts + len): counts[i]
// gets the number of terms of text i, and each term an id (new terms the
// next ids, in the order they occur).  Returns the number of ids and sets
// *fresh_len to the bytes of the new terms, '\x01'-joined; ti_take copies
// both out.
long long ti_analyze(void* h, const char* texts, long long len, int n,
                     int stem, int* counts, long long* fresh_len) {
  auto* t = static_cast<TermIds*>(h);
  t->out.clear();
  t->fresh.clear();
  const char* p = texts;
  const char* end = texts + len;
  for (int i = 0; i < n; ++i) {
    const char* stop = static_cast<const char*>(std::memchr(p, 0, end - p));
    if (stop == nullptr) stop = end;
    size_t before = t->out.size();
    for_each_term(p, stop, stem, [&](const char* term, size_t len) {
      bool added;
      t->out.push_back(t->ids.intern(term, len, &added));
      if (added) {
        if (!t->fresh.empty()) t->fresh += '\x01';
        t->fresh.append(term, len);
      }
    });
    counts[i] = static_cast<int>(t->out.size() - before);
    p = stop < end ? stop + 1 : end;
  }
  *fresh_len = static_cast<long long>(t->fresh.size());
  return static_cast<long long>(t->out.size());
}

// Copy the last ti_analyze's ids and new terms out, and let them go.
void ti_take(void* h, int* ids, char* fresh) {
  auto* t = static_cast<TermIds*>(h);
  std::memcpy(ids, t->out.data(), t->out.size() * sizeof(int));
  std::memcpy(fresh, t->fresh.data(), t->fresh.size());
  std::vector<int>().swap(t->out);
  std::string().swap(t->fresh);
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
