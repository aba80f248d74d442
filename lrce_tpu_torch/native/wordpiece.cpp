// C++ WordPiece tokenizer — fast path for the host input pipeline.
//
// Implements BERT-uncased basic tokenization (lowercase, punctuation split)
// + greedy longest-match WordPiece for ASCII text, matching the Python
// reference implementation (lrce_tpu_torch/data/tokenizer.py) byte-for-byte on
// ASCII inputs. Non-ASCII inputs return -1 so the caller falls back to the
// Python path (full Unicode handling) — parity is never silently broken.
//
// Replaces the role of HuggingFace's Rust `tokenizers` in the reference
// stack (reference lrce/dataset/e2e_dataset.py:32); the native layer is C++
// so that it builds with g++ alone.
//
// C ABI (ctypes):
//   void* wp_load(const char* vocab_path);
//   void  wp_free(void* handle);
//   int   wp_encode(void* handle, const char* text, const char* pair,
//                   int max_length, int truncation, int capacity,
//                   long* out_ids, long* out_mask, long* out_types);
//     returns sequence length (== max_length when padded), or -1 on
//     non-ASCII input / error (caller must fall back). The out_* buffers
//     hold `capacity` entries; a longer result writes nothing and returns
//     its length, for the caller to call again with larger buffers.

#include <algorithm>
#include <cctype>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, long> table;
  long pad_id = -1, unk_id = -1, cls_id = -1, sep_id = -1;
  size_t max_token_chars = 0;
};

bool is_ascii(const char* s) {
  for (const unsigned char* p = (const unsigned char*)s; *p; ++p)
    if (*p >= 0x80) return false;
  return true;
}

bool is_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// ASCII basic tokenize: clean/lower, split whitespace, split punctuation.
std::vector<std::string> basic_tokenize(const char* text) {
  std::vector<std::string> out;
  std::string cur;
  auto flush = [&]() {
    if (!cur.empty()) {
      out.push_back(cur);
      cur.clear();
    }
  };
  for (const unsigned char* p = (const unsigned char*)text; *p; ++p) {
    unsigned char c = *p;
    if (c == 0) continue;
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == 0x0b ||
        c == 0x0c) {
      flush();
    } else if (c < 0x20 || c == 0x7f) {
      continue;  // control chars dropped
    } else if (is_punct(c)) {
      flush();
      out.push_back(std::string(1, (char)c));
    } else {
      cur.push_back((char)std::tolower(c));
    }
  }
  flush();
  return out;
}

// Greedy longest-match WordPiece over one word.
void wordpiece(const Vocab& v, const std::string& word,
               std::vector<long>& out) {
  if (word.size() > 100) {
    out.push_back(v.unk_id);
    return;
  }
  std::vector<long> pieces;
  size_t start = 0;
  while (start < word.size()) {
    size_t end = word.size();
    long cur = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = v.table.find(sub);
      if (it != v.table.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out.push_back(v.unk_id);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  out.insert(out.end(), pieces.begin(), pieces.end());
}

void tokenize_ids(const Vocab& v, const char* text, std::vector<long>& out) {
  for (const auto& w : basic_tokenize(text)) wordpiece(v, w, out);
}

}  // namespace

extern "C" {

void* wp_load(const char* vocab_path) {
  std::ifstream f(vocab_path);
  if (!f.is_open()) return nullptr;
  auto* v = new Vocab();
  std::string line;
  long idx = 0;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    v->table[line] = idx;
    v->max_token_chars = std::max(v->max_token_chars, line.size());
    if (line == "[PAD]") v->pad_id = idx;
    else if (line == "[UNK]") v->unk_id = idx;
    else if (line == "[CLS]") v->cls_id = idx;
    else if (line == "[SEP]") v->sep_id = idx;
    ++idx;
  }
  if (v->unk_id < 0 || v->cls_id < 0 || v->sep_id < 0 || v->pad_id < 0) {
    delete v;
    return nullptr;
  }
  return v;
}

void wp_free(void* handle) { delete (Vocab*)handle; }

int wp_encode(void* handle, const char* text, const char* pair,
              int max_length, int truncation, int capacity, long* out_ids,
              long* out_mask, long* out_types) {
  if (!handle || !text) return -1;
  if (!is_ascii(text) || (pair && !is_ascii(pair))) return -1;
  const Vocab& v = *(const Vocab*)handle;

  std::vector<long> ids, types;
  ids.push_back(v.cls_id);
  tokenize_ids(v, text, ids);
  ids.push_back(v.sep_id);
  types.assign(ids.size(), 0);
  if (pair) {
    std::vector<long> b;
    tokenize_ids(v, pair, b);
    for (long t : b) {
      ids.push_back(t);
      types.push_back(1);
    }
    ids.push_back(v.sep_id);
    types.push_back(1);
  }

  if (truncation && max_length > 0 && (int)ids.size() > max_length) {
    ids.resize(max_length - 1);
    ids.push_back(v.sep_id);
    types.resize(max_length);
  }

  int n = (int)ids.size();
  int total = max_length > 0 ? std::max(n, max_length) : n;
  // the buffers hold `capacity` entries: write nothing past them, and tell
  // the caller how many it needs
  if (total > capacity) return total;
  for (int i = 0; i < total; ++i) {
    if (i < n) {
      out_ids[i] = ids[i];
      out_mask[i] = 1;
      out_types[i] = types[i];
    } else {
      out_ids[i] = v.pad_id;
      out_mask[i] = 0;
      out_types[i] = 0;
    }
  }
  return total;
}

}  // extern "C"
