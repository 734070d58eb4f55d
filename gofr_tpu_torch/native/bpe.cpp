// Byte-level BPE tokenizer: the port's native request-plane component, a
// copy of gofr_tpu/native/bpe.cpp kept by gofr_tpu_torch (which imports
// nothing of the JAX package).
//
// Tokenization is the per-request CPU cost of LLM serving; in C++ it does
// not wait on the Python interpreter while the card decodes.
//
// Algorithm: classic BPE with a min-heap of candidate merges over a doubly
// linked list of symbols, O(n log n) per encode, no regex pre-split. Python
// owns file formats (tokenizer.json) and hands this library flat binary
// tables; the plain C interface below is loaded with ctypes.
//
// Build (gofr_tpu_torch/native/__init__.py does it on first use):
//   g++ -O3 -shared -fPIC -std=c++17 bpe.cpp -o libgofrbpe.so

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct MergeInfo {
  int32_t rank;
  int32_t merged_id;
};

static inline uint64_t pair_key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

struct Tokenizer {
  // token id -> byte string
  std::vector<std::string> vocab;
  // (left id, right id) -> merge rank + resulting id
  std::unordered_map<uint64_t, MergeInfo> merges;
  // raw byte -> base token id
  int32_t byte_to_id[256];
};

struct Candidate {
  int32_t rank;
  int32_t pos;      // index of left symbol at push time
  uint64_t key;     // pair identity for staleness check
  bool operator>(const Candidate& o) const {
    if (rank != o.rank) return rank > o.rank;
    return pos > o.pos;  // ties: leftmost first (BPE determinism)
  }
};

}  // namespace

extern "C" {

// vocab_blob: n_tokens x { uint32 len, bytes }. byte_map: 256 x int32.
// merges_blob: n_merges x { int32 left, int32 right, int32 merged }.
void* gofr_bpe_new(const uint8_t* vocab_blob, uint64_t vocab_blob_len,
                   uint32_t n_tokens, const int32_t* byte_map,
                   const int32_t* merges_blob, uint32_t n_merges) {
  auto* t = new Tokenizer();
  t->vocab.reserve(n_tokens);
  uint64_t off = 0;
  for (uint32_t i = 0; i < n_tokens; ++i) {
    if (off + 4 > vocab_blob_len) { delete t; return nullptr; }
    uint32_t len;
    std::memcpy(&len, vocab_blob + off, 4);
    off += 4;
    if (off + len > vocab_blob_len) { delete t; return nullptr; }
    t->vocab.emplace_back(reinterpret_cast<const char*>(vocab_blob + off), len);
    off += len;
  }
  std::memcpy(t->byte_to_id, byte_map, 256 * sizeof(int32_t));
  t->merges.reserve(n_merges * 2);
  for (uint32_t i = 0; i < n_merges; ++i) {
    int32_t l = merges_blob[i * 3], r = merges_blob[i * 3 + 1],
            m = merges_blob[i * 3 + 2];
    t->merges.emplace(pair_key(l, r),
                      MergeInfo{static_cast<int32_t>(i), m});
  }
  return t;
}

void gofr_bpe_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

// Returns number of ids written (<= max_out), or -1 on overflow.
int64_t gofr_bpe_encode(void* handle, const uint8_t* text, uint64_t text_len,
                        int32_t* out_ids, uint64_t max_out) {
  auto* t = static_cast<Tokenizer*>(handle);
  if (text_len == 0) return 0;

  // symbol arrays: id / prev / next; -1 marks a dead (merged-away) slot
  std::vector<int32_t> ids(text_len), prev(text_len), next(text_len);
  for (uint64_t i = 0; i < text_len; ++i) {
    ids[i] = t->byte_to_id[text[i]];
    prev[i] = static_cast<int32_t>(i) - 1;
    next[i] = (i + 1 < text_len) ? static_cast<int32_t>(i) + 1 : -1;
  }

  std::priority_queue<Candidate, std::vector<Candidate>, std::greater<>> heap;
  auto push_pair = [&](int32_t pos) {
    int32_t nx = next[pos];
    if (nx < 0) return;
    auto it = t->merges.find(pair_key(ids[pos], ids[nx]));
    if (it != t->merges.end())
      heap.push({it->second.rank, pos, pair_key(ids[pos], ids[nx])});
  };
  for (uint64_t i = 0; i + 1 < text_len; ++i)
    push_pair(static_cast<int32_t>(i));

  while (!heap.empty()) {
    Candidate c = heap.top();
    heap.pop();
    int32_t l = c.pos;
    if (ids[l] < 0) continue;                       // left symbol merged away
    int32_t r = next[l];
    if (r < 0 || pair_key(ids[l], ids[r]) != c.key) continue;  // stale entry
    auto it = t->merges.find(c.key);
    if (it == t->merges.end() || it->second.rank != c.rank) continue;

    ids[l] = it->second.merged_id;                  // merge r into l
    ids[r] = -1;
    next[l] = next[r];
    if (next[r] >= 0) prev[next[r]] = l;
    if (prev[l] >= 0) push_pair(prev[l]);
    push_pair(l);
  }

  uint64_t n = 0;
  for (int32_t i = 0; i >= 0; i = next[i]) {
    if (n >= max_out) return -1;
    out_ids[n++] = ids[i];
  }
  return static_cast<int64_t>(n);
}

// Returns bytes written (<= max_out), or -1 on overflow / unknown id.
int64_t gofr_bpe_decode(void* handle, const int32_t* token_ids, uint64_t n_ids,
                        uint8_t* out, uint64_t max_out) {
  auto* t = static_cast<Tokenizer*>(handle);
  uint64_t n = 0;
  for (uint64_t i = 0; i < n_ids; ++i) {
    int32_t id = token_ids[i];
    if (id < 0 || static_cast<size_t>(id) >= t->vocab.size()) return -1;
    const std::string& s = t->vocab[id];
    if (n + s.size() > max_out) return -1;
    std::memcpy(out + n, s.data(), s.size());
    n += s.size();
  }
  return static_cast<int64_t>(n);
}

uint32_t gofr_bpe_vocab_size(void* handle) {
  return static_cast<uint32_t>(static_cast<Tokenizer*>(handle)->vocab.size());
}

}  // extern "C"
