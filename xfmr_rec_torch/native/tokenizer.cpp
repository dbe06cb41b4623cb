// Native batch tokenizers: the hashing trick and the corpus vocab.
//
// Byte for byte the pure-Python tokenizers of models/tokenizer.py, on
// every input: tokens match [a-z0-9]+(?:'[a-z]+)? over the UTF-8 bytes,
// each is hashed whole with 64-bit FNV-1a seeded per hash function, ids
// land in [NUM_RESERVED, vocab_size). Lowercasing is the caller's: the
// Python side applies str.lower() before marshalling, because Unicode
// lowercasing can map a non-ASCII letter into ASCII (KELVIN SIGN -> 'k',
// U+0130 -> 'i' + a combining dot), which a byte-wise ASCII lowercase
// here would miss. Non-ASCII bytes (>= 0x80) never match the token
// class, in either implementation.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (native/__init__.py)
// ABI: plain C, driven with ctypes.

#include <cstdint>
#include <string>
#include <unordered_map>

namespace {

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;
constexpr int32_t kClsId = 1;
constexpr int32_t kNumReserved = 2;

constexpr uint64_t kHashSeeds[8] = {
    0x9E3779B97F4A7C15ULL, 0xC2B2AE3D27D4EB4FULL, 0x165667B19E3779F9ULL,
    0x27D4EB2F165667C5ULL, 0x85EBCA77C2B2AE63ULL, 0x2545F4914F6CDD1DULL,
    0xFF51AFD7ED558CCDULL, 0xC4CEB9FE1A85EC53ULL,
};

inline uint64_t fnv1a(const char* data, int64_t len, uint64_t seed) {
  uint64_t h = kFnvOffset ^ seed;
  for (int64_t i = 0; i < len; ++i) {
    h = (h ^ static_cast<unsigned char>(data[i])) * kFnvPrime;
  }
  return h;
}

inline bool is_lower_alnum(char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
}

inline bool is_lower_alpha(char c) { return c >= 'a' && c <= 'z'; }

// Calls emit(start, len) for each token of src[0, len), in order, until
// it returns false. A token is a contiguous span of the text, so it is
// hashed in place, whatever its length.
template <typename Emit>
void for_each_token(const char* src, int64_t len, Emit&& emit) {
  int64_t i = 0;
  while (i < len) {
    if (!is_lower_alnum(src[i])) {
      ++i;
      continue;
    }
    const int64_t start = i;
    while (i < len && is_lower_alnum(src[i])) ++i;
    if (i + 1 < len && src[i] == '\'' && is_lower_alpha(src[i + 1])) {
      ++i;
      while (i < len && is_lower_alpha(src[i])) ++i;
    }
    if (!emit(src + start, i - start)) return;
  }
}

struct VocabHandle {
  std::unordered_map<std::string, int32_t> ids;
};

}  // namespace

extern "C" {

int32_t tokenizer_abi_version() { return 3; }

// texts: concatenated UTF-8 bytes, already lowercased by the caller when
// the config asks for it; offsets: n + 1 boundaries into texts.
// out: (n, max_length, num_hashes) int32, caller-allocated and zeroed.
void encode_batch(const char* texts, const int64_t* offsets, int64_t n,
                  int32_t max_length, int32_t num_hashes, int32_t vocab_size,
                  int32_t add_cls, int32_t* out) {
  const uint64_t space = static_cast<uint64_t>(vocab_size - kNumReserved);
  for (int64_t row = 0; row < n; ++row) {
    int32_t* out_row = out + row * max_length * num_hashes;
    int32_t pos = 0;
    if (add_cls && max_length > 0) {
      for (int32_t h = 0; h < num_hashes; ++h) out_row[h] = kClsId;
      pos = 1;
    }
    for_each_token(
        texts + offsets[row], offsets[row + 1] - offsets[row],
        [&](const char* tok, int64_t tlen) {
          if (pos >= max_length) return false;
          int32_t* slot = out_row + pos * num_hashes;
          for (int32_t h = 0; h < num_hashes; ++h) {
            slot[h] = kNumReserved +
                      static_cast<int32_t>(fnv1a(tok, tlen, kHashSeeds[h]) %
                                           space);
          }
          ++pos;
          return true;
        });
  }
}

// The vocab path: `vocab_create` builds the token -> id map once (rank
// order = id order), `vocab_encode_batch` streams texts through it; an
// out-of-vocab token hashes (seed 0) into the trailing `oov_buckets` ids.
// tokens: concatenated UTF-8 bytes; offsets: n + 1 boundaries. The
// returned handle is freed with vocab_destroy.
void* vocab_create(const char* tokens, const int64_t* offsets, int64_t n) {
  auto* handle = new VocabHandle();
  handle->ids.reserve(static_cast<size_t>(n) * 2);
  for (int64_t i = 0; i < n; ++i) {
    handle->ids.emplace(
        std::string(tokens + offsets[i],
                    static_cast<size_t>(offsets[i + 1] - offsets[i])),
        kNumReserved + static_cast<int32_t>(i));
  }
  return handle;
}

void vocab_destroy(void* handle) {
  delete static_cast<VocabHandle*>(handle);
}

// out: (n, max_length) int32, caller-allocated and zeroed.
void vocab_encode_batch(const void* handle, const char* texts,
                        const int64_t* offsets, int64_t n,
                        int32_t max_length, int32_t oov_start,
                        int32_t oov_buckets, int32_t add_cls, int32_t* out) {
  const auto& ids = static_cast<const VocabHandle*>(handle)->ids;
  std::string key;
  for (int64_t row = 0; row < n; ++row) {
    int32_t* out_row = out + row * max_length;
    int32_t pos = 0;
    if (add_cls && max_length > 0) {
      out_row[0] = kClsId;
      pos = 1;
    }
    for_each_token(
        texts + offsets[row], offsets[row + 1] - offsets[row],
        [&](const char* tok, int64_t tlen) {
          if (pos >= max_length) return false;
          key.assign(tok, static_cast<size_t>(tlen));
          auto it = ids.find(key);
          out_row[pos++] =
              it != ids.end()
                  ? it->second
                  : oov_start + static_cast<int32_t>(
                                    fnv1a(tok, tlen, kHashSeeds[0]) %
                                    static_cast<uint64_t>(oov_buckets));
          return true;
        });
  }
}

}  // extern "C"
