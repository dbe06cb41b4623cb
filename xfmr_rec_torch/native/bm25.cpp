// Native BM25 full-text index (build + search) over metadata text.
//
// The arithmetic of the Python oracle in index/mips.py (`BM25Index` with
// native=False), operation for operation, so both return the same rows
// and bit-identical scores: tokens are the [a-z0-9]+ runs of the text
// (lowercased by the caller with str.lower()), Okapi BM25 with k1 = 1.2
// and b = 0.75, idf = ln(1 + (N - df + 0.5) / (df + 0.5)) in double, the
// length norm tf + k1 * (1 - b + b * len / avg_len) in float, each term
// in double and added to the float score; empty documents count length
// 1. The caller computes avg_len from the lengths `bm25_create` reports,
// as the oracle does. Results are the positive-score rows ordered by
// (score desc, row asc).
//
// Documents arrive as one UTF-8 blob + (n_docs + 1) offsets; the handle
// owns the postings. Searches only read the handle, so they may run
// concurrently.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (native/__init__.py)
// ABI: plain C, driven with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kK1 = 1.2;
constexpr double kB = 0.75;

struct Posting {
  int32_t row;
  int32_t tf;
};

struct BM25Handle {
  std::unordered_map<std::string, std::vector<Posting>> postings;
  std::vector<float> doc_lens;
};

// Calls emit(token) for each [a-z0-9]+ run of text[0, len).
template <typename Emit>
void tokenize(const char* text, int64_t len, Emit&& emit) {
  std::string tok;
  for (int64_t i = 0; i < len; ++i) {
    const char c = text[i];
    if ((c >= 'a' && c <= 'z') || (c >= '0' && c <= '9')) {
      tok.push_back(c);
    } else if (!tok.empty()) {
      emit(tok);
      tok.clear();
    }
  }
  if (!tok.empty()) emit(tok);
}

}  // namespace

extern "C" {

int32_t bm25_abi_version() { return 2; }

// doc_lens: (n_docs,) float, written with each document's token count
// (1 for an empty document).
void* bm25_create(const char* blob, const int64_t* offsets, int64_t n_docs,
                  float* doc_lens) {
  auto* handle = new BM25Handle();
  handle->doc_lens.resize(static_cast<size_t>(n_docs));
  std::unordered_map<std::string, int32_t> counts;
  std::vector<std::string> order;
  for (int64_t row = 0; row < n_docs; ++row) {
    counts.clear();
    order.clear();
    int32_t n_tokens = 0;
    tokenize(blob + offsets[row], offsets[row + 1] - offsets[row],
             [&](const std::string& tok) {
               if (counts[tok]++ == 0) order.push_back(tok);
               ++n_tokens;
             });
    const float len = static_cast<float>(n_tokens ? n_tokens : 1);
    handle->doc_lens[static_cast<size_t>(row)] = len;
    doc_lens[row] = len;
    // rows arrive in order, so every posting list stays sorted by row
    for (const auto& tok : order) {
      handle->postings[tok].push_back({static_cast<int32_t>(row), counts[tok]});
    }
  }
  return handle;
}

void bm25_destroy(void* ptr) { delete static_cast<BM25Handle*>(ptr); }

// Returns the number of results written (<= top_k).
int32_t bm25_search(const void* ptr, const char* query, int64_t query_len,
                    double avg_len, int32_t top_k, int32_t* out_rows,
                    float* out_scores) {
  const auto* handle = static_cast<const BM25Handle*>(ptr);
  const int64_t n_docs = static_cast<int64_t>(handle->doc_lens.size());
  if (n_docs == 0 || top_k <= 0) return 0;
  const float k1 = static_cast<float>(kK1);
  const float b = static_cast<float>(kB);
  const float one_minus_b = static_cast<float>(1.0 - kB);
  const float avg = static_cast<float>(avg_len);
  std::vector<float> scores(static_cast<size_t>(n_docs), 0.0f);
  tokenize(query, query_len, [&](const std::string& tok) {
    auto it = handle->postings.find(tok);
    if (it == handle->postings.end()) return;
    const auto& plist = it->second;
    const double df = static_cast<double>(plist.size());
    const double idf =
        std::log(1.0 + (static_cast<double>(n_docs) - df + 0.5) / (df + 0.5));
    for (const Posting& p : plist) {
      const float dl = handle->doc_lens[static_cast<size_t>(p.row)];
      const float denom =
          static_cast<float>(p.tf) + k1 * (one_minus_b + b * dl / avg);
      const double term = idf * p.tf * (kK1 + 1.0) / denom;
      float& score = scores[static_cast<size_t>(p.row)];
      score = static_cast<float>(static_cast<double>(score) + term);
    }
  });
  std::vector<int32_t> rows;
  for (int64_t row = 0; row < n_docs; ++row) {
    if (scores[static_cast<size_t>(row)] > 0.0f)
      rows.push_back(static_cast<int32_t>(row));
  }
  const size_t keep =
      std::min<size_t>(rows.size(), static_cast<size_t>(top_k));
  std::partial_sort(
      rows.begin(), rows.begin() + static_cast<int64_t>(keep), rows.end(),
      [&](int32_t x, int32_t y) {
        const float sx = scores[static_cast<size_t>(x)];
        const float sy = scores[static_cast<size_t>(y)];
        if (sx != sy) return sx > sy;
        return x < y;
      });
  for (size_t i = 0; i < keep; ++i) {
    out_rows[i] = rows[i];
    out_scores[i] = scores[static_cast<size_t>(rows[i])];
  }
  return static_cast<int32_t>(keep);
}

}  // extern "C"
