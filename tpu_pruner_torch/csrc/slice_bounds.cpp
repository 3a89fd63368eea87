// The contiguous evaluator's segment bounds (tpu_pruner_torch.policy.engine.
// slice_bounds) in one pass over the sorted slice ids, bit for bit what the
// numpy body gives: bounds[s] is the number of ids below s, for s = 0..S.
//
// The order check reads every id once, as np.diff reads the ids (their
// differences wrap at the ids' width) and as they truly compare; it is
// branch-free over fixed blocks, so the compiler vectorises it at -O2. Ids
// that either reading finds descending are not taken: the caller's numpy
// body then raises, or defines the bounds by its binary search where only
// the true reading descends (neighbours 2^(width-1) or more apart).
//
// The bounds are then the change points of the sorted ids. Each is first
// guessed one slice on from the last, as long as the last slice (two reads
// confirm it); where the guess misses (a slice of another length, an empty
// slice) an exponential search from the last bound finds it. No branch is
// taken per chip.
//
// Plain C interface for ctypes (tpu_pruner_torch/policy/engine.py).

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int64_t kBlock = 64;  // ids a block of the order check

// The sign bit is set where x - y, wrapped at the width as np.diff wraps
// it, is negative, or where x < y truly. SSE2 compares 32-bit lanes but not
// 64-bit ones, so int64 reads x < y from the wrapped difference's sign
// corrected for overflow.
template <typename I>
inline std::make_unsigned_t<I> descends(I x, I y) {
  using U = std::make_unsigned_t<I>;
  U d = U(x) - U(y);
  if constexpr (sizeof(I) == 4) return d | (x < y ? ~U(0) : U(0));
  else return d | (d ^ ((U(x) ^ U(y)) & (d ^ U(x))));
}

template <typename I>
bool ascending(const I* ids, int64_t n) {
  using U = std::make_unsigned_t<I>;
  U acc = 0;
  int64_t i = 1;
  for (; i + kBlock <= n; i += kBlock) {
    const I* p = ids + i;
    U block = 0;
    for (int k = 0; k < kBlock; ++k) block |= descends(p[k], p[k - 1]);
    acc |= block;
  }
  for (; i < n; ++i) acc |= descends(ids[i], ids[i - 1]);
  return (acc >> (sizeof(U) * 8 - 1)) == 0;
}

// The first j >= lo with ids[j] >= s (n if none), given ids[j] < s below lo.
template <typename I>
int64_t first_at_least(const I* ids, int64_t lo, int64_t n, int64_t s) {
  int64_t step = 1;
  while (lo + step <= n && ids[lo + step - 1] < s) {
    lo += step;
    step *= 2;
  }
  int64_t hi = std::min(lo + step - 1, n);  // ids[hi] >= s, or hi == n
  while (lo < hi) {
    int64_t mid = lo + (hi - lo) / 2;
    if (ids[mid] < s) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <typename I>
int bounds(const I* ids, int64_t n, int64_t num_slices, int32_t* out) {
  if (!ascending(ids, n)) return 1;
  int64_t lo = 0, len = 0;  // the last bound, and the last slice's length
  for (int64_t s = 0; s <= num_slices; ++s) {
    int64_t g = lo + len;
    bool hit = g <= n && (g == lo || ids[g - 1] < s) && (g == n || ids[g] >= s);
    if (!hit) g = first_at_least(ids, lo, n, s);
    out[s] = static_cast<int32_t>(g);
    len = g - lo;
    lo = g;
  }
  return 0;
}

}  // namespace

extern "C" {

// bounds[0..num_slices] for n ids of id_bytes (4: int32, 8: int64) each,
// n < 2^31. Returns 0 with the bounds written; 1 where the ids are not
// ascending (bounds untouched); -1 for another width.
int tp_slice_bounds(const void* ids, int32_t id_bytes, int64_t n, int64_t num_slices,
                    int32_t* out) {
  if (id_bytes == 4) return bounds(static_cast<const int32_t*>(ids), n, num_slices, out);
  if (id_bytes == 8) return bounds(static_cast<const int64_t*>(ids), n, num_slices, out);
  return -1;
}

}  // extern "C"
