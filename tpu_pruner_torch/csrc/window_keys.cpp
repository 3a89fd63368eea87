// The streaming window's join of row keys (tpu_pruner_torch.policy.engine.
// rekey_window) for rings on the host: where each of this cycle's chips was
// among the window's rows, which rows of absent chips stay, and which go;
// bit for bit what the plain version (engine.rekey_plain) gives. Rings on the
// card are joined on the card (tp_window_join in policy/csrc/chip_pass.cu).
//
// The rows are the last cycle's chips in the last cycle's order, then the
// rows kept for chips absent then, and this cycle's chips come in the
// dump's order; from one cycle to the next most chips keep their
// neighbours. So one walk over both in step carries nearly every row with
// one compare and no table, reading each key once and the runs of equal
// keys a block at a time (memcmp): the join is bound by those reads. Where
// the two part, the walk looks ahead on each side, nearest first, for where
// they meet again: a run of rows that left (a host missing its scrape, a
// JobSet replaced), or of chips that came (a new JobSet, a host back). If
// neither side's key is within reach, both are left for later and the walk
// goes on in step as far as it looked before it looks again, twice as far
// (a JobSet whose pods all got new ids in place, or a run longer than the
// reach); the reach starts at kReach and returns there once the two meet.
// What the walk leaves is joined through a hash table of the chips it left,
// which is small and stays in cache: a row whose key it holds moves to that
// chip, and the rest are absent.
//
// The rows out are given as runs: rows [out[k], out[k + 1]) take old rows
// from src[k] on, or are new where src[k] is -1; a cycle's few thousand
// changes give a few thousand runs, which the plain gather
// (kernels.window_gather_plain) takes in place of a row index a row.
//
// A repeated key among the chips in that table is refused; a key that
// repeats a chip the walk carried is not seen, so the caller gives unique
// keys (the CLI refuses a dump whose ids repeat).
//
// Plain C interface for ctypes (tpu_pruner_torch/hostlib.py).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kReach = 64;        // places first looked ahead on each side
constexpr int64_t kMaxReach = 1 << 20;  // the reach doubles up to this

// The rows as one sequence: the last cycle's chips, then the kept rows.
struct Rows {
  const int64_t* keys;
  int64_t present;
  int64_t cycle;  // the cycle the first `present` rows were seen in
  const int64_t* kept_keys;
  const int64_t* kept_seen;
  int64_t total;

  int64_t key(int64_t r) const { return r < present ? keys[r] : kept_keys[r - present]; }
  int64_t seen(int64_t r) const { return r < present ? cycle : kept_seen[r - present]; }
};

struct Slot {
  int64_t key;
  int64_t chip;  // -1: empty
};

// How many of a[0..n) equal b[0..n) before the first that differs: blocks
// of kBlock keys by memcmp, then one by one.
constexpr int64_t kBlock = 64;

int64_t same_run(const int64_t* a, const int64_t* b, int64_t n) {
  int64_t k = 0;
  while (k + kBlock <= n && std::memcmp(a + k, b + k, kBlock * sizeof(int64_t)) == 0)
    k += kBlock;
  while (k < n && a[k] == b[k]) ++k;
  return k;
}

// The rows out as maximal runs, appended in the order of the rows out.
struct Runs {
  int32_t* out;
  int32_t* src;
  int64_t n;

  // the rows out from o on take the old rows from s on (s < 0: new rows)
  void add(int64_t o, int64_t s) {
    if (n > 0 && (s < 0 ? src[n - 1] < 0 : src[n - 1] >= 0 && src[n - 1] + (o - out[n - 1]) == s))
      return;  // the last run goes on
    out[n] = int32_t(o);
    src[n] = int32_t(s);
    ++n;
  }
};

inline uint64_t slot_of(int64_t key, int shift) {
  return (uint64_t(key) * 0x9E3779B97F4A7C15ull) >> shift;
}

}  // namespace

extern "C" {

// The rows: prev_keys [P] seen in prev_cycle, then kept_keys [Q] each last
// seen in kept_seen; this cycle's C chips: keys. Writes the rows out as runs
// (run_out, run_src: at most C + P + Q), the keys and last-seen cycles of
// the rows kept for absent chips (out_kept_keys, out_kept_seen: at most
// P + Q), and counts = {rows out, new, retained, dropped, moved, runs}. A
// row of an absent chip stays while cycle - seen < K. Returns 0; 1 where a
// key repeats among this cycle's chips; 2 where one repeats among the rows.
int tp_rekey(const int64_t* prev_keys, int64_t P, int64_t prev_cycle, const int64_t* kept_keys,
             const int64_t* kept_seen, int64_t Q, const int64_t* keys, int64_t C, int64_t cycle,
             int64_t K, int32_t* run_out, int32_t* run_src, int64_t* out_kept_keys,
             int64_t* out_kept_seen, int64_t* counts) {
  const Rows rows{prev_keys, P, prev_cycle, kept_keys, kept_seen, P + Q};
  const int64_t R = rows.total;
  // the present rows in order: (first row, old row or -2 - its index among
  // the chips left, rows)
  struct Segment {
    int64_t out, src, len;
  };
  std::vector<Segment> segments;
  std::vector<int64_t> left_chips, left_rows;
  auto leave_chip = [&](int64_t c) {
    segments.push_back({c, -2 - int64_t(left_chips.size()), 1});
    left_chips.push_back(c);
  };
  int64_t i = 0, j = 0, look_at = 0, reach = kReach, moved = 0;
  while (i < C && j < R) {
    int64_t run = same_run(keys + i, prev_keys + j, j < P ? std::min(C - i, P - j) : 0);
    if (run == 0 && keys[i] == rows.key(j)) run = 1;
    if (run > 0) {
      segments.push_back({i, j, run});
      moved += i != j ? run : 0;
      i += run, j += run;
      reach = kReach;
      continue;
    }
    if (i >= look_at) {
      bool met = false;
      for (int64_t d = 1; d <= reach && !met; ++d) {
        if (j + d < R && rows.key(j + d) == keys[i]) {
          for (int64_t e = 0; e < d; ++e) left_rows.push_back(j++);
          met = true;
        } else if (i + d < C && keys[i + d] == rows.key(j)) {
          for (int64_t e = 0; e < d; ++e) leave_chip(i++);
          met = true;
        }
      }
      if (met) {
        reach = kReach;
        continue;
      }
      look_at = i + reach;
      reach = std::min(2 * reach, kMaxReach);
    }
    leave_chip(i++);
    left_rows.push_back(j++);
  }
  for (; i < C; ++i) leave_chip(i);
  const int64_t walked = j;  // rows from here on were all left, in order

  int bits = 4;
  while ((int64_t(1) << bits) < 2 * int64_t(left_chips.size())) ++bits;
  const int shift = 64 - bits;
  const uint64_t mask = (uint64_t(1) << bits) - 1;
  std::vector<Slot> table(std::size_t(1) << bits, Slot{0, -1});
  for (std::size_t n = 0; n < left_chips.size(); ++n) {
    const int64_t key = keys[left_chips[n]];
    uint64_t s = slot_of(key, shift);
    for (; table[s].chip >= 0; s = (s + 1) & mask)
      if (table[s].key == key) return 1;
    table[s] = Slot{key, int64_t(n)};
  }

  // each chip left: the row it takes, or -1; the rows kept, in order
  std::vector<int64_t> left_src(left_chips.size(), -1), kept;
  int64_t fresh = int64_t(left_chips.size()), dropped = 0;
  bool repeated = false;
  auto settle = [&](int64_t r, int64_t key, int64_t seen) {
    int64_t n = -1;
    if (!left_chips.empty()) {
      for (uint64_t s = slot_of(key, shift); table[s].chip >= 0; s = (s + 1) & mask)
        if (table[s].key == key) {
          n = table[s].chip;
          break;
        }
    }
    if (n >= 0) {
      repeated |= left_src[n] >= 0;
      left_src[n] = r;
      moved += left_chips[n] != r;
      --fresh;
    } else if (cycle - seen < K) {
      out_kept_keys[kept.size()] = key;
      out_kept_seen[kept.size()] = seen;
      moved += C + int64_t(kept.size()) != r;
      kept.push_back(r);
    } else {
      ++dropped;
    }
  };
  for (int64_t r : left_rows) settle(r, rows.key(r), rows.seen(r));
  for (int64_t r = walked; r < std::min(P, R); ++r) settle(r, prev_keys[r], prev_cycle);
  for (int64_t r = std::max(walked, P); r < R; ++r)
    settle(r, kept_keys[r - P], kept_seen[r - P]);
  if (repeated) return 2;

  Runs runs{run_out, run_src, 0};
  for (const Segment& g : segments) runs.add(g.out, g.src >= 0 ? g.src : left_src[-2 - g.src]);
  for (std::size_t k = 0; k < kept.size(); ++k) runs.add(C + int64_t(k), kept[k]);
  counts[0] = C + int64_t(kept.size());
  counts[1] = fresh;
  counts[2] = int64_t(kept.size());
  counts[3] = dropped;
  counts[4] = moved;
  counts[5] = runs.n;
  return 0;
}

}  // extern "C"
