// The audit dump's reader: from the dump's bytes to the grouped arrays that
// tpu_pruner_torch.analyze.load_fleet returns, with no Python object for
// each chip or sample.
//
// Exact or not taken. tp_dump_scan parses the whole document and returns a
// handle only when the result is, bit for bit, what load_fleet(json.load(f))
// gives; on anything else it returns null and the caller runs json.load and
// load_fleet instead. It takes JSON's grammar (whitespace, any key order,
// unknown keys and nested unknown values), numbers with Python's NaN,
// Infinity and -Infinity, null samples (a step with no sample: invalid in
// tc, 0 in hbm), string ids or a missing id, a missing pod_age_s, a missing,
// null or empty hbm, and ragged series. It does not take: a backslash, a
// control byte or a byte of 0x80 or above inside any string; a repeated key
// that the program reads; true, false or a string in a series; a non-string
// slice or id; a non-number pod_age_s or top-level
// scalar; an integer literal of more than 15 digits; a number that
// from_chars does not convert exactly (out of range, underflow to zero); an
// empty chips list; nesting deeper than kMaxDepth; anything json.load
// refuses.
//
// Numbers convert as Python and numpy convert them: correctly rounded text
// to double (an integer literal as an integer, so -0 reads +0), then double
// to float with the C cast, which keeps subnormals and overflows to +-inf as
// numpy's cast does. numpy warns on such an overflow; the scan reports it.
//
// The chips list is read in parts on threads. Each part after the first
// starts at a guess: a '{' after a ','. A part ends at the first chip
// boundary at or past the next part's start; only where that boundary is
// the next start exactly was the guess a chip's start, and the parts chain.
// Where a guess fell inside a chip, the list is read again in one part.
//
// tp_dump_fill then numbers the slices by their sorted names, orders chips
// by (slice, id) as np.lexsort does (stable), and writes every array.
// Plain C interface for ctypes (tpu_pruner_torch/dump_reader.py).

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <string>
#include <string_view>
#include <system_error>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxDepth = 64;       // far below Python's recursion limit
constexpr int kMaxIntDigits = 15;   // exact in a double, whatever the path
constexpr unsigned kMaxThreads = 8;
constexpr double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                             1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                             1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};  // exact
enum Scalar { kTimestamp, kLookback, kHbmThreshold, kStepS, kScalars };
enum Overflow { kTcOverflow = 1, kHbmOverflow = 2, kAgeOverflow = 4 };
// A null sample as the parts store it: a NaN whose payload no number parses to.
constexpr uint32_t kNullBits = 0x7fc0deadu;

bool is_null(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, sizeof bits);
  return bits == kNullBits;
}

struct Series {
  int64_t off = 0, len = 0;  // into the samples of the chip's Part
  bool nulls = false;        // some sample is null
};

struct Chip {
  std::string_view id;
  float age = 0.0f;
  int32_t slice = 0;  // index into the slices of the chip's Part
  Series tc, hbm;
  bool has_id = false;
};

// What a stretch of the chips list gives: its chips, their samples, and the
// slices they name, in order of first appearance.
struct Part {
  std::vector<Chip> chips;
  std::vector<float> samples;
  std::vector<std::string_view> slices;
  std::unordered_map<std::string_view, int32_t> slice_index;
  int overflow = 0;  // Overflow bits

  int32_t slice_of(std::string_view name) {
    auto [it, added] = slice_index.try_emplace(name, static_cast<int32_t>(slices.size()));
    if (added) slices.push_back(name);
    return it->second;
  }
};

struct Dump {
  Part all;                // every chip, in document order
  std::vector<std::string> positional;  // str(i) of the chips without an id
  double scalars[kScalars] = {0, 0, 0, 0};
  int present = 0;         // bit k: scalars[k] was given
  int64_t samples_max = 1; // T
  int64_t id_width = 1;    // numpy's <U width: the longest id, at least 1
  int64_t names_bytes = 0; // the sorted names joined by '\n'
  int64_t default_ids = 0;
  int64_t ragged = 0;      // chips whose tc, or given hbm, is not T samples long
  size_t threads = 1;      // the parts the scan used; the fill uses as many
};

// fn(j) for j in [0, n), on n threads (this one included). fn must not throw.
template <class Fn>
void parallel(size_t n, Fn fn) {
  std::vector<std::thread> threads;
  for (size_t j = 1; j < n; ++j) {
    try {
      threads.emplace_back(fn, j);
    } catch (...) {  // no thread: run it here
      fn(j);
    }
  }
  fn(0);
  for (std::thread& t : threads) t.join();
}

bool is_ws(char c) { return c == ' ' || c == '\t' || c == '\n' || c == '\r'; }
bool is_digit(char c) { return c >= '0' && c <= '9'; }

// A position in the document and the grammar's pieces.
struct Cursor {
  const char* p;
  const char* end;

  void ws() {
    while (p < end && is_ws(*p)) ++p;
  }
  bool peek(char c) const { return p < end && *p == c; }
  bool word(std::string_view w) {
    if (end - p < static_cast<std::ptrdiff_t>(w.size()) || std::memcmp(p, w.data(), w.size()))
      return false;
    p += w.size();
    return true;
  }
  bool open(char c) {
    if (!peek(c)) return false;
    ++p;
    ws();
    return true;
  }
  // After a member or an element: ',' and the next one, or at the closer.
  bool next_or_close(char closer) {
    ws();
    if (peek(',')) {
      ++p;
      ws();
      return !peek(closer);  // a trailing comma is refused
    }
    return peek(closer);
  }
  bool key_colon(std::string_view& key) {
    if (!string(key)) return false;
    ws();
    if (!peek(':')) return false;
    ++p;
    ws();
    return true;
  }

  // A string of printable ASCII without escapes, else not taken.
  bool string(std::string_view& out) {
    if (!peek('"')) return false;
    const char* start = ++p;
    while (p < end) {
      unsigned char c = static_cast<unsigned char>(*p);
      if (c == '"') {
        out = std::string_view(start, p - start);
        ++p;
        return true;
      }
      if (c < 0x20 || c >= 0x80 || c == '\\') return false;
      ++p;
    }
    return false;
  }

  // One number as Python's json reads it, converted as float() converts
  // the value: an integer literal as an integer, so -0 reads +0. A decimal
  // of at most 15 significant digits with an exponent within 10^22 converts
  // in one rounding (m * 10^e or m / 10^-e, both exact); from_chars takes
  // the rest.
  bool number(double& out) {
    const char* start = p;
    bool negative = peek('-');
    if (negative) ++p;
    if (p >= end) return false;
    if (*p == 'N' || *p == 'I') {
      if (!negative && word("NaN")) {
        out = std::numeric_limits<double>::quiet_NaN();
        return true;
      }
      if (!word("Infinity")) return false;
      out = negative ? -std::numeric_limits<double>::infinity()
                     : std::numeric_limits<double>::infinity();
      return true;
    }
    uint64_t m = 0;
    int digits = 0;  // significant digits, leading zeros left out
    if (*p == '0') {
      ++p;
    } else if (*p >= '1' && *p <= '9') {
      while (p < end && is_digit(*p)) add_digit(m, digits);
    } else {
      return false;
    }
    const int int_digits = digits;
    int64_t exp10 = 0;
    bool is_int = true;
    if (peek('.')) {
      ++p;
      if (p >= end || !is_digit(*p)) return false;
      const char* frac = p;
      while (p < end && is_digit(*p)) add_digit(m, digits);
      exp10 -= p - frac;
      is_int = false;
    }
    if (peek('e') || peek('E')) {
      ++p;
      bool exp_negative = peek('-');
      if (exp_negative || peek('+')) ++p;
      if (p >= end || !is_digit(*p)) return false;
      int64_t e = 0;
      while (p < end && is_digit(*p)) {
        if (e < 100000) e = e * 10 + (*p - '0');
        ++p;
      }
      exp10 += exp_negative ? -e : e;
      is_int = false;
    }
    if (is_int) {
      if (int_digits > kMaxIntDigits) return false;
      const int64_t v = static_cast<int64_t>(m);
      out = static_cast<double>(negative ? -v : v);  // as an int, -0 is 0
      return true;
    }
    if (digits <= kMaxIntDigits && exp10 >= -22 && exp10 <= 22) {
      double v = static_cast<double>(m);
      v = exp10 < 0 ? v / kPow10[-exp10] : v * kPow10[exp10];
      out = negative ? -v : v;
      return true;
    }
    auto r = std::from_chars(start, p, out, std::chars_format::general);
    return r.ec == std::errc() && r.ptr == p;
  }
  // One more digit; m keeps the first 19 significant digits only, which is
  // all the fast path reads (it needs 15 or fewer).
  void add_digit(uint64_t& m, int& digits) {
    int d = *p++ - '0';
    if (digits < 19) {
      m = m * 10 + d;
      if (m) ++digits;
    } else {
      ++digits;
    }
  }

  // Validates one value the program does not read, and steps over it.
  bool skip(int depth) {
    if (depth > kMaxDepth || p >= end) return false;
    switch (*p) {
      case '"': {
        std::string_view s;
        return string(s);
      }
      case '{':
        if (open('{') && !peek('}')) {
          for (;;) {
            std::string_view key;
            if (!key_colon(key) || !skip(depth + 1) || !next_or_close('}')) return false;
            if (peek('}')) break;
          }
        }
        break;
      case '[':
        if (open('[') && !peek(']')) {
          for (;;) {
            if (!skip(depth + 1) || !next_or_close(']')) return false;
            if (peek(']')) break;
          }
        }
        break;
      case 't':
        return word("true");
      case 'f':
        return word("false");
      case 'n':
        return word("null");
      default: {
        double v;
        return number(v);
      }
    }
    ++p;  // the closer
    return true;
  }
};

enum class Run { kArrayEnd, kHandoff, kOvershoot, kFail };

// Reads chips into a Part.
class ChipReader : public Cursor {
 public:
  ChipReader(const char* from, const char* to, Part& part) : Cursor{from, to}, part_(part) {}

  // Chips from here to the list's ']' (kArrayEnd, p after it), or to the
  // first chip boundary at or past ``stop`` (kHandoff where it is ``stop``,
  // else kOvershoot).
  Run run(const char* stop) {
    for (;;) {
      if (!chip()) return Run::kFail;
      ws();
      if (peek(']')) {
        ++p;
        return Run::kArrayEnd;
      }
      if (!peek(',')) return Run::kFail;
      ++p;
      ws();
      if (p >= stop) return p == stop ? Run::kHandoff : Run::kOvershoot;
    }
  }

 private:
  Part& part_;

  // An array of numbers and nulls, each stored as float, a null as
  // kNullBits; ``flag`` marks an overflow.
  bool series(Series& s, int flag) {
    if (!open('[')) return false;
    s.off = static_cast<int64_t>(part_.samples.size());
    if (!peek(']')) {
      for (;;) {
        double v;
        float f;
        if (word("null")) {
          std::memcpy(&f, &kNullBits, sizeof f);
          s.nulls = true;
        } else {
          if (!number(v)) return false;
          f = static_cast<float>(v);
          if (std::isinf(f) && std::isfinite(v)) part_.overflow |= flag;
        }
        part_.samples.push_back(f);
        if (!next_or_close(']')) return false;
        if (peek(']')) break;
      }
    }
    ++p;
    s.len = static_cast<int64_t>(part_.samples.size()) - s.off;
    return true;
  }

  bool chip() {
    if (!open('{')) return false;
    Chip c;
    std::string_view slice;
    enum { kSlice = 1, kId = 2, kAge = 4, kTc = 8, kHbm = 16 };
    int seen = 0;
    if (!peek('}')) {
      for (;;) {
        std::string_view key;
        if (!key_colon(key)) return false;
        int bit = key == "slice" ? kSlice : key == "id" ? kId
                  : key == "pod_age_s" ? kAge : key == "tc" ? kTc
                  : key == "hbm" ? kHbm : 0;
        if (seen & bit) return false;  // Python keeps the last: not taken
        seen |= bit;
        bool ok;
        switch (bit) {
          case kSlice:
            ok = string(slice);
            break;
          case kId:
            ok = string(c.id);
            break;
          case kAge: {
            double v;
            ok = number(v);
            if (ok) {
              c.age = static_cast<float>(v);
              if (std::isinf(c.age) && std::isfinite(v)) part_.overflow |= kAgeOverflow;
            }
            break;
          }
          case kTc:
            ok = series(c.tc, kTcOverflow);
            break;
          case kHbm:
            ok = word("null") || series(c.hbm, kHbmOverflow);
            break;
          default:
            ok = skip(3);
        }
        if (!ok || !next_or_close('}')) return false;
        if (peek('}')) break;
      }
    }
    ++p;
    if ((seen & (kSlice | kTc)) != (kSlice | kTc)) return false;
    c.has_id = seen & kId;
    c.slice = part_.slice_of(slice);
    part_.chips.push_back(c);
    return true;
  }
};

// The first '{' at or after ``q`` whose previous non-space byte is a ','
// after ``begin``: where a chip may start.
const char* guess_chip_start(const char* begin, const char* q, const char* end) {
  while ((q = static_cast<const char*>(std::memchr(q, '{', end - q)))) {
    const char* b = q;
    while (b > begin && is_ws(b[-1])) --b;
    if (b > begin && b[-1] == ',') return q;
    ++q;
  }
  return nullptr;
}

// Appends parts[1..] to parts[0], in order.
void merge(std::vector<Part>& parts, size_t used) {
  Part& all = parts[0];
  size_t chips = 0, samples = 0;
  for (size_t j = 0; j < used; ++j) {
    chips += parts[j].chips.size();
    samples += parts[j].samples.size();
  }
  all.chips.reserve(chips);
  all.samples.reserve(samples);
  for (size_t j = 1; j < used; ++j) {
    Part& part = parts[j];
    const int64_t off = static_cast<int64_t>(all.samples.size());
    all.samples.insert(all.samples.end(), part.samples.begin(), part.samples.end());
    std::vector<int32_t> global(part.slices.size());
    for (size_t s = 0; s < part.slices.size(); ++s) global[s] = all.slice_of(part.slices[s]);
    for (Chip c : part.chips) {
      c.tc.off += off;
      c.hbm.off += off;
      c.slice = global[c.slice];
      all.chips.push_back(c);
    }
    all.overflow |= part.overflow;
    part = Part();
  }
}

// The chips list at ``top`` (its '['), read in parts of about ``part_bytes``.
bool read_chips(Cursor& top, Dump& d, int64_t part_bytes) {
  if (!top.open('[') || top.peek(']')) return false;  // an empty fleet: load_fleet raises
  const char* body = top.p;
  const int64_t size = top.end - body;
  const unsigned hw = std::max(1u, std::min(kMaxThreads, std::thread::hardware_concurrency()));
  const int64_t n = std::clamp<int64_t>(size / std::max<int64_t>(part_bytes, 1), 1, hw);
  std::vector<const char*> starts{body};
  for (int64_t k = 1; k < n; ++k) {
    const char* q = guess_chip_start(body, body + size * k / n, top.end);
    if (q && q > starts.back()) starts.push_back(q);
  }
  const size_t m = starts.size();
  starts.push_back(top.end);
  std::vector<Part> parts(m);
  std::vector<Run> runs(m, Run::kFail);
  std::vector<const char*> ends(m);
  parallel(m, [&](size_t j) {
    try {
      ChipReader reader(starts[j], top.end, parts[j]);
      parts[j].samples.reserve(static_cast<size_t>((starts[j + 1] - starts[j]) / 16));
      runs[j] = reader.run(starts[j + 1]);
      ends[j] = reader.p;
    } catch (...) {  // std::bad_alloc: not taken
      runs[j] = Run::kFail;
    }
  });
  size_t used = 0;
  while (runs[used] == Run::kHandoff && used + 1 < m) ++used;
  if (runs[used] == Run::kOvershoot) {  // a guess fell inside a chip: one part
    parts.assign(1, Part());
    ChipReader reader(body, top.end, parts[0]);
    runs[0] = reader.run(top.end);
    ends[0] = reader.p;
    used = 0;
  }
  if (runs[used] != Run::kArrayEnd) return false;
  top.p = ends[used];
  merge(parts, used + 1);
  d.all = std::move(parts[0]);
  d.threads = m;
  return true;
}

bool read_document(const char* data, int64_t size, Dump& d, int64_t part_bytes) {
  Cursor top{data, data + size};
  top.ws();
  if (!top.open('{')) return false;
  bool seen_chips = false;
  if (!top.peek('}')) {
    for (;;) {
      std::string_view key;
      if (!top.key_colon(key)) return false;
      int k = key == "timestamp" ? kTimestamp
              : key == "lookback_s" ? kLookback
              : key == "hbm_threshold" ? kHbmThreshold
              : key == "step_s" ? kStepS : -1;
      if (key == "chips") {
        if (seen_chips || !read_chips(top, d, part_bytes)) return false;
        seen_chips = true;
      } else if (k >= 0) {
        if (d.present & (1 << k) || !top.number(d.scalars[k])) return false;
        d.present |= 1 << k;
      } else if (!top.skip(1)) {
        return false;
      }
      if (!top.next_or_close('}')) return false;
      if (top.peek('}')) break;
    }
  }
  ++top.p;  // '}'
  top.ws();
  return top.p == top.end && seen_chips;
}

// Sizes, and the positional ids str(i) of the chips without an id.
void finish(Dump& d) {
  std::vector<Chip>& chips = d.all.chips;
  for (const Chip& c : chips) d.default_ids += !c.has_id;
  d.positional.reserve(d.default_ids);  // never moves: the ids point into it
  for (size_t i = 0; i < chips.size(); ++i) {
    Chip& c = chips[i];
    d.samples_max = std::max({d.samples_max, c.tc.len, c.hbm.len});
    if (!c.has_id) c.id = d.positional.emplace_back(std::to_string(i));
    d.id_width = std::max<int64_t>(d.id_width, static_cast<int64_t>(c.id.size()));
  }
  for (const Chip& c : chips)
    d.ragged += c.tc.len != d.samples_max || (c.hbm.len && c.hbm.len != d.samples_max);
  for (std::string_view s : d.all.slices) d.names_bytes += static_cast<int64_t>(s.size()) + 1;
  d.names_bytes -= 1;
}

// [begin, end) of the j-th of n near-equal stretches of [0, size).
std::pair<int64_t, int64_t> stretch(size_t j, size_t n, int64_t size) {
  return {size * static_cast<int64_t>(j) / static_cast<int64_t>(n),
          size * static_cast<int64_t>(j + 1) / static_cast<int64_t>(n)};
}

}  // namespace

extern "C" {

// Parses ``size`` bytes at ``data``, the chips list in parts of about
// ``part_bytes``. Returns a handle, or null when the reader does not take
// the document. ``sizes``: chips, T, slices, the names' bytes, the ids'
// width, default ids, the Overflow bits, the ragged chips. ``scalars``:
// timestamp, lookback_s, hbm_threshold, step_s; ``present`` has bit k set
// where the k-th was given. The handle points into ``data``, which must
// outlive it.
void* tp_dump_scan(const char* data, int64_t size, int64_t part_bytes, int64_t* sizes,
                   double* scalars, int32_t* present) {
  Dump* d = nullptr;
  try {
    d = new Dump();
    if (!read_document(data, size, *d, part_bytes)) {
      delete d;
      return nullptr;
    }
    finish(*d);
  } catch (...) {  // std::bad_alloc: left to json.load
    delete d;
    return nullptr;
  }
  const int64_t out[] = {static_cast<int64_t>(d->all.chips.size()), d->samples_max,
                         static_cast<int64_t>(d->all.slices.size()), d->names_bytes,
                         d->id_width, d->default_ids, d->all.overflow, d->ragged};
  std::memcpy(sizes, out, sizeof(out));
  std::memcpy(scalars, d->scalars, sizeof(d->scalars));
  *present = d->present;
  return d;
}

// Writes the grouped arrays: tc, hbm [chips, T] f32; valid [chips, T] bool;
// age [chips] f32; slice_id [chips] int32; the sorted slice names joined by
// '\n'; the ids in row order as numpy's <U{width} (UCS-4, zero padded).
// Returns 0, or 1 if memory ran out.
int tp_dump_fill(void* handle, float* tc, float* hbm, uint8_t* valid, float* age,
                 int32_t* slice_id, char* names, uint32_t* ids) {
  const Dump& d = *static_cast<const Dump*>(handle);
  const std::vector<Chip>& chips = d.all.chips;
  const std::vector<std::string_view>& slices = d.all.slices;
  const int64_t C = static_cast<int64_t>(chips.size()), T = d.samples_max, W = d.id_width;
  const int64_t S = static_cast<int64_t>(slices.size());
  try {
    std::vector<int32_t> by_name(S), rank(S);
    std::iota(by_name.begin(), by_name.end(), 0);
    std::sort(by_name.begin(), by_name.end(),
              [&](int32_t a, int32_t b) { return slices[a] < slices[b]; });
    for (int64_t r = 0; r < S; ++r) {
      rank[by_name[r]] = static_cast<int32_t>(r);
      if (r) *names++ = '\n';
      names = std::copy(slices[by_name[r]].begin(), slices[by_name[r]].end(), names);
    }

    // Bucket by slice, keeping the document's order, then sort each bucket
    // by id, stably: np.lexsort((ids, slice_id)).
    struct Key {
      std::string_view id;
      int64_t chip;
    };
    std::vector<int64_t> start(S + 1, 0);
    for (const Chip& c : chips) ++start[rank[c.slice] + 1];
    std::partial_sum(start.begin(), start.end(), start.begin());
    std::vector<Key> keys(C);
    {
      std::vector<int64_t> at(start.begin(), start.end() - 1);
      for (int64_t k = 0; k < C; ++k) keys[at[rank[chips[k].slice]]++] = {chips[k].id, k};
    }
    std::vector<int64_t> row_of(C);
    parallel(d.threads, [&](size_t j) {
      auto [s0, s1] = stretch(j, d.threads, S);
      for (int64_t s = s0; s < s1; ++s) {
        Key* first = keys.data() + start[s];
        Key* last = keys.data() + start[s + 1];
        auto by_id = [](const Key& a, const Key& b) { return a.id < b.id; };
        if (!std::is_sorted(first, last, by_id)) std::stable_sort(first, last, by_id);
        for (Key* key = first; key < last; ++key) row_of[key->chip] = key - keys.data();
      }
    });

    // Rows, reading the chips in document order.
    const float* samples = d.all.samples.data();
    parallel(d.threads, [&](size_t j) {
      auto [k0, k1] = stretch(j, d.threads, C);
      for (int64_t k = k0; k < k1; ++k) {
        const Chip& c = chips[k];
        const int64_t r = row_of[k], n = c.tc.len, m = c.hbm.len;
        float* tc_row = tc + r * T;
        float* hbm_row = hbm + r * T;
        uint8_t* valid_row = valid + r * T;
        std::fill(tc_row, tc_row + (T - n), 0.0f);
        std::copy_n(samples + c.tc.off, n, tc_row + (T - n));
        std::fill(valid_row, valid_row + (T - n), uint8_t{0});
        std::fill(valid_row + (T - n), valid_row + T, uint8_t{1});
        if (c.tc.nulls) {
          for (int64_t t = T - n; t < T; ++t) {
            if (is_null(tc_row[t])) {
              tc_row[t] = 0.0f;
              valid_row[t] = 0;
            }
          }
        }
        std::fill(hbm_row, hbm_row + (T - m), 0.0f);
        std::copy_n(samples + c.hbm.off, m, hbm_row + (T - m));
        if (c.hbm.nulls) {
          for (int64_t t = T - m; t < T; ++t) {
            if (is_null(hbm_row[t])) hbm_row[t] = 0.0f;
          }
        }
        age[r] = c.age;
        slice_id[r] = rank[c.slice];
        uint32_t* id_row = ids + r * W;
        id_row = std::copy(c.id.begin(), c.id.end(), id_row);  // ASCII: a code point a byte
        std::fill(id_row, ids + (r + 1) * W, 0u);
      }
    });
  } catch (...) {
    return 1;
  }
  return 0;
}

void tp_dump_free(void* handle) { delete static_cast<Dump*>(handle); }

}  // extern "C"
