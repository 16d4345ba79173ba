// Host C++ routine of the ingest: the batched exact MJD parse.
//
// The per-TOA exact decimal MJD parse is the dominant cost of loading a
// large tim file in pure Python (one decimal.Decimal round trip per TOA).
// Here: a batched parse of decimal MJD strings into (int day,
// double-double seconds-of-day), using error-free transforms (two_sum /
// fma two_prod), so the result matches the Python Decimal-exact path to
// ~1e-32 relative (far below the 1e-28 s resolution of the timebase).
//
// Build: g++ -O3 -shared -fPIC, at first use, by
// pint_tpu_torch/native/__init__.py into pint_tpu_torch/_build/.

#include <cmath>
#include <cstdint>

namespace {

struct dd {
  double hi, lo;
};

inline dd two_sum(double a, double b) {
  double s = a + b;
  double bb = s - a;
  double err = (a - (s - bb)) + (b - bb);
  return {s, err};
}

inline dd quick_two_sum(double a, double b) {
  double s = a + b;
  return {s, b - (s - a)};
}

inline dd two_prod(double a, double b) {
  double p = a * b;
  return {p, std::fma(a, b, -p)};
}

inline dd dd_add_d(dd a, double b) {
  dd s = two_sum(a.hi, b);
  double lo = s.lo + a.lo;
  return quick_two_sum(s.hi, lo);
}

inline dd dd_mul_d(dd a, double b) {
  dd p = two_prod(a.hi, b);
  double lo = p.lo + a.lo * b;
  return quick_two_sum(p.hi, lo);
}

inline dd dd_div_d(dd a, double b) {
  double q1 = a.hi / b;
  dd p = two_prod(q1, b);
  double r = ((a.hi - p.hi) - p.lo) + a.lo;
  return quick_two_sum(q1, r / b);
}

// exact powers of ten as doubles (10^k is exact for k <= 22)
double pow10_exact(int k) {
  double v = 1.0;
  for (int i = 0; i < k; ++i) v *= 10.0;
  return v;
}

}  // namespace

extern "C" {

// Parse n decimal MJD strings (pulsar_mjd convention: fraction of an
// 86400 s day).  buf holds the concatenated strings; offsets/lengths
// index it.  Outputs: integer day, seconds-of-day as (hi, lo).
// Returns 0 on success, or 1-based index of the first bad string.
int64_t parse_mjd_strings(const char* buf, const int64_t* offsets,
                          const int64_t* lengths, int64_t n,
                          int64_t* day_out, double* hi_out,
                          double* lo_out) {
  for (int64_t i = 0; i < n; ++i) {
    const char* s = buf + offsets[i];
    int64_t len = lengths[i];
    int64_t pos = 0;
    while (pos < len && (s[pos] == ' ' || s[pos] == '\t')) ++pos;
    if (pos < len && s[pos] == '+') ++pos;
    if (pos >= len || s[pos] == '-') return i + 1;  // negative: no
    // integer part (<= 18 digits: no int64 overflow possible)
    int64_t day = 0;
    int idigits = 0;
    while (pos < len && s[pos] >= '0' && s[pos] <= '9') {
      if (++idigits > 18) return i + 1;
      day = day * 10 + (s[pos] - '0');
      ++pos;
    }
    if (idigits == 0) return i + 1;
    // fraction
    dd frac = {0.0, 0.0};
    int ndigits = 0;
    if (pos < len && s[pos] == '.') {
      ++pos;
      // accumulate in chunks of 15 digits (10^15 < 2^53: every chunk
      // value is exactly representable in a double)
      while (pos < len && s[pos] >= '0' && s[pos] <= '9') {
        uint64_t chunk = 0;
        int c = 0;
        while (pos < len && s[pos] >= '0' && s[pos] <= '9' && c < 15) {
          chunk = chunk * 10 + uint64_t(s[pos] - '0');
          ++pos;
          ++c;
        }
        frac = dd_mul_d(frac, pow10_exact(c));
        frac = dd_add_d(frac, double(chunk));
        ndigits += c;
      }
      // divide by 10^ndigits (in exact <=22-power steps)
      int k = ndigits;
      while (k > 0) {
        int step = k > 22 ? 22 : k;
        frac = dd_div_d(frac, pow10_exact(step));
        k -= step;
      }
    }
    while (pos < len && (s[pos] == ' ' || s[pos] == '\t')) ++pos;
    if (pos != len) return i + 1;  // trailing junk
    dd sec = dd_mul_d(frac, 86400.0);
    day_out[i] = day;
    hi_out[i] = sec.hi;
    lo_out[i] = sec.lo;
  }
  return 0;
}

// Self-test hook: dd arithmetic sanity (returns 0 when healthy).
int64_t native_self_test() {
  dd a = {1.0, 0.0};
  a = dd_div_d(a, 3.0);
  a = dd_mul_d(a, 3.0);
  // 1/3*3 in dd must be 1 to ~1e-32
  double err = std::fabs((a.hi - 1.0) + a.lo);
  return err < 1e-30 ? 0 : 1;
}

}  // extern "C"
