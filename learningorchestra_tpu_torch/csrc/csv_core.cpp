// csv_core — the PyTorch package's host core for CSV ingest, query reads,
// histograms and the batch gather: its own version of the non-booster half
// of the JAX package's csrc/locore.cpp (CSV parse, value counts, predicate
// filter, row gather), built on its own.
//
// The CSV half reads records exactly as Python's csv.reader reads them in
// its default dialect (doubled quotes; a quote inside an unquoted field is
// literal; a quoted field may hold newlines; \r, \n and \r\n end a record;
// text after a closing quote joins the field; an open quote at the end of
// the input closes the field), and types cells by the port's kinds (int64,
// float64, bool, string, null) as learningorchestra_tpu_torch/native/ops.py
// defines them. A cell with a byte outside printable ASCII and \t\n\v\f\r
// ("not plain") is never judged here as a number: the caller's Python
// predicates decide it, since Python's int()/float() take non-ASCII
// digits and whitespace. Float text is read with the Clinger fast path or
// correctly rounded strtod behind it; int64 text is read exactly.
//
// Host code: the card has no part in it.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC
// (learningorchestra_tpu_torch/native builds it at first use into
// build/native/; every caller keeps the Python version in native/ops.py).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

#define LO_API extern "C"

namespace {

// csv.reader's field_size_limit(): a longer field is an error there
constexpr int64_t kFieldLimit = 131072;

enum State { START_RECORD, START_FIELD, IN_FIELD, IN_QUOTED, QUOTE_IN_QUOTED };

inline bool is_newline(char c) { return c == '\n' || c == '\r'; }

// Python's str.isspace() on the plain bytes (\x1c-\x1f are not plain)
inline bool is_space(unsigned char c) {
  return c == ' ' || (c >= '\t' && c <= '\r');
}

inline bool is_plain(unsigned char c) {
  return (c >= 0x20 && c < 0x7f) || (c >= '\t' && c <= '\r');
}

// Strict UTF-8 as Python's decoder takes it: no overlong forms, no
// surrogates, nothing past U+10FFFF. `truncated_ok`: a sequence cut by the
// end of the buffer is not an error.
bool utf8_valid(const unsigned char* s, int64_t n, bool truncated_ok) {
  int64_t i = 0;
  while (i < n) {
    // eight ASCII bytes at a time
    while (i + 8 <= n) {
      uint64_t w;
      std::memcpy(&w, s + i, 8);
      if (w & 0x8080808080808080ULL) break;
      i += 8;
    }
    if (i >= n) break;
    unsigned char c = s[i];
    if (c < 0x80) {
      ++i;
      continue;
    }
    int need;
    unsigned char lo = 0x80, hi = 0xbf;
    if (c >= 0xc2 && c <= 0xdf) {
      need = 1;
    } else if (c >= 0xe0 && c <= 0xef) {
      need = 2;
      if (c == 0xe0) lo = 0xa0;
      if (c == 0xed) hi = 0x9f;
    } else if (c >= 0xf0 && c <= 0xf4) {
      need = 3;
      if (c == 0xf0) lo = 0x90;
      if (c == 0xf4) hi = 0x8f;
    } else {
      return false;
    }
    for (int k = 1; k <= need; ++k) {
      if (i + k >= n) return truncated_ok;
      unsigned char b = s[i + k];
      if (k == 1 ? (b < lo || b > hi) : (b < 0x80 || b > 0xbf)) return false;
    }
    i += need + 1;
  }
  return true;
}

// The state machine of csv.reader over one buffer: on_char(c) adds a byte
// to the current field, on_run(p, n) adds n bytes, on_field() ends it.
struct Reader {
  const char* buf;
  int64_t len;
  int64_t pos = 0;

  // Skips blank lines; false at the end of the input.
  bool at_record() {
    while (pos < len && is_newline(buf[pos])) ++pos;
    return pos < len;
  }

  // One record from `pos`; `complete` is false when the input ends before
  // its terminator (inside a quoted field, or with no newline).
  template <class Field, class Byte, class Run>
  bool record(Field on_field, Byte on_char, Run on_run, bool* complete) {
    State st = START_FIELD;
    *complete = false;
    while (pos < len) {
      const char c = buf[pos];
      switch (st) {
        case START_FIELD:
          if (is_newline(c)) {
            on_field();
            goto end_record;
          } else if (c == '"') {
            st = IN_QUOTED;
          } else if (c == ',') {
            on_field();
          } else {
            on_char(c);
            st = IN_FIELD;
          }
          ++pos;
          break;
        case IN_FIELD: {
          // the run of plain field bytes up to the next delimiter/newline
          int64_t p = pos;
          while (p < len && buf[p] != ',' && !is_newline(buf[p])) ++p;
          on_run(buf + pos, p - pos);
          pos = p;
          if (pos >= len) break;
          on_field();
          if (is_newline(buf[pos])) goto end_record;
          ++pos;
          st = START_FIELD;
          break;
        }
        case IN_QUOTED: {
          int64_t p = pos;
          while (p < len && buf[p] != '"') ++p;
          on_run(buf + pos, p - pos);
          pos = p;
          if (pos >= len) break;
          ++pos;
          st = QUOTE_IN_QUOTED;
          break;
        }
        case QUOTE_IN_QUOTED:
          if (c == '"') {
            on_char('"');
            st = IN_QUOTED;
          } else if (c == ',') {
            on_field();
            st = START_FIELD;
          } else if (is_newline(c)) {
            on_field();
            goto end_record;
          } else {
            on_char(c);
            st = IN_FIELD;
          }
          ++pos;
          break;
        default:
          break;
      }
    }
    // the input ends inside the record: its last field closes here
    on_field();
    return false;
  end_record:
    // the terminator: \r\n counts as one
    if (buf[pos] == '\r' && pos + 1 < len && buf[pos + 1] == '\n') ++pos;
    ++pos;
    *complete = true;
    return true;
  }
};

}  // namespace

LO_API int32_t lo_csv_abi_version() { return 1; }

// ---------------------------------------------------------------------------
// Record cut: the offset just past the terminator of the last complete
// record of buf[0:len), taking at most max_records records (<= 0: no
// limit) and, where the limit did not stop it, the complete blank lines
// after it. final: the buffer ends the input, so its last record is
// complete without a terminator. -1 when no record is complete. Blank lines
// are not records.
// ---------------------------------------------------------------------------

LO_API int64_t lo_csv_cut(const char* buf, int64_t len, int64_t max_records,
                   int32_t final, int64_t* n_records) {
  Reader r{buf, len};
  int64_t cut = -1, n = 0;
  while (r.at_record()) {
    if (max_records > 0 && n >= max_records) {
      *n_records = n;
      return cut;
    }
    bool complete;
    r.record([] {}, [](char) {}, [](const char*, int64_t) {}, &complete);
    if (!complete && !final) break;
    ++n;
    cut = r.pos;
  }
  if (cut >= 0 && !(max_records > 0 && n >= max_records)) {
    // complete blank lines after the last record
    int64_t p = cut;
    while (p < len && is_newline(buf[p])) {
      if (buf[p] == '\r' && p + 1 < len && buf[p + 1] == '\n') ++p;
      ++p;
      cut = p;
    }
  }
  *n_records = n;
  return cut;
}

LO_API int32_t lo_utf8_valid(const char* buf, int64_t len, int32_t truncated_ok) {
  return utf8_valid(reinterpret_cast<const unsigned char*>(buf), len,
                    truncated_ok != 0) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Parse: every record of the buffer into one table of unescaped cells,
// row-major, cell k = data[offs[k]:offs[k + 1]].
// ---------------------------------------------------------------------------

struct LoCsv {
  int64_t rows = 0;
  int64_t cols = 0;
  int32_t status = 0;   // 0 ok, 1 ragged, 2 invalid UTF-8, 3 field too long
  int64_t bad_row = -1;   // the ragged record (0-based) and its width
  int64_t bad_width = 0;
  std::string data;
  std::vector<int64_t> offs;
};

// ncols <= 0: the width of the first record. Stops at a ragged record.
// max_records <= 0: no limit.
LO_API LoCsv* lo_csv_parse(const char* buf, int64_t len, int64_t ncols,
                    int64_t max_records) {
  auto t = new LoCsv();
  if (!utf8_valid(reinterpret_cast<const unsigned char*>(buf), len, false)) {
    t->status = 2;
    return t;
  }
  t->data.resize((size_t)len);  // unescaped text never outgrows the input
  char* out = &t->data[0];
  int64_t w = 0, field_start = 0, width = 0;
  t->offs.push_back(0);
  bool too_long = false;
  Reader r{buf, len};
  auto on_char = [&](char c) { out[w++] = c; };
  auto on_run = [&](const char* p, int64_t n) {
    std::memcpy(out + w, p, (size_t)n);
    w += n;
  };
  auto on_field = [&]() {
    if (w - field_start > kFieldLimit) too_long = true;
    t->offs.push_back(w);
    field_start = w;
    ++width;
  };
  // a ragged record stops the table, but the records after it are still
  // read for a field over the limit: csv.reader raises that while it
  // reads, before the caller's width check
  bool ragged = false;
  for (int64_t nrec = 0; r.at_record(); ++nrec) {
    if (max_records > 0 && nrec >= max_records) break;
    width = 0;
    bool complete;
    r.record(on_field, on_char, on_run, &complete);
    if (too_long) {
      t->status = 3;
      break;
    }
    if (ragged || (ncols > 0 && width != ncols)) {
      if (!ragged) {
        ragged = true;
        t->status = 1;
        t->bad_row = t->rows;
        t->bad_width = width;
      }
      t->offs.resize(t->offs.size() - width);
      w = field_start = t->offs.back();
      continue;
    }
    if (ncols <= 0) ncols = width;
    ++t->rows;
  }
  t->cols = ncols > 0 ? ncols : 0;
  t->data.resize((size_t)t->offs.back());
  return t;
}

LO_API void lo_csv_free(LoCsv* t) { delete t; }
LO_API int64_t lo_csv_rows(const LoCsv* t) { return t->rows; }
LO_API int64_t lo_csv_cols(const LoCsv* t) { return t->cols; }
LO_API int32_t lo_csv_status(const LoCsv* t) { return t->status; }
LO_API int64_t lo_csv_bad_row(const LoCsv* t) { return t->bad_row; }
LO_API int64_t lo_csv_bad_width(const LoCsv* t) { return t->bad_width; }
LO_API const char* lo_csv_data(const LoCsv* t) { return t->data.data(); }
LO_API const int64_t* lo_csv_offsets(const LoCsv* t) { return t->offs.data(); }

namespace {

struct CellText {
  const char* p;
  int64_t n;
};

inline CellText cell(const LoCsv* t, int64_t row, int64_t col) {
  const int64_t k = row * t->cols + col;
  return {t->data.data() + t->offs[k], t->offs[k + 1] - t->offs[k]};
}

inline bool plain(CellText c) {
  for (int64_t i = 0; i < c.n; ++i)
    if (!is_plain((unsigned char)c.p[i])) return false;
  return true;
}

inline bool equals(CellText c, std::string_view s) {
  return (size_t)c.n == s.size() && std::memcmp(c.p, s.data(), s.size()) == 0;
}

// pyarrow's default null spellings (native/ops.py NULLS)
bool is_null(CellText c) {
  static constexpr std::string_view kNulls[] = {
      "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
      "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan",
      "null"};
  if (c.n == 0) return true;
  if (c.n < 2 || c.n > 8) return false;
  const char c0 = c.p[0];
  if (c0 != '#' && c0 != '-' && c0 != '1' && c0 != 'N' && c0 != 'n')
    return false;
  for (const std::string_view s : kNulls)
    if (equals(c, s)) return true;
  return false;
}

// 1 true spelling, 0 false spelling, -1 neither
int bool_value(CellText c) {
  static constexpr std::string_view kTrue[] = {"1", "True", "TRUE", "true"};
  static constexpr std::string_view kFalse[] = {"0", "False", "FALSE",
                                                "false"};
  for (const std::string_view s : kTrue)
    if (equals(c, s)) return 1;
  for (const std::string_view s : kFalse)
    if (equals(c, s)) return 0;
  return -1;
}

inline void strip(CellText* c) {
  while (c->n > 0 && is_space((unsigned char)c->p[0])) {
    ++c->p;
    --c->n;
  }
  while (c->n > 0 && is_space((unsigned char)c->p[c->n - 1])) --c->n;
}

// ^\s*-?\d+\s*$ within the int64 range, on a plain cell
bool parse_int(CellText c, int64_t* out) {
  strip(&c);
  int64_t i = 0;
  bool neg = false;
  if (i < c.n && c.p[i] == '-') {
    neg = true;
    ++i;
  }
  if (i >= c.n) return false;
  for (int64_t k = i; k < c.n; ++k)
    if (c.p[k] < '0' || c.p[k] > '9') return false;
  while (i < c.n - 1 && c.p[i] == '0') ++i;
  if (c.n - i > 19) return false;
  uint64_t v = 0;
  for (; i < c.n; ++i) v = v * 10 + (uint64_t)(c.p[i] - '0');
  const uint64_t limit = neg ? (uint64_t)1 << 63 : ((uint64_t)1 << 63) - 1;
  if (v > limit) return false;
  *out = neg ? (int64_t)(0 - v) : (int64_t)v;
  return true;
}

static const double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
    1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
    1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

inline bool lower_is(const char* p, int64_t n, std::string_view word) {
  if ((size_t)n != word.size()) return false;
  for (size_t k = 0; k < word.size(); ++k) {
    char ch = p[k];
    if (ch >= 'A' && ch <= 'Z') ch = (char)(ch - 'A' + 'a');
    if (ch != word[k]) return false;
  }
  return true;
}

// Python's float() on a plain cell with no underscore (none parses here):
// surrounding
// whitespace, a sign, digits with one optional point and at least one
// digit, an optional exponent; or inf / infinity / nan in any case.
bool parse_float(CellText c, double* out) {
  strip(&c);
  if (c.n == 0) return false;
  const char* s = c.p;
  int64_t n = c.n, i = 0;
  bool neg = false;
  if (s[0] == '+' || s[0] == '-') {
    neg = s[0] == '-';
    ++i;
  }
  const char* word = s + i;
  const int64_t wn = n - i;
  if (wn > 0 && (word[0] | 0x20) == 'i' &&
      (lower_is(word, wn, "inf") || lower_is(word, wn, "infinity"))) {
    *out = neg ? -std::numeric_limits<double>::infinity()
               : std::numeric_limits<double>::infinity();
    return true;
  }
  if (wn > 0 && (word[0] | 0x20) == 'n' && lower_is(word, wn, "nan")) {
    *out = std::copysign(std::numeric_limits<double>::quiet_NaN(),
                         neg ? -1.0 : 1.0);
    return true;
  }
  uint64_t mant = 0;
  int sig = 0, frac = 0, digits = 0;
  bool exact = true;
  for (; i < n && s[i] >= '0' && s[i] <= '9'; ++i, ++digits) {
    if (mant || s[i] != '0') {
      if (++sig > 19) exact = false;
      else mant = mant * 10 + (uint64_t)(s[i] - '0');
    }
  }
  if (i < n && s[i] == '.') {
    for (++i; i < n && s[i] >= '0' && s[i] <= '9'; ++i, ++digits) {
      ++frac;
      if (mant || s[i] != '0') {
        if (++sig > 19) exact = false;
        else mant = mant * 10 + (uint64_t)(s[i] - '0');
      }
    }
  }
  if (digits == 0) return false;
  int64_t exp10 = 0;
  if (i < n && (s[i] == 'e' || s[i] == 'E')) {
    ++i;
    bool eneg = false;
    if (i < n && (s[i] == '+' || s[i] == '-')) {
      eneg = s[i] == '-';
      ++i;
    }
    if (i >= n) return false;
    for (; i < n && s[i] >= '0' && s[i] <= '9'; ++i)
      if (exp10 < 100000) exp10 = exp10 * 10 + (s[i] - '0');
    if (eneg) exp10 = -exp10;
  }
  if (i != n) return false;
  // Clinger: an exact mantissa below 2^53 times an exact power of ten is
  // one correctly rounded IEEE operation
  const int64_t p = exp10 - frac;
  if (exact && mant <= ((uint64_t)1 << 53) && p >= -22 && p <= 22) {
    double v = (double)mant;
    v = p < 0 ? v / kPow10[-p] : v * kPow10[p];
    *out = neg ? -v : v;
    return true;
  }
  std::string tmp(c.p, (size_t)c.n);
  char* end = nullptr;
  *out = std::strtod(tmp.c_str(), &end);
  return end == tmp.c_str() + tmp.size();
}

}  // namespace

// ---------------------------------------------------------------------------
// Kinds and columns
// ---------------------------------------------------------------------------

// Column j's evidence for the port's kind inference: *any_present is 1 when
// a cell is not a null spelling; first_fail[0..2] hold the row of the first
// plain, present cell that is not an int64 / bool / float64 (-1 none);
// `deferred` gets the rows of the present cells that are not plain (the
// caller's Python predicates judge them as int64 or float64; they are
// never bool). Returns the number of deferred rows.
LO_API int64_t lo_csv_infer(const LoCsv* t, int64_t j, uint8_t* any_present,
                     int64_t* first_fail, int64_t* deferred) {
  int64_t nd = 0;
  first_fail[0] = first_fail[1] = first_fail[2] = -1;
  *any_present = 0;
  for (int64_t i = 0; i < t->rows; ++i) {
    const CellText c = cell(t, i, j);
    if (is_null(c)) continue;
    *any_present = 1;
    // a cell that parses is plain: only plain bytes parse
    int64_t iv;
    double dv;
    const bool is_i = first_fail[0] < 0 && parse_int(c, &iv);
    const bool is_f = is_i || (first_fail[2] < 0 && parse_float(c, &dv));
    if (!is_f && !plain(c)) {
      deferred[nd++] = i;
      if (first_fail[1] < 0) first_fail[1] = i;
      continue;
    }
    if (first_fail[0] < 0 && !is_i) first_fail[0] = i;
    if (first_fail[1] < 0 && bool_value(c) < 0) first_fail[1] = i;
    if (first_fail[2] < 0 && !is_f) first_fail[2] = i;
  }
  return nd;
}

// Column j as `kind` (0 int64, 1 float64, 2 bool) into out (rows values)
// and mask (rows bytes, 1 where the cell is a null spelling; its value is
// 0). Returns the row of the first present cell that is not of the kind
// (-1 none); the rows of the cells before it that are not plain (int64 and
// float64 only) go to `deferred`, their count to *n_deferred, their values
// are left to the caller.
LO_API int64_t lo_csv_convert(const LoCsv* t, int64_t j, int32_t kind, void* out,
                       uint8_t* mask, int64_t* deferred,
                       int64_t* n_deferred) {
  int64_t nd = 0;
  int64_t* iout = static_cast<int64_t*>(out);
  double* fout = static_cast<double*>(out);
  uint8_t* bout = static_cast<uint8_t*>(out);
  for (int64_t i = 0; i < t->rows; ++i) {
    const CellText c = cell(t, i, j);
    const bool null = is_null(c);
    mask[i] = null ? 1 : 0;
    bool ok = true;
    if (kind == 0) {
      iout[i] = 0;
      if (!null && !parse_int(c, &iout[i])) {
        if (plain(c)) ok = false;
        else deferred[nd++] = i;
      }
    } else if (kind == 1) {
      fout[i] = 0.0;
      if (!null && !parse_float(c, &fout[i])) {
        if (plain(c)) ok = false;
        else deferred[nd++] = i;
      }
    } else {
      bout[i] = 0;
      if (!null) {
        const int b = bool_value(c);
        ok = b >= 0;
        bout[i] = b > 0 ? 1 : 0;
      }
    }
    if (!ok) {
      *n_deferred = nd;
      return i;
    }
  }
  *n_deferred = nd;
  return -1;
}

// The most code points of a cell of column j (at least 1: numpy's width
// for a column of empty strings).
LO_API int64_t lo_csv_text_width(const LoCsv* t, int64_t j) {
  int64_t width = 1;
  for (int64_t i = 0; i < t->rows; ++i) {
    const CellText c = cell(t, i, j);
    int64_t n = 0;
    for (int64_t k = 0; k < c.n; ++k)
      n += ((unsigned char)c.p[k] & 0xc0) != 0x80;
    if (n > width) width = n;
  }
  return width;
}

// Column j as numpy's fixed-width unicode: rows x width UCS4 code points,
// zero padded. mask (nullable): 1 where the cell is a null spelling.
LO_API void lo_csv_text(const LoCsv* t, int64_t j, int64_t width, uint32_t* out,
                 uint8_t* mask) {
  std::memset(out, 0, (size_t)(t->rows * width) * sizeof(uint32_t));
  for (int64_t i = 0; i < t->rows; ++i) {
    const CellText c = cell(t, i, j);
    if (mask) mask[i] = is_null(c) ? 1 : 0;
    uint32_t* row = out + i * width;
    const unsigned char* s = reinterpret_cast<const unsigned char*>(c.p);
    int64_t k = 0, o = 0;
    while (k < c.n) {
      const unsigned char b = s[k];
      uint32_t cp;
      int more;
      if (b < 0x80) { cp = b; more = 0; }
      else if (b < 0xe0) { cp = b & 0x1f; more = 1; }
      else if (b < 0xf0) { cp = b & 0x0f; more = 2; }
      else { cp = b & 0x07; more = 3; }
      for (int m = 1; m <= more; ++m) cp = (cp << 6) | (s[k + m] & 0x3f);
      k += more + 1;
      row[o++] = cp;
    }
  }
}

// ---------------------------------------------------------------------------
// Value counts (the histogram service): distinct values in the order of
// their first row, each with that row and its count. kind 0: float64,
// where every NaN is one value and -0.0 equals 0.0; kind 1: items of
// `width` bytes compared as bytes (int64, bool, fixed-width text). skip
// (nullable): rows left out (nulls).
// ---------------------------------------------------------------------------

struct LoCounts {
  std::vector<int64_t> first;
  std::vector<int64_t> counts;
};

namespace {

// counts one more of `key` (first seen at `row`); returns its slot
template <class Map, class Key>
inline int64_t bump(Map& slot, const Key& key, int64_t row, LoCounts* out) {
  auto it = slot.find(key);
  if (it == slot.end()) {
    it = slot.emplace(key, (int64_t)out->first.size()).first;
    out->first.push_back(row);
    out->counts.push_back(0);
  }
  ++out->counts[it->second];
  return it->second;
}

}  // namespace

LO_API LoCounts* lo_value_counts(const void* data, int64_t n, int64_t width,
                                 int32_t kind, const uint8_t* skip) {
  auto out = new LoCounts();
  const char* base = static_cast<const char*>(data);
  if (kind == 0 || width == 8) {
    std::unordered_map<uint64_t, int64_t> slot;
    int64_t nan_slot = -1, last_slot = -1;
    uint64_t last_key = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (skip && skip[i]) continue;
      uint64_t key;
      std::memcpy(&key, base + i * 8, 8);
      if (kind == 0) {
        double v;
        std::memcpy(&v, &key, 8);
        if (std::isnan(v)) {
          if (nan_slot < 0) {
            nan_slot = (int64_t)out->first.size();
            out->first.push_back(i);
            out->counts.push_back(0);
          }
          ++out->counts[nan_slot];
          continue;
        }
        if (v == 0.0) key = 0;
      }
      // runs of one value skip the hash
      if (last_slot >= 0 && key == last_key) {
        ++out->counts[last_slot];
        continue;
      }
      last_slot = bump(slot, key, i, out);
      last_key = key;
    }
  } else if (width == 1) {
    int64_t slot[256];
    for (int k = 0; k < 256; ++k) slot[k] = -1;
    for (int64_t i = 0; i < n; ++i) {
      if (skip && skip[i]) continue;
      const unsigned char key = (unsigned char)base[i];
      if (slot[key] < 0) {
        slot[key] = (int64_t)out->first.size();
        out->first.push_back(i);
        out->counts.push_back(0);
      }
      ++out->counts[slot[key]];
    }
  } else {
    std::unordered_map<std::string_view, int64_t> slot;
    for (int64_t i = 0; i < n; ++i) {
      if (skip && skip[i]) continue;
      bump(slot, std::string_view(base + i * width, (size_t)width), i, out);
    }
  }
  return out;
}

LO_API void lo_counts_free(LoCounts* c) { delete c; }
LO_API int64_t lo_counts_n(const LoCounts* c) {
  return (int64_t)c->first.size();
}
LO_API const int64_t* lo_counts_first(const LoCounts* c) {
  return c->first.data();
}
LO_API const int64_t* lo_counts_counts(const LoCounts* c) {
  return c->counts.data();
}

// ---------------------------------------------------------------------------
// Predicate filter: one comparison ANDed into a 0/1 mask, as Python
// compares a row's value with a JSON operand. op: 0 ==, 1 !=, 2 <, 3 <=,
// 4 >, 5 >=. col_kind 0: int64 (compared as int64, exactly, never staged
// through float64), 1: float64. The operand is int64 iv (operand_is_int)
// or double dv. A null row (nulls, nullable) matches != only; NaN matches
// != only.
// ---------------------------------------------------------------------------

namespace {

// -1, 0, 1 for a < b, a == b, a > b; 2 unordered (NaN)
inline int cmp_ii(int64_t a, int64_t b) { return (a > b) - (a < b); }

inline int cmp_dd(double a, double b) {
  if (std::isnan(a) || std::isnan(b)) return 2;
  return (a > b) - (a < b);
}

// exact int64 against double, as Python compares int with float
inline int cmp_id(int64_t a, double b) {
  if (std::isnan(b)) return 2;
  if (b >= 9223372036854775808.0) return -1;
  if (b < -9223372036854775808.0) return 1;
  const double tb = std::trunc(b);
  const int64_t ib = (int64_t)tb;
  if (a != ib) return a < ib ? -1 : 1;
  const double f = b - tb;
  return f > 0 ? -1 : (f < 0 ? 1 : 0);
}

inline bool holds(int c, int32_t op) {
  switch (op) {
    case 0: return c == 0;
    case 1: return c != 0;
    case 2: return c == -1;
    case 3: return c == -1 || c == 0;
    case 4: return c == 1;
    default: return c == 1 || c == 0;
  }
}

}  // namespace

LO_API void lo_filter(const void* col, int64_t n, int32_t col_kind,
               const uint8_t* nulls, int32_t op, int32_t operand_is_int,
               int64_t iv, double dv, uint8_t* mask) {
  const int64_t* ic = static_cast<const int64_t*>(col);
  const double* fc = static_cast<const double*>(col);
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    if (nulls && nulls[i]) {
      mask[i] = op == 1;
      continue;
    }
    int c;
    if (col_kind == 0) c = operand_is_int ? cmp_ii(ic[i], iv)
                                          : cmp_id(ic[i], dv);
    else c = operand_is_int ? (std::isnan(fc[i]) ? 2 : -cmp_id(iv, fc[i]))
                            : cmp_dd(fc[i], dv);
    mask[i] = holds(c, op);
  }
}

// Fixed-width text (rows x width UCS4 code points) against a needle of
// needle_len code points: mask &= (row == needle) != negate. A null row
// never equals.
LO_API void lo_filter_text_eq(const uint32_t* col, int64_t n, int64_t width,
                       const uint8_t* nulls, const uint32_t* needle,
                       int64_t needle_len, int32_t negate, uint8_t* mask) {
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    bool eq = false;
    if (!(nulls && nulls[i]) && needle_len <= width) {
      const uint32_t* row = col + i * width;
      eq = std::memcmp(row, needle, (size_t)needle_len * 4) == 0;
      for (int64_t k = needle_len; eq && k < width; ++k) eq = row[k] == 0;
    }
    mask[i] = eq != (negate != 0);
  }
}

// ---------------------------------------------------------------------------
// Batch gather: rows of a C-contiguous matrix by index (the host feed's
// shuffled minibatch); the caller checks every index is in range.
// ---------------------------------------------------------------------------

LO_API void lo_gather_rows(const char* src, int64_t row_bytes, const int64_t* idx,
                    int64_t nidx, char* dst) {
  for (int64_t i = 0; i < nidx; ++i)
    std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                (size_t)row_bytes);
}

