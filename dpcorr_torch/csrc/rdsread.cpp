// Native RDS reader: the port's data-loader fast path (host code).
//
// Parses R serialization format (XDR v2/v3, the `saveRDS` output consumed at
// real-data-sims.R:13 in the reference) from an already decompressed buffer
// into columnar buffers, with the same output contract as the portable
// Python reader in dpcorr_torch/io/rds_py.py:
//   - numeric/logical/factor columns -> double arrays, NA -> NaN
//   - string columns -> one blob of '\0'-terminated records, empty for NA,
//     + offsets (-1 = NA)
//   - factor levels, haven value-labels and variable labels preserved.
//
// Counterpart of native/rdsread.cpp, with two changes: the caller hands in
// the decompressed stream (Python's gzip, bz2 and lzma modules decompress
// it, so all three of saveRDS's compressions read natively and nothing
// links zlib), and the deferred_string ALTREP class expands as the Python
// reader expands it. Exposed as a C API (loaded with ctypes from
// dpcorr_torch/io/rds.py); no Python.h dependency, so it builds with
// nothing but a C++17 compiler (dpcorr_torch/ops/_build.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// ----- SEXP type codes ------------------------------------------------------
enum {
  NILSXP = 0, SYMSXP = 1, LISTSXP = 2, LANGSXP = 6, CHARSXP = 9,
  LGLSXP = 10, INTSXP = 13, REALSXP = 14, CPLXSXP = 15, STRSXP = 16,
  VECSXP = 19, EXPRSXP = 20, RAWSXP = 24,
  ALTREP_SXP = 238, ATTRLISTSXP = 239, ATTRLANGSXP = 240,
  BASEENV_SXP = 241, EMPTYENV_SXP = 242, PERSISTSXP = 247,
  PACKAGESXP = 248, NAMESPACESXP = 249, GLOBALENV_SXP = 253,
  NILVALUE_SXP = 254, REFSXP = 255,
};

constexpr int32_t kNaInt = INT32_MIN;
// R's NA_real_ is itself a NaN (payload 1954), so REALSXP bytes pass through
// unchanged; only integer/logical NA needs explicit NaN mapping.

// ----- generic SEXP tree ----------------------------------------------------
struct Sexp;
using SexpPtr = std::shared_ptr<Sexp>;

struct Sexp {
  int type = NILSXP;
  std::vector<double> reals;                   // REALSXP; INT/LGL promoted
  std::vector<std::string> strs;               // STRSXP values
  std::vector<uint8_t> str_na;                 // STRSXP NA mask
  std::vector<SexpPtr> vec;                    // VECSXP elements
  std::string sym;                             // SYMSXP name
  std::vector<std::pair<std::string, SexpPtr>> attrs;

  const Sexp* attr(const char* name) const {
    for (const auto& kv : attrs)
      if (kv.first == name) return kv.second.get();
    return nullptr;
  }
  bool has_class(const char* cls) const {
    const Sexp* c = attr("class");
    if (!c) return false;
    for (const auto& s : c->strs)
      if (s == cls) return true;
    return false;
  }
};

// ----- stream reader --------------------------------------------------------
class Reader {
 public:
  Reader(const uint8_t* buf, size_t len) : buf_(buf), len_(len) {}

  void header() {
    if (len_ < 2 || buf_[0] != 'X' || buf_[1] != '\n')
      throw std::runtime_error("unsupported RDS encoding (need XDR 'X\\n')");
    pos_ = 2;
    int version = i32();
    i32();  // writer version
    i32();  // min reader version
    if (version >= 3) {
      int n = i32();
      take(n);  // native encoding name; payload CHARSXPs carry their own flag
    } else if (version != 2) {
      throw std::runtime_error("unsupported RDS version");
    }
  }

  SexpPtr item() {
    int32_t flags = i32();
    int type = flags & 0xFF;
    bool has_attr = flags & 0x200;
    bool has_tag = flags & 0x400;

    switch (type) {
      case NILVALUE_SXP:
      case NILSXP:
      case GLOBALENV_SXP:
      case EMPTYENV_SXP:
      case BASEENV_SXP:
        return mk(NILSXP);
      case REFSXP: {
        int idx = flags >> 8;
        if (idx == 0) idx = i32();
        if (idx < 1 || (size_t)idx > refs_.size())
          throw std::runtime_error("bad RDS reference index");
        return refs_[idx - 1];
      }
      case SYMSXP: {
        SexpPtr chr = item();
        SexpPtr s = mk(SYMSXP);
        s->sym = chr->strs.empty() ? "" : chr->strs[0];
        refs_.push_back(s);
        return s;
      }
      case NAMESPACESXP:
      case PACKAGESXP:
      case PERSISTSXP: {
        SexpPtr s = mk(type);
        i32();  // InStringVec compatibility zero
        int n = i32();
        for (int j = 0; j < n; ++j) item();  // name strings, discarded
        refs_.push_back(s);
        return s;
      }
      case LISTSXP:
      case LANGSXP:
      case ATTRLISTSXP:
      case ATTRLANGSXP:
        return pairlist(has_attr, has_tag);
      case ALTREP_SXP:
        return altrep();
      case CHARSXP: {
        int32_t n = i32();
        SexpPtr s = mk(STRSXP);
        if (n == -1) {
          s->strs.emplace_back();
          s->str_na.push_back(1);
        } else {
          const uint8_t* p = take(n);
          s->strs.emplace_back(reinterpret_cast<const char*>(p), (size_t)n);
          s->str_na.push_back(0);
        }
        return s;
      }
      default:
        break;
    }

    SexpPtr s = mk(type);
    switch (type) {
      case LGLSXP:
      case INTSXP: {
        int64_t n = length();
        s->reals.resize(n);
        for (int64_t j = 0; j < n; ++j) {
          int32_t v = i32();
          s->reals[j] = (v == kNaInt) ? std::nan("") : (double)v;
        }
        break;
      }
      case REALSXP: {
        int64_t n = length();
        s->reals.resize(n);
        for (int64_t j = 0; j < n; ++j) s->reals[j] = f64();
        break;
      }
      case CPLXSXP: {
        int64_t n = length();
        s->reals.resize(n);  // keep the real part only; unused by tables
        for (int64_t j = 0; j < n; ++j) { s->reals[j] = f64(); f64(); }
        break;
      }
      case RAWSXP: {
        int64_t n = length();
        take(n);
        break;
      }
      case STRSXP: {
        int64_t n = length();
        s->strs.reserve(n);
        s->str_na.reserve(n);
        for (int64_t j = 0; j < n; ++j) {
          // a CHARSXP record is read in place (no node per element: the
          // panel's columns hold 2.2 M strings); anything else goes
          // through item()
          if ((i32() & 0xFF) == CHARSXP) {
            int32_t len = i32();
            if (len == -1) {
              s->strs.emplace_back();
              s->str_na.push_back(1);
            } else {
              const uint8_t* p = take(len);
              s->strs.emplace_back(reinterpret_cast<const char*>(p),
                                   (size_t)len);
              s->str_na.push_back(0);
            }
            continue;
          }
          pos_ -= 4;
          SexpPtr c = item();
          s->strs.push_back(std::move(c->strs[0]));
          s->str_na.push_back(c->str_na[0]);
        }
        break;
      }
      case VECSXP:
      case EXPRSXP: {
        int64_t n = length();
        s->vec.reserve(n);
        for (int64_t j = 0; j < n; ++j) s->vec.push_back(item());
        break;
      }
      default:
        throw std::runtime_error("unsupported SEXP type " +
                                 std::to_string(type));
    }
    if (has_attr) read_attrs(*s);
    return s;
  }

 private:
  SexpPtr mk(int type) {
    auto s = std::make_shared<Sexp>();
    s->type = type;
    return s;
  }

  const uint8_t* take(int64_t n) {
    if (pos_ + (size_t)n > len_) throw std::runtime_error("truncated RDS");
    const uint8_t* p = buf_ + pos_;
    pos_ += n;
    return p;
  }
  int32_t i32() {
    const uint8_t* p = take(4);
    return (int32_t)(((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                     ((uint32_t)p[2] << 8) | (uint32_t)p[3]);
  }
  double f64() {
    const uint8_t* p = take(8);
    uint64_t b = 0;
    for (int j = 0; j < 8; ++j) b = (b << 8) | p[j];
    double d;
    std::memcpy(&d, &b, 8);
    return d;
  }
  int64_t length() {
    int32_t n = i32();
    if (n == -1) {
      int64_t hi = i32(), lo = (uint32_t)i32();
      return (hi << 32) + lo;
    }
    return n;
  }

  void read_attrs(Sexp& s) {
    SexpPtr plist = item();
    if (plist->type == LISTSXP) s.attrs = std::move(plist->attrs);
  }

  SexpPtr pairlist(bool has_attr, bool has_tag) {
    SexpPtr s = mk(LISTSXP);
    if (has_attr) read_attrs(*s);  // attrs on the pairlist itself: rare, drop
    while (true) {
      std::string tag;
      if (has_tag) tag = item()->sym;
      s->attrs.emplace_back(std::move(tag), item());
      int32_t flags = i32();
      int nxt = flags & 0xFF;
      if (nxt == NILVALUE_SXP || nxt == NILSXP) break;
      if (nxt != LISTSXP && nxt != LANGSXP && nxt != ATTRLISTSXP &&
          nxt != ATTRLANGSXP) {
        pos_ -= 4;
        s->attrs.emplace_back(std::string(), item());
        break;
      }
      if (flags & 0x200) { Sexp scratch; read_attrs(scratch); }
      has_tag = flags & 0x400;
    }
    return s;
  }

  SexpPtr altrep() {
    SexpPtr info = item();
    SexpPtr state = item();
    SexpPtr attr = item();
    std::string cls =
        (info->type == LISTSXP && !info->attrs.empty())
            ? info->attrs[0].second->sym
            : "";
    SexpPtr out;
    if (cls == "compact_intseq" || cls == "compact_realseq") {
      double n = state->reals.at(0), start = state->reals.at(1),
             step = state->reals.at(2);
      out = mk(cls == "compact_intseq" ? INTSXP : REALSXP);
      out->reals.resize((int64_t)n);
      for (int64_t j = 0; j < (int64_t)n; ++j)
        out->reals[j] = start + step * (double)j;
    } else if (cls.rfind("wrap_", 0) == 0) {
      // wrapper state is CONS(wrapped, metadata) — a pairlist; a VECSXP
      // form also exists
      if (state->type == LISTSXP && !state->attrs.empty())
        out = state->attrs[0].second;
      else if (state->type == VECSXP && !state->vec.empty())
        out = state->vec[0];
      else
        out = state;
    } else if (cls == "deferred_string") {
      // state is CONS(numeric vector, info): each number as the Python
      // reader prints it (dpcorr_torch/io/rds_py.py, _r_num_str)
      SexpPtr src = state;
      if (state->type == LISTSXP && !state->attrs.empty())
        src = state->attrs[0].second;
      else if (state->type == VECSXP && !state->vec.empty())
        src = state->vec[0];
      bool ints = src->type == INTSXP || src->type == LGLSXP;
      out = mk(STRSXP);
      out->strs.reserve(src->reals.size());
      for (double v : src->reals) {
        out->strs.push_back(ints && std::isnan(v) ? std::to_string(kNaInt)
                                                  : number_string(v));
        out->str_na.push_back(0);
      }
    } else {
      throw std::runtime_error("unsupported ALTREP class '" + cls + "'");
    }
    if (attr->type == LISTSXP) out->attrs = std::move(attr->attrs);
    return out;
  }

  // Python's str() of a float: an integral value as an integer, else the
  // shortest digits that round-trip, in fixed notation unless the
  // decimal exponent is below -4 ("nan", "inf" and "-inf" as spelt).
  static std::string number_string(double v) {
    if (std::isnan(v)) return "nan";
    if (std::isinf(v)) return v < 0 ? "-inf" : "inf";
    if (v == std::floor(v)) {
      char buf[400];
      std::snprintf(buf, sizeof(buf), "%.0f", v == 0.0 ? 0.0 : v);
      return buf;
    }
    char buf[64];
    for (int p = 1; p <= 17; ++p) {
      std::snprintf(buf, sizeof(buf), "%.*e", p - 1, v);
      if (std::strtod(buf, nullptr) == v) break;
    }
    std::string s(buf);
    size_t e = s.find('e');
    int exp10 = std::atoi(s.c_str() + e + 1);
    std::string digits;
    bool neg = s[0] == '-';
    for (size_t j = neg ? 1 : 0; j < e; ++j)
      if (s[j] != '.') digits.push_back(s[j]);
    while (digits.size() > 1 && digits.back() == '0') digits.pop_back();
    std::string out = neg ? "-" : "";
    if (exp10 < -4) {
      out += digits.substr(0, 1);
      if (digits.size() > 1) out += "." + digits.substr(1);
      char ebuf[16];
      std::snprintf(ebuf, sizeof(ebuf), "e-%02d", -exp10);
      return out + ebuf;
    }
    int decpt = exp10 + 1;  // digits before the point
    if (decpt <= 0) return out + "0." + std::string(-decpt, '0') + digits;
    return out + digits.substr(0, decpt) + "." + digits.substr(decpt);
  }

  const uint8_t* buf_;
  size_t len_;
  size_t pos_ = 0;
  std::vector<SexpPtr> refs_;
};

// ----- columnar table -------------------------------------------------------
struct Column {
  std::string name;
  std::string kind;  // double | integer | logical | string | factor
  std::vector<double> num;          // numeric values / factor codes
  std::string str_blob;             // '\0'-joined strings
  std::vector<int64_t> str_off;     // offsets into blob, -1 = NA
  std::vector<std::string> levels;
  std::vector<std::string> label_names;
  std::vector<double> label_values;
  std::string var_label;
  bool has_var_label = false;
};

struct Table {
  int64_t nrows = 0;
  std::vector<Column> cols;
  std::string err;
};

Column make_column(const std::string& name, const SexpPtr& c) {
  Column col;
  col.name = name;
  if (const Sexp* lab = c->attr("label")) {
    if (!lab->strs.empty()) {
      col.var_label = lab->strs[0];
      col.has_var_label = true;
    }
  }
  if (const Sexp* labels = c->attr("labels")) {
    if (const Sexp* nm = labels->attr("names"))
      col.label_names = nm->strs;
    col.label_values = labels->reals;
  }
  if (c->has_class("factor")) {
    col.kind = "factor";
    col.num = c->reals;
    if (const Sexp* lv = c->attr("levels")) col.levels = lv->strs;
    return col;
  }
  switch (c->type) {
    case REALSXP: col.kind = "double"; col.num = c->reals; return col;
    case INTSXP: col.kind = "integer"; col.num = c->reals; return col;
    case LGLSXP: col.kind = "logical"; col.num = c->reals; return col;
    case STRSXP: {
      col.kind = "string";
      col.str_off.reserve(c->strs.size());
      // one NUL-terminated record per element, empty for NA, so the
      // blob splits into the column as it stands
      for (size_t j = 0; j < c->strs.size(); ++j) {
        col.str_off.push_back(c->str_na[j] ? -1
                                           : (int64_t)col.str_blob.size());
        col.str_blob += c->strs[j];
        col.str_blob.push_back('\0');
      }
      return col;
    }
    default:
      throw std::runtime_error("column '" + name + "': unsupported type " +
                               std::to_string(c->type));
  }
}

}  // namespace

// ----- C API ----------------------------------------------------------------
extern "C" {

// Parse a decompressed RDS stream of `len` bytes; nullptr with a message in
// errbuf on failure.
void* rds_read_buffer(const uint8_t* buf, int64_t len, char* errbuf,
                      int errlen) {
  auto t = std::make_unique<Table>();
  try {
    Reader rd(buf, (size_t)len);
    rd.header();
    SexpPtr root = rd.item();
    if (root->type != VECSXP || !root->has_class("data.frame"))
      throw std::runtime_error("not a data.frame");
    const Sexp* names = root->attr("names");
    if (!names || names->strs.size() != root->vec.size())
      throw std::runtime_error("malformed data.frame names");
    for (size_t j = 0; j < root->vec.size(); ++j)
      t->cols.push_back(make_column(names->strs[j], root->vec[j]));
    if (!t->cols.empty()) {
      const Column& c0 = t->cols[0];
      t->nrows = c0.kind == "string" ? (int64_t)c0.str_off.size()
                                     : (int64_t)c0.num.size();
    }
    return t.release();
  } catch (const std::exception& e) {
    if (errbuf && errlen > 0) {
      std::strncpy(errbuf, e.what(), errlen - 1);
      errbuf[errlen - 1] = '\0';
    }
    return nullptr;
  }
}

int rds_table_ncols(void* h) { return (int)((Table*)h)->cols.size(); }
int64_t rds_table_nrows(void* h) { return ((Table*)h)->nrows; }

const char* rds_col_name(void* h, int j) {
  return ((Table*)h)->cols[j].name.c_str();
}
const char* rds_col_kind(void* h, int j) {
  return ((Table*)h)->cols[j].kind.c_str();
}
const double* rds_col_num(void* h, int j) {
  return ((Table*)h)->cols[j].num.data();
}
int64_t rds_col_num_len(void* h, int j) {
  return (int64_t)((Table*)h)->cols[j].num.size();
}
const char* rds_col_str_blob(void* h, int j, int64_t* blob_len) {
  const Column& c = ((Table*)h)->cols[j];
  if (blob_len) *blob_len = (int64_t)c.str_blob.size();
  return c.str_blob.data();
}
const int64_t* rds_col_str_offsets(void* h, int j, int64_t* n) {
  const Column& c = ((Table*)h)->cols[j];
  if (n) *n = (int64_t)c.str_off.size();
  return c.str_off.data();
}
int rds_col_nlevels(void* h, int j) {
  return (int)((Table*)h)->cols[j].levels.size();
}
const char* rds_col_level(void* h, int j, int k) {
  return ((Table*)h)->cols[j].levels[k].c_str();
}
int rds_col_nlabels(void* h, int j) {
  return (int)((Table*)h)->cols[j].label_values.size();
}
const char* rds_col_label_name(void* h, int j, int k) {
  const Column& c = ((Table*)h)->cols[j];
  return k < (int)c.label_names.size() ? c.label_names[k].c_str() : "";
}
double rds_col_label_value(void* h, int j, int k) {
  return ((Table*)h)->cols[j].label_values[k];
}
const char* rds_col_var_label(void* h, int j) {
  const Column& c = ((Table*)h)->cols[j];
  return c.has_var_label ? c.var_label.c_str() : nullptr;
}
void rds_table_free(void* h) { delete (Table*)h; }

}  // extern "C"
