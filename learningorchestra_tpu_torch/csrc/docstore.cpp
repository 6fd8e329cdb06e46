// lodstore — embedded WAL-backed document store + CSV ingest engine.
//
// The port's own copy of native/src/docstore.cpp (the port's image carries
// only learningorchestra_tpu_torch/), built with g++ by
// learningorchestra_tpu_torch/native/__init__.py; the C ABI is unchanged.
//
// Native system-of-record for learningorchestra_tpu, playing the role
// MongoDB (a C++ server) plays in the reference deployment
// (reference: docker-compose.yml:42-90): every artifact is a collection
// of JSON documents whose _id=0 document is the metadata record.
//
// On-disk format is IDENTICAL to the pure-Python DocumentStore
// (learningorchestra_tpu/store/document_store.py): one JSONL write-ahead
// log per collection, each line one of
//   {"op":"i","d":{...,"_id":N}}     insert
//   {"op":"u","id":N,"d":{...}}      top-level field merge
//   {"op":"d","id":N}                delete
//   {"op":"n","v":N}                 next-id watermark (compaction)
// so the two backends are interchangeable on the same directory.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
// All returned buffers are malloc'd and must be released with lods_free.

#include <algorithm>
#include <cctype>
#include <charconv>
#include <cmath>
#include <cerrno>
#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dirent.h>
#include <fcntl.h>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

thread_local std::string g_error;

void set_error(const std::string &msg) { g_error = msg; }

// ---------------------------------------------------------------------------
// Minimal JSON span scanner: enough to find top-level keys/values of an
// object, merge two objects at the top level, and validate value spans.
// Documents are stored as raw JSON text; we never build a DOM.
// ---------------------------------------------------------------------------

size_t skip_ws(const char *s, size_t i, size_t n) {
  while (i < n && (s[i] == ' ' || s[i] == '\t' || s[i] == '\n' || s[i] == '\r'))
    i++;
  return i;
}

// Returns index one past the end of the JSON value starting at i, or
// std::string::npos on malformed input.
size_t skip_value(const char *s, size_t i, size_t n) {
  i = skip_ws(s, i, n);
  if (i >= n) return std::string::npos;
  char c = s[i];
  if (c == '"') {
    i++;
    while (i < n) {
      if (s[i] == '\\') {
        i += 2;
      } else if (s[i] == '"') {
        return i + 1;
      } else {
        i++;
      }
    }
    return std::string::npos;
  }
  if (c == '{' || c == '[') {
    char open = c, close = (c == '{') ? '}' : ']';
    int depth = 0;
    while (i < n) {
      if (s[i] == '"') {
        size_t end = skip_value(s, i, n);
        if (end == std::string::npos) return std::string::npos;
        i = end;
        continue;
      }
      if (s[i] == open) depth++;
      if (s[i] == close) {
        depth--;
        if (depth == 0) return i + 1;
      }
      i++;
    }
    return std::string::npos;
  }
  // number / true / false / null
  size_t start = i;
  while (i < n && s[i] != ',' && s[i] != '}' && s[i] != ']' && s[i] != ' ' &&
         s[i] != '\t' && s[i] != '\n' && s[i] != '\r')
    i++;
  return (i > start) ? i : std::string::npos;
}

struct KV {
  std::string key;      // decoded enough for comparison (raw inner text)
  std::string raw_val;  // raw JSON value text
};

// Parse the top-level pairs of a JSON object into (key, raw value) pairs.
// Keys are returned as their raw string contents (escapes left intact —
// both sides of any comparison come through this same function).
bool parse_object(const std::string &text, std::vector<KV> &out) {
  const char *s = text.data();
  size_t n = text.size();
  size_t i = skip_ws(s, 0, n);
  if (i >= n || s[i] != '{') return false;
  i = skip_ws(s, i + 1, n);
  if (i < n && s[i] == '}') return true;  // empty object
  while (i < n) {
    if (s[i] != '"') return false;
    size_t key_end = skip_value(s, i, n);
    if (key_end == std::string::npos) return false;
    std::string key = text.substr(i + 1, key_end - i - 2);
    i = skip_ws(s, key_end, n);
    if (i >= n || s[i] != ':') return false;
    i = skip_ws(s, i + 1, n);
    size_t val_end = skip_value(s, i, n);
    if (val_end == std::string::npos) return false;
    out.push_back({std::move(key), text.substr(i, val_end - i)});
    i = skip_ws(s, val_end, n);
    if (i < n && s[i] == ',') {
      i = skip_ws(s, i + 1, n);
      continue;
    }
    if (i < n && s[i] == '}') return true;
    return false;
  }
  return false;
}

std::string build_object(const std::vector<KV> &pairs) {
  std::string out = "{";
  for (size_t i = 0; i < pairs.size(); i++) {
    if (i) out += ",";
    out += '"';
    out += pairs[i].key;
    out += "\":";
    out += pairs[i].raw_val;
  }
  out += "}";
  return out;
}

// doc.update(fields) at the top level, Python-dict style; "_id" in fields
// is ignored (the store owns identity).
std::string merge_objects(const std::string &base, const std::string &fields) {
  std::vector<KV> b, f;
  if (!parse_object(base, b)) return base;
  if (!parse_object(fields, f)) return base;
  for (auto &kv : f) {
    if (kv.key == "_id") continue;
    bool replaced = false;
    for (auto &existing : b) {
      if (existing.key == kv.key) {
        existing.raw_val = kv.raw_val;
        replaced = true;
        break;
      }
    }
    if (!replaced) b.push_back(kv);
  }
  return build_object(b);
}

// Find a top-level field's raw value; returns false if absent.
bool get_field(const std::string &doc, const char *field, std::string &out) {
  std::vector<KV> pairs;
  if (!parse_object(doc, pairs)) return false;
  for (auto &kv : pairs) {
    if (kv.key == field) {
      out = kv.raw_val;
      return true;
    }
  }
  return false;
}

// Inject "_id":N into a doc that does not carry one (replace if present).
std::string with_id(const std::string &doc, long long id) {
  std::vector<KV> pairs;
  char idbuf[32];
  snprintf(idbuf, sizeof idbuf, "%lld", id);
  if (!parse_object(doc, pairs)) return doc;
  for (auto &kv : pairs) {
    if (kv.key == "_id") {
      kv.raw_val = idbuf;
      return build_object(pairs);
    }
  }
  pairs.push_back({"_id", idbuf});
  return build_object(pairs);
}

// ---------------------------------------------------------------------------
// Collection + store
// ---------------------------------------------------------------------------

bool valid_name(const std::string &name) {
  if (name.empty()) return false;
  auto word = [](char c) {
    return std::isalnum(static_cast<unsigned char>(c)) || c == '_';
  };
  if (!word(name[0])) return false;
  for (char c : name)
    if (!word(c) && c != '.' && c != '-') return false;
  return true;
}

struct Collection {
  std::string path;
  bool durable;
  std::mutex mu;
  std::map<long long, std::string> docs;  // id -> raw JSON doc (with _id)
  long long next_id = 0;
  FILE *fh = nullptr;

  ~Collection() {
    if (fh) fclose(fh);
  }

  bool replay() {
    FILE *in = fopen(path.c_str(), "r");
    if (!in) return true;  // nothing to replay
    long long max_seen = -1;
    std::string line;
    char buf[1 << 16];
    std::string pending;
    // Torn-tail recovery (same contract as the Python backend): a
    // crash mid-append leaves at most one partial record at the END.
    // Replay applies records up to the first invalid one, then (a) if
    // any VALID record follows the damage, refuses to open — that is
    // mid-file corruption, not a crash artifact; (b) otherwise
    // truncates to the last good record so the next append starts a
    // clean line instead of gluing onto partial bytes.
    long good_end = 0;
    bool torn = false, damaged = false;
    while (fgets(buf, sizeof buf, in)) {
      pending += buf;
      if (pending.empty() || pending.back() != '\n') continue;  // long line
      line.swap(pending);
      pending.clear();
      long line_end = ftell(in);
      while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
        line.pop_back();
      if (line.empty()) {
        // Inside a torn region a blank line must NOT advance good_end
        // — truncation would then keep the garbage bytes before it,
        // and the next append would glue onto them.
        if (!torn) good_end = line_end;
        continue;
      }
      std::vector<KV> op;
      if (!parse_object(line, op)) {
        if (torn) {
          continue;  // still scanning the damaged region
        }
        torn = true;
        continue;
      }
      std::string kind, d, idv, v;
      for (auto &kv : op) {
        if (kv.key == "op") kind = kv.raw_val;
        else if (kv.key == "d") d = kv.raw_val;
        else if (kv.key == "id") idv = kv.raw_val;
        else if (kv.key == "v") v = kv.raw_val;
      }
      if (torn) {
        // A parseable record AFTER invalid bytes: mid-file damage.
        if (!kind.empty()) { damaged = true; break; }
        continue;
      }
      if (kind == "\"i\"") {
        std::string idraw;
        if (!get_field(d, "_id", idraw)) continue;
        long long id = strtoll(idraw.c_str(), nullptr, 10);
        docs[id] = d;
        if (id > max_seen) max_seen = id;
      } else if (kind == "\"u\"") {
        long long id = strtoll(idv.c_str(), nullptr, 10);
        auto it = docs.find(id);
        if (it != docs.end()) it->second = merge_objects(it->second, d);
      } else if (kind == "\"d\"") {
        docs.erase(strtoll(idv.c_str(), nullptr, 10));
      } else if (kind == "\"n\"") {
        long long nv = strtoll(v.c_str(), nullptr, 10);
        if (nv - 1 > max_seen) max_seen = nv - 1;
      }
      good_end = line_end;
    }
    if (!pending.empty()) torn = true;  // unterminated tail bytes
    fclose(in);
    if (damaged) {
      set_error("corrupt WAL " + path +
                ": invalid record followed by valid records "
                "(mid-file damage), refusing to open");
      return false;
    }
    if (torn) {
      if (truncate(path.c_str(), good_end) != 0) {
        set_error("cannot truncate torn WAL tail of " + path + ": " +
                  strerror(errno));
        return false;
      }
    }
    next_id = max_seen + 1;
    return true;
  }

  bool open_log() {
    fh = fopen(path.c_str(), "a");
    if (!fh) {
      set_error("cannot open WAL " + path + ": " + strerror(errno));
      return false;
    }
    return true;
  }

  void append(const std::string &line) {
    if (!fh) return;  // collection dropped while an op held its pointer
    fwrite(line.data(), 1, line.size(), fh);
    fputc('\n', fh);
    fflush(fh);
    if (durable) fsync(fileno(fh));
  }
};

struct Store {
  std::string root;
  bool durable;
  std::mutex mu;
  // shared_ptr: lods_drop may race an op that already fetched the
  // collection — it must stay alive until the last holder releases it.
  std::unordered_map<std::string, std::shared_ptr<Collection>> colls;

  std::shared_ptr<Collection> get(const std::string &name, bool create) {
    std::lock_guard<std::mutex> lock(mu);
    auto it = colls.find(name);
    if (it != colls.end()) return it->second;
    if (!create) {
      set_error("no such collection: " + name);
      return nullptr;
    }
    if (!valid_name(name)) {
      set_error("invalid collection name: " + name);
      return nullptr;
    }
    auto coll = std::make_shared<Collection>();
    coll->path = root + "/" + name + ".wal";
    coll->durable = durable;
    if (!coll->replay()) return nullptr;  // mid-file corruption
    if (!coll->open_log()) return nullptr;
    colls.emplace(name, coll);
    return coll;
  }
};

std::mutex g_handles_mu;
// shared_ptr: lods_close may race an in-flight op on another thread that
// already fetched the store — the op's copy keeps the Store alive until
// it returns (same pattern as Collection handles above).
std::vector<std::shared_ptr<Store>> g_handles;

std::shared_ptr<Store> store_for(int64_t h) {
  std::lock_guard<std::mutex> lock(g_handles_mu);
  if (h < 0 || h >= (int64_t)g_handles.size() || !g_handles[h]) {
    set_error("invalid store handle");
    return nullptr;
  }
  return g_handles[h];
}

char *dup_buffer(const std::string &s, int64_t *out_len) {
  char *buf = (char *)malloc(s.size() + 1);
  memcpy(buf, s.data(), s.size());
  buf[s.size()] = 0;
  if (out_len) *out_len = (int64_t)s.size();
  return buf;
}

// ---------------------------------------------------------------------------
// CSV parsing (RFC 4180: quoted fields, "" escapes, embedded newlines)
// ---------------------------------------------------------------------------

void json_escape(const std::string &in, std::string &out) {
  out += '"';
  for (unsigned char c : in) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char esc[8];
          snprintf(esc, sizeof esc, "\\u%04x", c);
          out += esc;
        } else {
          out += (char)c;
        }
    }
  }
  out += '"';
}

// Shortest float formatting that round-trips (json.dumps parity-ish).
void format_double(double v, std::string &out) {
  char buf[40];
  for (int prec = 15; prec <= 17; prec++) {
    snprintf(buf, sizeof buf, "%.*g", prec, v);
    if (strtod(buf, nullptr) == v) break;
  }
  out += buf;
}

// Append the inferred-JSON form of a CSV cell.
// ONE whitespace set for every ingest-parity path (Python str.strip's
// ASCII subset): infer_value's empty/trailing checks and the chunk
// parser's cell trim must use the same predicate or the engines'
// semantics drift (the backends-interchangeable contract,
// services/dataset.py::_infer).
inline bool is_ascii_ws(char ch) {
  return ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r' ||
         ch == '\v' || ch == '\f';
}

void infer_value(const std::string &cell, std::string &out) {
  // Whitespace-only counts as empty → null, matching the Python
  // path's _infer (services/dataset.py) and the numeric chunk
  // parser's trim: a cell of spaces is an empty cell, not a string.
  bool all_ws = true;
  for (char ch : cell) {
    if (!is_ascii_ws(ch)) {
      all_ws = false;
      break;
    }
  }
  if (all_ws) {
    out += "null";
    return;
  }
  const char *s = cell.c_str();
  char *end = nullptr;
  errno = 0;
  long long iv = strtoll(s, &end, 10);
  if (errno == 0 && end != s) {
    const char *p = end;
    while (is_ascii_ws(*p)) p++;
    if (*p == 0) {  // fully consumed (allowing trailing whitespace)
      char buf[32];
      snprintf(buf, sizeof buf, "%lld", iv);
      out += buf;
      return;
    }
  }
  errno = 0;
  end = nullptr;
  double dv = strtod(s, &end);
  bool consumed = end && (end != s);
  if (consumed) {
    while (is_ascii_ws(*end)) end++;
    consumed = (*end == 0);
  }
  // Reject inf/nan spellings (not valid JSON) and partial parses.
  if (consumed && errno == 0 && dv == dv && dv <= 1.7976931348623157e308 &&
      dv >= -1.7976931348623157e308) {
    // Only treat as a number if it LOOKS numeric (strtod accepts "0x...",
    // "inf", "nan" — Python float() accepts inf/nan but those aren't JSON).
    const char *digits = (s[0] == '+' || s[0] == '-') ? s + 1 : s;
    char c0 = digits[0];
    if ((c0 >= '0' && c0 <= '9') || c0 == '.') {
      bool hexish =
          c0 == '0' && (digits[1] == 'x' || digits[1] == 'X');
      if (!hexish) {
        format_double(dv, out);
        return;
      }
    }
  }
  json_escape(cell, out);
}

void clean_header(std::vector<std::string> &header) {
  for (size_t i = 0; i < header.size(); i++) {
    std::string &h = header[i];
    // strip
    size_t a = 0, b = h.size();
    while (a < b && std::isspace((unsigned char)h[a])) a++;
    while (b > a && std::isspace((unsigned char)h[b - 1])) b--;
    std::string cleaned;
    bool in_run = false;
    for (size_t j = a; j < b; j++) {
      unsigned char c = h[j];
      if (std::isalnum(c) || c == '_') {
        cleaned += (char)c;
        in_run = false;
      } else if (!in_run) {
        cleaned += '_';
        in_run = true;
      }
    }
    // strip leading/trailing underscores
    size_t s0 = cleaned.find_first_not_of('_');
    size_t s1 = cleaned.find_last_not_of('_');
    cleaned = (s0 == std::string::npos)
                  ? ""
                  : cleaned.substr(s0, s1 - s0 + 1);
    if (cleaned.empty()) {
      char buf[24];
      snprintf(buf, sizeof buf, "col%zu", i);
      cleaned = buf;
    }
    h = cleaned;
  }
}

// Parse one CSV record starting at *pos; returns false at EOF.
// *clean_end (optional) reports whether the record terminated on an
// UNQUOTED newline — chunked callers roll back records that merely ran
// out of buffer (possibly inside a quoted field containing '\n').
bool next_record(const char *s, size_t n, size_t *pos,
                 std::vector<std::string> &fields,
                 bool *clean_end = nullptr) {
  fields.clear();
  size_t i = *pos;
  if (clean_end) *clean_end = false;
  if (i >= n) return false;
  std::string cur;
  bool in_quotes = false, any = false;
  while (i < n) {
    char c = s[i];
    if (in_quotes) {
      if (c == '"') {
        if (i + 1 < n && s[i + 1] == '"') {
          cur += '"';
          i += 2;
        } else {
          in_quotes = false;
          i++;
        }
      } else {
        cur += c;
        i++;
      }
      continue;
    }
    if (c == '"') {
      in_quotes = true;
      any = true;
      i++;
    } else if (c == ',') {
      fields.push_back(cur);
      cur.clear();
      any = true;
      i++;
    } else if (c == '\n' || c == '\r') {
      if (c == '\r' && i + 1 < n && s[i + 1] == '\n') i++;
      i++;
      if (clean_end) *clean_end = true;
      break;
    } else {
      cur += c;
      any = true;
      i++;
    }
  }
  *pos = i;
  if (!any && cur.empty() && fields.empty()) {
    // blank line: report as empty record (caller skips)
    return true;
  }
  fields.push_back(cur);
  return true;
}

// Parse one TRIMMED numeric cell in [a, b), no allocation —
// services/dataset.py::_infer semantics exactly: no '_'/hex spellings,
// inf/nan results (incl. overflow) are non-numeric, a leading '+' is
// fine, subnormal underflow is a fine number.  On success *v holds the
// value and *int_format reports the dtype-parity classification (pure
// [+-]?digits fitting int64).  Shared by the fast (in-place) and slow
// (quote-aware) record paths so their semantics cannot drift.
bool parse_numeric_cell(const char *a, const char *b, double *v,
                        bool *int_format) {
  size_t m = (size_t)(b - a);
  size_t digit_start = (a[0] == '+' || a[0] == '-') ? 1 : 0;
  bool ifmt = digit_start < m;
  size_t n_digits = 0;
  for (size_t j = 0; j < m; j++) {
    char ch = a[j];
    if (ch == '_' || ch == 'x' || ch == 'X') return false;
    if (j >= digit_start) {
      if (ch >= '0' && ch <= '9')
        n_digits++;
      else
        ifmt = false;
    }
  }
  double val = 0.0;
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  const char *p = a;
  if (*p == '+') {
    // std::from_chars rejects the leading '+' strtod accepts; skip it
    // only when what follows could start a number, so "+-5" still
    // fails exactly like strtod's end-pointer check did.
    if (m < 2 || (!(p[1] >= '0' && p[1] <= '9') && p[1] != '.'))
      return false;
    p++;
  }
  auto res = std::from_chars(p, b, val);
  if (res.ec == std::errc::result_out_of_range) {
    // from_chars can't distinguish overflow (non-numeric by contract)
    // from underflow-to-subnormal (accepted); rare — resolve with the
    // old NUL-terminated strtod exactly.
    std::string copy(a, m);
    char *end = nullptr;
    errno = 0;
    val = strtod(copy.c_str(), &end);
    if (end != copy.c_str() + copy.size() || val != val ||
        val > 1.7976931348623157e308 || val < -1.7976931348623157e308)
      return false;
  } else if (res.ec != std::errc() || res.ptr != b) {
    return false;
  } else if (val != val || val > 1.7976931348623157e308 ||
             val < -1.7976931348623157e308) {
    return false;  // "inf"/"nan" spellings parse but are non-numeric
  }
#else
  // Pre-GCC-11 libstdc++ has no floating-point from_chars: same
  // semantics via a NUL-terminated strtod copy (slower, still correct
  // — better than the whole native engine silently failing to build).
  {
    std::string copy(a, m);
    char *end = nullptr;
    val = strtod(copy.c_str(), &end);
    if (end == copy.c_str() || end != copy.c_str() + copy.size() ||
        val != val || val > 1.7976931348623157e308 ||
        val < -1.7976931348623157e308)
      return false;
  }
#endif
  if (ifmt && n_digits >= 19) {
    // 18 digits always fit int64 (max ~9.2e18); only longer runs need
    // the overflow probe.
    std::string copy(a, m);
    errno = 0;
    (void)strtoll(copy.c_str(), nullptr, 10);
    if (errno == ERANGE) ifmt = false;
  }
  *v = val;
  if (int_format) *int_format = ifmt;
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

const char *lods_last_error(void) { return g_error.c_str(); }

void lods_free(char *p) { free(p); }

int64_t lods_open(const char *root, int durable) {
  struct stat st;
  if (stat(root, &st) != 0) {
    if (mkdir(root, 0777) != 0 && errno != EEXIST) {
      set_error(std::string("cannot create root: ") + strerror(errno));
      return -1;
    }
  }
  auto store = std::make_shared<Store>();
  store->root = root;
  store->durable = durable != 0;
  // Open existing collections eagerly (mirrors DocumentStore.__init__).
  DIR *dir = opendir(root);
  if (dir) {
    struct dirent *ent;
    std::vector<std::string> names;
    while ((ent = readdir(dir)) != nullptr) {
      std::string fn = ent->d_name;
      if (fn.size() > 4 && fn.substr(fn.size() - 4) == ".wal")
        names.push_back(fn.substr(0, fn.size() - 4));
    }
    closedir(dir);
    for (auto &nm : names) {
      if (!store->get(nm, true)) {
        // Mid-file WAL corruption: refuse the whole open, loudly —
        // silently skipping the collection would read as data loss
        // (mirrors DocumentStore.__init__ raising CorruptWal).
        return -1;
      }
    }
  }
  std::lock_guard<std::mutex> lock(g_handles_mu);
  g_handles.push_back(std::move(store));
  return (int64_t)g_handles.size() - 1;
}

int lods_close(int64_t h) {
  std::lock_guard<std::mutex> lock(g_handles_mu);
  if (h < 0 || h >= (int64_t)g_handles.size() || !g_handles[h]) return -1;
  g_handles[h].reset();
  return 0;
}

int lods_has_collection(int64_t h, const char *name) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return -1;
  std::lock_guard<std::mutex> lock(st->mu);
  return st->colls.count(name) ? 1 : 0;
}

char *lods_list_collections(int64_t h, int64_t *out_len) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return nullptr;
  std::vector<std::string> names;
  {
    std::lock_guard<std::mutex> lock(st->mu);
    for (auto &kv : st->colls) names.push_back(kv.first);
  }
  std::sort(names.begin(), names.end());
  std::string out;
  for (auto &nm : names) {
    out += nm;
    out += '\n';
  }
  return dup_buffer(out, out_len);
}

// Insert JSONL docs (no _id fields); returns count, sets *first_id.
int64_t lods_insert_many(int64_t h, const char *name, const char *jsonl,
                         int64_t len, long long *first_id) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return -1;
  std::shared_ptr<Collection> coll = st->get(name, true);
  if (!coll) return -1;
  std::lock_guard<std::mutex> lock(coll->mu);
  std::string batch;
  batch.reserve((size_t)len + 64);
  int64_t count = 0;
  size_t i = 0, n = (size_t)len;
  if (first_id) *first_id = coll->next_id;
  while (i < n) {
    size_t j = i;
    while (j < n && jsonl[j] != '\n') j++;
    if (j > i) {
      std::string doc(jsonl + i, j - i);
      long long id = coll->next_id++;
      doc = with_id(doc, id);
      coll->docs[id] = doc;
      batch += "{\"op\":\"i\",\"d\":";
      batch += doc;
      batch += "}\n";
      count++;
    }
    i = j + 1;
  }
  if (!batch.empty() && coll->fh) {
    fwrite(batch.data(), 1, batch.size(), coll->fh);
    fflush(coll->fh);
    if (coll->durable) fsync(fileno(coll->fh));
  }
  return count;
}

// Insert a single doc at an explicit id.  unique=1 -> fail if id exists
// (returns -2, the DuplicateKey signal).
int lods_insert_at(int64_t h, const char *name, const char *json,
                   long long id, int unique) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return -1;
  std::shared_ptr<Collection> coll = st->get(name, true);
  if (!coll) return -1;
  std::lock_guard<std::mutex> lock(coll->mu);
  if (unique && coll->docs.count(id)) {
    set_error("duplicate _id");
    return -2;
  }
  std::string doc = with_id(json, id);
  coll->docs[id] = doc;
  if (id + 1 > coll->next_id) coll->next_id = id + 1;
  coll->append("{\"op\":\"i\",\"d\":" + doc + "}");
  return 0;
}

int lods_update(int64_t h, const char *name, long long id,
                const char *fields_json) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return -1;
  std::shared_ptr<Collection> coll = st->get(name, false);
  if (!coll) return -1;
  std::lock_guard<std::mutex> lock(coll->mu);
  auto it = coll->docs.find(id);
  if (it == coll->docs.end()) return 0;
  it->second = merge_objects(it->second, fields_json);
  char idbuf[32];
  snprintf(idbuf, sizeof idbuf, "%lld", id);
  coll->append(std::string("{\"op\":\"u\",\"id\":") + idbuf + ",\"d\":" +
               fields_json + "}");
  return 1;
}

int lods_delete(int64_t h, const char *name, long long id) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return -1;
  std::shared_ptr<Collection> coll = st->get(name, false);
  if (!coll) return -1;
  std::lock_guard<std::mutex> lock(coll->mu);
  if (!coll->docs.erase(id)) return 0;
  char idbuf[32];
  snprintf(idbuf, sizeof idbuf, "%lld", id);
  coll->append(std::string("{\"op\":\"d\",\"id\":") + idbuf + "}");
  return 1;
}

char *lods_find_one(int64_t h, const char *name, long long id,
                    int64_t *out_len) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return nullptr;
  std::shared_ptr<Collection> coll = st->get(name, false);
  if (!coll) return nullptr;
  std::lock_guard<std::mutex> lock(coll->mu);
  auto it = coll->docs.find(id);
  if (it == coll->docs.end()) {
    if (out_len) *out_len = 0;
    return nullptr;
  }
  return dup_buffer(it->second, out_len);
}

// All docs in _id order as JSONL, with skip/limit (-1 = no limit).
char *lods_scan(int64_t h, const char *name, int64_t skip, int64_t limit,
                int64_t *out_len) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return nullptr;
  std::shared_ptr<Collection> coll = st->get(name, false);
  if (!coll) return nullptr;
  std::lock_guard<std::mutex> lock(coll->mu);
  std::string out;
  int64_t seen = 0, emitted = 0;
  for (auto &kv : coll->docs) {
    if (seen++ < skip) continue;
    if (limit >= 0 && emitted >= limit) break;
    out += kv.second;
    out += '\n';
    emitted++;
  }
  return dup_buffer(out, out_len);
}

int64_t lods_count(int64_t h, const char *name) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return -1;
  std::shared_ptr<Collection> coll = st->get(name, false);
  if (!coll) return -1;
  std::lock_guard<std::mutex> lock(coll->mu);
  return (int64_t)coll->docs.size();
}

long long lods_next_id(int64_t h, const char *name) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return -1;
  std::shared_ptr<Collection> coll = st->get(name, false);
  if (!coll) return -1;
  std::lock_guard<std::mutex> lock(coll->mu);
  return coll->next_id;
}

// Numerically-equal JSON numbers (1 vs 1.0 vs 1e0 — e.g. after a
// dataType cast wrote floats next to originally-ingested ints) must
// share one histogram bucket, as the Python backend's parsed-value
// grouping does.  Non-numeric values (quoted strings, objects, bools)
// pass through untouched.
static std::string canonical_count_key(const std::string &val) {
  errno = 0;
  char *end = nullptr;
  double d = strtod(val.c_str(), &end);
  if (end == val.c_str() || *end != '\0' || errno == ERANGE) return val;
  // Magnitude guard FIRST: (long long)d on an out-of-range double
  // (1e300, inf) is undefined behavior.  Beyond 2^53 doubles alias
  // distinct integers, so a pure INTEGER literal keeps its raw text —
  // Python's exact ints keep such values in separate buckets and so
  // must we.  Float-syntax spellings ('.', 'e', 'E') are already
  // doubles on the Python side too, so %.17g canonicalization is safe
  // (and merges 1e20 with 1E+20).
  if (std::fabs(d) >= 9e15 &&
      val.find_first_of(".eE") == std::string::npos)
    return val;
  char buf[64];
  if (std::fabs(d) < 9e15 && d == (double)(long long)d) {
    snprintf(buf, sizeof buf, "%lld", (long long)d);
  } else {
    snprintf(buf, sizeof buf, "%.17g", d);
  }
  return buf;
}

// Value-count aggregation over a top-level field (histogram service's
// $group/$sum).  Output: JSONL lines {"k":<canonical value>,"n":<count>}.
// Skips _id=0 (metadata) and docs with docType=="execution", matching
// DocumentStore.aggregate_counts.
char *lods_value_counts(int64_t h, const char *name, const char *field,
                        int64_t *out_len) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return nullptr;
  std::shared_ptr<Collection> coll = st->get(name, false);
  if (!coll) return nullptr;
  std::lock_guard<std::mutex> lock(coll->mu);
  std::map<std::string, int64_t> counts;
  std::vector<std::string> order;  // first-seen order for stable output
  for (auto &kv : coll->docs) {
    if (kv.first == 0) continue;
    std::string dt;
    if (get_field(kv.second, "docType", dt) && dt == "\"execution\"")
      continue;
    std::string val;
    if (!get_field(kv.second, field, val)) val = "null";
    val = canonical_count_key(val);
    auto it = counts.find(val);
    if (it == counts.end()) {
      counts.emplace(val, 1);
      order.push_back(val);
    } else {
      it->second++;
    }
  }
  std::string out;
  for (auto &key : order) {
    out += "{\"k\":";
    out += key;
    out += ",\"n\":";
    char buf[32];
    snprintf(buf, sizeof buf, "%" PRId64, counts[key]);
    out += buf;
    out += "}\n";
  }
  return dup_buffer(out, out_len);
}

int lods_drop(int64_t h, const char *name) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return -1;
  std::shared_ptr<Collection> coll;
  {
    std::lock_guard<std::mutex> lock(st->mu);
    auto it = st->colls.find(name);
    if (it == st->colls.end()) return 0;
    coll = it->second;
    st->colls.erase(it);
  }
  // In-flight ops still holding the shared_ptr serialize on mu; after
  // this, their writes hit the fh==nullptr guard and become no-ops.
  std::lock_guard<std::mutex> lock(coll->mu);
  if (coll->fh) {
    fclose(coll->fh);
    coll->fh = nullptr;
  }
  unlink(coll->path.c_str());
  return 1;
}

int lods_compact(int64_t h, const char *name) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return -1;
  std::shared_ptr<Collection> coll = st->get(name, false);
  if (!coll) return -1;
  std::lock_guard<std::mutex> lock(coll->mu);
  if (!coll->fh) {
    set_error("collection dropped");
    return -1;
  }
  std::string tmp_path = coll->path + ".tmp";
  FILE *tmp = fopen(tmp_path.c_str(), "w");
  if (!tmp) {
    set_error(std::string("cannot open tmp: ") + strerror(errno));
    return -1;
  }
  char head[64];
  snprintf(head, sizeof head, "{\"op\": \"n\", \"v\": %lld}\n", coll->next_id);
  fwrite(head, 1, strlen(head), tmp);
  for (auto &kv : coll->docs) {
    std::string line = "{\"op\":\"i\",\"d\":" + kv.second + "}\n";
    fwrite(line.data(), 1, line.size(), tmp);
  }
  // Durability parity with the append path: fsync the rewritten file
  // BEFORE it replaces the live log, and the directory entry after —
  // a crash mid-compaction must never leave an empty collection where
  // a durable one stood.
  fflush(tmp);
  fsync(fileno(tmp));
  fclose(tmp);
  fclose(coll->fh);
  coll->fh = nullptr;
  if (rename(tmp_path.c_str(), coll->path.c_str()) != 0) {
    set_error(std::string("rename failed: ") + strerror(errno));
    coll->open_log();
    return -1;
  }
  std::string dir = coll->path.substr(0, coll->path.find_last_of('/'));
  int dfd = open(dir.empty() ? "." : dir.c_str(), O_RDONLY);
  if (dfd >= 0) {
    fsync(dfd);
    close(dfd);
  }
  return coll->open_log() ? 0 : -1;
}

// Project selected top-level fields of every data row of src into a new
// collection dst — the reference's Spark-executed column projection
// (projection_image/projection.py:20-48) as a native scan.  Skips the
// metadata doc (_id=0) and execution-ledger docs; missing fields become
// null (matching the Python path's d.get(f)).  fields_nl: '\n'-separated
// field names.  Returns rows written, or -1.
int64_t lods_project(int64_t h, const char *src_name, const char *dst_name,
                     const char *fields_nl) {
  std::shared_ptr<Store> st = store_for(h);
  if (!st) return -1;
  std::shared_ptr<Collection> src = st->get(src_name, false);
  if (!src) return -1;

  std::vector<std::string> fields;
  {
    const char *p = fields_nl;
    while (*p) {
      const char *q = p;
      while (*q && *q != '\n') q++;
      if (q > p) fields.emplace_back(p, q - p);
      p = *q ? q + 1 : q;
    }
  }

  // Snapshot the projected rows under the src lock, then release it
  // before taking the dst lock (no ordering between collections).
  std::vector<std::string> rows;
  {
    std::lock_guard<std::mutex> lock(src->mu);
    rows.reserve(src->docs.size());
    std::vector<KV> pairs;
    for (auto &kv : src->docs) {
      if (kv.first == 0) continue;
      pairs.clear();
      if (!parse_object(kv.second, pairs)) continue;
      bool is_exec = false;
      for (auto &pair : pairs) {
        if (pair.key == "docType" && pair.raw_val == "\"execution\"") {
          is_exec = true;
          break;
        }
      }
      if (is_exec) continue;
      std::string out = "{";
      for (size_t i = 0; i < fields.size(); i++) {
        if (i) out += ',';
        json_escape(fields[i], out);
        out += ':';
        const std::string *val = nullptr;
        for (auto &pair : pairs) {
          if (pair.key == fields[i]) {
            val = &pair.raw_val;
            break;
          }
        }
        out += val ? *val : "null";
      }
      out += "}";
      rows.push_back(std::move(out));
    }
  }

  std::shared_ptr<Collection> dst = st->get(dst_name, true);
  if (!dst) return -1;
  std::lock_guard<std::mutex> lock(dst->mu);
  std::string batch;
  for (auto &row : rows) {
    long long id = dst->next_id++;
    std::string doc = with_id(row, id);
    dst->docs[id] = doc;
    batch += "{\"op\":\"i\",\"d\":";
    batch += doc;
    batch += "}\n";
  }
  if (!batch.empty() && dst->fh) {
    fwrite(batch.data(), 1, batch.size(), dst->fh);
    fflush(dst->fh);
    if (dst->durable) fsync(fileno(dst->fh));
  }
  return (int64_t)rows.size();
}

// ---------------------------------------------------------------------------
// CSV → JSONL docs.  Output: first line is the cleaned header as a JSON
// array; each following line is a document object (no _id) ready for
// lods_insert_many.  infer=1 applies int/float/null inference (the
// dataset service's default); infer=0 keeps every value a string (the
// reference's raw behavior, database_api_image/database.py:124-137).
// ---------------------------------------------------------------------------

// Numeric chunk parse for SHARDED (beyond-RAM) ingest: complete CSV
// records from buf land row-major in out (ncols doubles per row).
// Empty/missing cells -> NaN; non-empty unparseable cells -> NaN AND
// bad_counts[col]++ (the Python writer's "column is not numeric"
// contract checks these); extra columns are ignored.  Unless is_final,
// a trailing record not terminated by a newline is NOT consumed — the
// caller re-feeds it with the next chunk (*consumed reports the bytes
// eaten).  Returns rows parsed, or -1 (see lods_last_error).
int64_t lods_csv_numeric_chunk(const char *buf, int64_t len, int is_final,
                               int64_t ncols, double *out,
                               int64_t max_rows, int64_t *bad_counts,
                               int64_t *float_counts, int64_t *consumed) {
  if (ncols <= 0 || max_rows < 0) {
    set_error("bad ncols/max_rows");
    return -1;
  }
  const double nan = std::numeric_limits<double>::quiet_NaN();
  std::vector<std::string> row;
  size_t pos = 0, n = (size_t)len;
  int64_t rows = 0;

  // Store one parsed cell with _infer-parity accounting.  The trim
  // strips the FULL ASCII whitespace set like Python's str.strip()
  // (_infer trims before parsing) — strtod's own leading-space skip
  // used to paper over '\v'/'\f', but from_chars does not skip, and
  // trailing whitespace must trim identically anyway.
  auto emit_cell = [&](const char *a, const char *b, double *slot,
                       int64_t c) {
    while (a < b && is_ascii_ws(*a)) a++;
    while (b > a && is_ascii_ws(b[-1])) b--;
    if (a == b) {
      *slot = nan;  // empty cell
      return;
    }
    double v;
    bool int_format;
    if (parse_numeric_cell(a, b, &v, &int_format)) {
      *slot = v;
      if (float_counts && !int_format) float_counts[c]++;
    } else {
      *slot = nan;
      if (bad_counts) bad_counts[c]++;
    }
  };

  while (rows < max_rows) {
    if (pos >= n) break;  // EOF
    size_t rec_begin = pos;

    // FAST PATH: records without quotes (the overwhelmingly common
    // CSV-of-numbers case) parse IN PLACE over the buffer — no
    // per-record string vector, no per-cell copies.  A '"' anywhere
    // before the terminator falls back to the quote-aware parser,
    // which owns every quoting subtlety (escaped quotes, newlines
    // inside quoted fields).
    size_t k = rec_begin;
    while (k < n && buf[k] != '"' && buf[k] != '\n' && buf[k] != '\r')
      k++;

    if (k < n && buf[k] == '"') {
      // SLOW PATH (quoted record) — semantics identical to pre-r4.
      bool clean_end = false;
      if (!next_record(buf, n, &pos, row, &clean_end)) break;
      if (!clean_end && !is_final) {
        // Ran out of buffer without an UNQUOTED newline (maybe inside
        // a quoted field containing '\n'): roll back, wait for bytes.
        pos = rec_begin;
        break;
      }
      if (row.empty() || (row.size() == 1 && row[0].empty()))
        continue;  // blank line
      double *dst = out + rows * ncols;
      for (int64_t c = 0; c < ncols; c++) {
        if ((size_t)c >= row.size()) {
          dst[c] = nan;  // short row pads NaN (Python parity)
          continue;
        }
        const std::string &cell = row[c];
        emit_cell(cell.data(), cell.data() + cell.size(), dst + c, c);
      }
      rows++;
      continue;
    }

    size_t rec_end = k;
    if (k < n) {  // terminated on '\n' or '\r'
      pos = (buf[k] == '\r' && k + 1 < n && buf[k + 1] == '\n')
                ? k + 2
                : k + 1;
    } else if (!is_final) {
      break;  // torn tail: leave pos at rec_begin, wait for bytes
    } else {
      pos = n;  // final chunk: the unterminated tail is a record
    }
    if (rec_end == rec_begin) continue;  // blank line

    double *dst = out + rows * ncols;
    const char *cell_begin = buf + rec_begin;
    const char *end = buf + rec_end;
    int64_t c = 0;
    while (c < ncols) {
      const char *cell_end = cell_begin;
      while (cell_end < end && *cell_end != ',') cell_end++;
      emit_cell(cell_begin, cell_end, dst + c, c);
      c++;
      if (cell_end >= end) break;  // last cell of the record
      cell_begin = cell_end + 1;
    }
    for (; c < ncols; c++) dst[c] = nan;  // short row pads NaN
    rows++;
  }
  if (consumed) *consumed = (int64_t)pos;
  return rows;
}

char *lods_csv_parse(const char *buf, int64_t len, int infer,
                     int64_t *out_len) {
  std::vector<std::string> header, row;
  size_t pos = 0;
  size_t n = (size_t)len;
  // Skip UTF-8 BOM.
  if (n >= 3 && (unsigned char)buf[0] == 0xEF && (unsigned char)buf[1] == 0xBB &&
      (unsigned char)buf[2] == 0xBF)
    pos = 3;
  if (!next_record(buf, n, &pos, header) || header.empty()) {
    set_error("empty CSV input");
    return nullptr;
  }
  clean_header(header);
  std::string out;
  out.reserve((size_t)len + (size_t)len / 2);
  out += '[';
  for (size_t i = 0; i < header.size(); i++) {
    if (i) out += ',';
    json_escape(header[i], out);
  }
  out += "]\n";
  while (next_record(buf, n, &pos, row)) {
    if (row.empty()) continue;  // blank line
    out += '{';
    size_t cols = row.size() < header.size() ? row.size() : header.size();
    for (size_t i = 0; i < cols; i++) {
      if (i) out += ',';
      json_escape(header[i], out);
      out += ':';
      if (infer)
        infer_value(row[i], out);
      else
        json_escape(row[i], out);
    }
    out += "}\n";
  }
  return dup_buffer(out, out_len);
}

}  // extern "C"
