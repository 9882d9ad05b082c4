// gpu-exporter: native node-status exporter (counterpart of
// native/tpu-exporter/tpu_exporter.cc).
//
// A dependency-free binary that turns the node's validation barriers
// (<status dir>/*-ready), its GPU device nodes and the perf barrier into
// Prometheus gauges. `gpu-validator -c metrics` execs it when it finds it
// and serves from Python otherwise. The text it writes is the Python
// exporter's (tpu_operator_torch/validator/metrics.py, NodeMetrics) byte
// for byte, the refresh timestamp aside: the same families in the same
// order, names, HELP text, labels and value format, and the same per-GPU
// attribution as validator/status.py (failed_local_chips, partial_sweep),
// read from the barrier with a real JSON parser.
//
// Usage:
//   gpu-exporter [--port N] [--status-dir DIR] [--oneshot]
//
// --oneshot prints the metrics payload to stdout and exits.

#include <arpa/inet.h>
#include <glob.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/time.h>
#include <unistd.h>

#include <cerrno>
#include <climits>
#include <cmath>
#include <csignal>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <memory>
#include <set>
#include <sstream>
#include <string>
#include <utility>
#include <vector>

namespace {

constexpr const char* kDefaultStatusDir = "/run/tpu/validations";
constexpr const char* kDevGlobs[] = {"/dev/nvidia[0-9]*"};
constexpr const char* kComponents[] = {"driver", "plugin", "workload"};

// -- JSON ---------------------------------------------------------------------
// The values Python's json module gives: null, bool, int and float kept
// apart, string, list, and an object whose later duplicate keys win.

struct Json {
  enum Kind { kNull, kBool, kInt, kFloat, kString, kList, kObject } kind = kNull;
  bool b = false;
  long long i = 0;  // kInt (ints beyond 64 bits are read as floats)
  double f = 0;
  std::string s;
  std::vector<Json> list;
  std::vector<std::pair<std::string, Json>> object;

  const Json* Get(const std::string& key) const {
    if (kind != kObject) return nullptr;
    for (auto it = object.rbegin(); it != object.rend(); ++it) {
      if (it->first == key) return &it->second;
    }
    return nullptr;
  }
  bool IsNumber() const { return kind == kInt || kind == kFloat || kind == kBool; }
  double Number() const { return kind == kInt ? static_cast<double>(i) : kind == kBool ? b : f; }
  bool IsFalse() const { return kind == kBool && !b; }
};

class Parser {
 public:
  explicit Parser(const std::string& text) : t_(text) {}

  bool Parse(Json* out) {
    Space();
    if (!Value(out, 0)) return false;
    Space();
    return p_ == t_.size();
  }

 private:
  void Space() {
    while (p_ < t_.size() && (t_[p_] == ' ' || t_[p_] == '\t' || t_[p_] == '\n' ||
                              t_[p_] == '\r')) {
      ++p_;
    }
  }
  bool Literal(const char* word) {
    const size_t n = std::strlen(word);
    if (t_.compare(p_, n, word) != 0) return false;
    p_ += n;
    return true;
  }
  static void Utf8(unsigned cp, std::string* out) {
    if (cp < 0x80) {
      *out += static_cast<char>(cp);
    } else if (cp < 0x800) {
      *out += static_cast<char>(0xC0 | (cp >> 6));
      *out += static_cast<char>(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      *out += static_cast<char>(0xE0 | (cp >> 12));
      *out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      *out += static_cast<char>(0x80 | (cp & 0x3F));
    } else {
      *out += static_cast<char>(0xF0 | (cp >> 18));
      *out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
      *out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      *out += static_cast<char>(0x80 | (cp & 0x3F));
    }
  }
  bool Hex4(unsigned* out) {
    if (p_ + 4 > t_.size()) return false;
    unsigned v = 0;
    for (int k = 0; k < 4; ++k) {
      const char c = t_[p_++];
      v <<= 4;
      if (c >= '0' && c <= '9') v |= c - '0';
      else if (c >= 'a' && c <= 'f') v |= c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') v |= c - 'A' + 10;
      else return false;
    }
    *out = v;
    return true;
  }
  bool String(std::string* out) {
    if (p_ >= t_.size() || t_[p_] != '"') return false;
    ++p_;
    while (p_ < t_.size()) {
      const unsigned char c = t_[p_++];
      if (c == '"') return true;
      if (c < 0x20) return false;  // json.loads is strict about control characters
      if (c != '\\') {
        *out += static_cast<char>(c);
        continue;
      }
      if (p_ >= t_.size()) return false;
      const char e = t_[p_++];
      switch (e) {
        case '"': *out += '"'; break;
        case '\\': *out += '\\'; break;
        case '/': *out += '/'; break;
        case 'b': *out += '\b'; break;
        case 'f': *out += '\f'; break;
        case 'n': *out += '\n'; break;
        case 'r': *out += '\r'; break;
        case 't': *out += '\t'; break;
        case 'u': {
          unsigned cp;
          if (!Hex4(&cp)) return false;
          if (cp >= 0xD800 && cp < 0xDC00 && t_.compare(p_, 2, "\\u") == 0) {
            const size_t keep = p_;
            p_ += 2;
            unsigned lo;
            if (Hex4(&lo) && lo >= 0xDC00 && lo < 0xE000) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            } else {
              p_ = keep;
            }
          }
          Utf8(cp, out);
          break;
        }
        default: return false;
      }
    }
    return false;
  }
  bool Number(Json* out) {
    const size_t start = p_;
    if (t_[p_] == '-') ++p_;
    if (p_ >= t_.size()) return false;
    if (t_[p_] == '0') {
      ++p_;
    } else if (t_[p_] >= '1' && t_[p_] <= '9') {
      while (p_ < t_.size() && isdigit(static_cast<unsigned char>(t_[p_]))) ++p_;
    } else {
      return false;
    }
    bool is_float = false;
    if (p_ < t_.size() && t_[p_] == '.') {
      is_float = true;
      ++p_;
      if (p_ >= t_.size() || !isdigit(static_cast<unsigned char>(t_[p_]))) return false;
      while (p_ < t_.size() && isdigit(static_cast<unsigned char>(t_[p_]))) ++p_;
    }
    if (p_ < t_.size() && (t_[p_] == 'e' || t_[p_] == 'E')) {
      is_float = true;
      ++p_;
      if (p_ < t_.size() && (t_[p_] == '+' || t_[p_] == '-')) ++p_;
      if (p_ >= t_.size() || !isdigit(static_cast<unsigned char>(t_[p_]))) return false;
      while (p_ < t_.size() && isdigit(static_cast<unsigned char>(t_[p_]))) ++p_;
    }
    const std::string text = t_.substr(start, p_ - start);
    if (!is_float) {
      errno = 0;
      const long long v = std::strtoll(text.c_str(), nullptr, 10);
      if (errno != ERANGE) {
        out->kind = Json::kInt;
        out->i = v;
        return true;
      }
    }
    out->kind = Json::kFloat;
    out->f = std::strtod(text.c_str(), nullptr);
    return true;
  }
  bool Value(Json* out, int depth) {
    if (depth > 512 || p_ >= t_.size()) return false;
    const char c = t_[p_];
    if (c == '{') {
      ++p_;
      out->kind = Json::kObject;
      Space();
      if (p_ < t_.size() && t_[p_] == '}') {
        ++p_;
        return true;
      }
      for (;;) {
        Space();
        std::string key;
        if (!String(&key)) return false;
        Space();
        if (p_ >= t_.size() || t_[p_] != ':') return false;
        ++p_;
        Space();
        Json v;
        if (!Value(&v, depth + 1)) return false;
        out->object.emplace_back(std::move(key), std::move(v));
        Space();
        if (p_ < t_.size() && t_[p_] == ',') {
          ++p_;
          continue;
        }
        if (p_ < t_.size() && t_[p_] == '}') {
          ++p_;
          return true;
        }
        return false;
      }
    }
    if (c == '[') {
      ++p_;
      out->kind = Json::kList;
      Space();
      if (p_ < t_.size() && t_[p_] == ']') {
        ++p_;
        return true;
      }
      for (;;) {
        Space();
        Json v;
        if (!Value(&v, depth + 1)) return false;
        out->list.push_back(std::move(v));
        Space();
        if (p_ < t_.size() && t_[p_] == ',') {
          ++p_;
          continue;
        }
        if (p_ < t_.size() && t_[p_] == ']') {
          ++p_;
          return true;
        }
        return false;
      }
    }
    if (c == '"') {
      out->kind = Json::kString;
      return String(&out->s);
    }
    if (Literal("true")) {
      out->kind = Json::kBool;
      out->b = true;
      return true;
    }
    if (Literal("false")) {
      out->kind = Json::kBool;
      return true;
    }
    if (Literal("null")) return true;
    // Python's json also reads these three
    if (Literal("NaN")) {
      out->kind = Json::kFloat;
      out->f = NAN;
      return true;
    }
    if (Literal("Infinity")) {
      out->kind = Json::kFloat;
      out->f = INFINITY;
      return true;
    }
    if (Literal("-Infinity")) {
      out->kind = Json::kFloat;
      out->f = -INFINITY;
      return true;
    }
    return Number(out);
  }

  const std::string& t_;
  size_t p_ = 0;
};

bool ReadFile(const std::string& path, std::string* out) {
  struct stat st;
  if (stat(path.c_str(), &st) != 0 || !S_ISREG(st.st_mode)) return false;
  std::ifstream in(path, std::ios::binary);
  if (!in) return false;
  std::stringstream buffer;
  buffer << in.rdbuf();
  *out = buffer.str();
  return true;
}

// StatusFiles.read: the barrier as an object, or null when absent, not
// JSON, or JSON that is not an object. *present tells absent from corrupt.
std::unique_ptr<Json> ReadBarrier(const std::string& status_dir, const char* component,
                                  bool* present = nullptr) {
  std::string body;
  const bool found = ReadFile(status_dir + "/" + component + "-ready", &body);
  if (present != nullptr) *present = found;
  if (!found) return nullptr;
  auto value = std::make_unique<Json>();
  if (!Parser(body).Parse(value.get()) || value->kind != Json::kObject) return nullptr;
  return value;
}

// StatusFiles.is_ready: present and not recording `"passed": false`
bool Ready(const std::string& status_dir, const char* component) {
  const auto info = ReadBarrier(status_dir, component);
  if (!info) return false;
  const Json* passed = info->Get("passed");
  return passed == nullptr || !passed->IsFalse();
}

// Python's int() of a barrier value: false when int() would raise
bool PyInt(const Json& v, long long* out) {
  switch (v.kind) {
    case Json::kBool: *out = v.b; return true;
    case Json::kInt: *out = v.i; return true;
    case Json::kFloat:
      if (!std::isfinite(v.f) || std::fabs(v.f) >= 9.2e18) return false;
      *out = static_cast<long long>(v.f);  // truncates toward zero, as int() does
      return true;
    case Json::kString: {
      const char* s = v.s.c_str();
      while (isspace(static_cast<unsigned char>(*s))) ++s;
      const char* digits = (*s == '+' || *s == '-') ? s + 1 : s;
      if (!isdigit(static_cast<unsigned char>(*digits))) return false;
      char* end = nullptr;
      errno = 0;
      *out = std::strtoll(s, &end, 10);
      while (isspace(static_cast<unsigned char>(*end))) ++end;
      return errno != ERANGE && *end == '\0';
    }
    default: return false;
  }
}

// Python's `x == n` for an int n, over the barrier's number types
bool EqualsInt(const Json& v, long long n) {
  if (v.kind == Json::kInt) return v.i == n;
  if (v.kind == Json::kBool) return static_cast<long long>(v.b) == n;
  if (v.kind == Json::kFloat) return v.f == static_cast<double>(n);
  return false;
}

// len() of a value, false where Python's len() would raise
bool PyLen(const Json& v, size_t* out) {
  switch (v.kind) {
    case Json::kList: *out = v.list.size(); return true;
    case Json::kObject: *out = v.object.size(); return true;
    case Json::kString: *out = v.s.size(); return true;  // bytes, not code points
    default: return false;
  }
}

bool Truthy(const Json& v) {
  switch (v.kind) {
    case Json::kNull: return false;
    case Json::kBool: return v.b;
    case Json::kInt: return v.i != 0;
    case Json::kFloat: return v.f != 0;
    case Json::kString: return !v.s.empty();
    case Json::kList: return !v.list.empty();
    case Json::kObject: return !v.object.empty();
  }
  return false;
}

// validator/status.py failed_local_chips: the local GPUs a failed barrier
// implicates; false where the failure names none (every GPU is then
// implicated)
bool FailedLocalChips(const Json& info, size_t local_count, std::set<long long>* out) {
  const Json* pre_paired = info.Get("failed_local_chips");
  if (pre_paired != nullptr && pre_paired->kind == Json::kList) {
    const Json* local_map = info.Get("local_chips");
    if (local_map == nullptr || local_map->kind != Json::kList ||
        local_map->list.size() != local_count) {
      return false;
    }
    for (const Json& c : pre_paired->list) {
      long long v;
      if (!PyInt(c, &v)) return false;
      out->insert(v);
    }
    return true;
  }
  const Json* details = info.Get("details");
  if (details == nullptr || details->kind != Json::kObject) return false;
  std::set<long long> failed_global;
  // Python's dict keeps the last of duplicate keys
  std::vector<const Json*> checks;
  std::set<std::string> seen;
  for (const auto& entry : details->object) {
    if (seen.insert(entry.first).second) checks.push_back(details->Get(entry.first));
  }
  for (const Json* check : checks) {
    if (check->kind != Json::kObject) return false;
    const Json* passed = check->Get("passed");
    if (passed == nullptr || !passed->IsFalse()) continue;
    const Json* chips = check->Get("failed_chips");
    if (chips == nullptr || chips->kind != Json::kList || chips->list.empty()) return false;
    for (const Json& c : chips->list) {
      long long v;
      if (!PyInt(c, &v)) return false;
      failed_global.insert(v);
    }
  }
  if (failed_global.empty()) return false;
  const Json* local_map = info.Get("local_chips");
  std::vector<Json> identity;
  const std::vector<Json>* map = nullptr;
  if (local_map != nullptr && Truthy(*local_map)) {
    size_t n;
    if (!PyLen(*local_map, &n) || n != local_count) return false;
    // a string's or an object's members are never ordinals: nothing matches
    if (local_map->kind != Json::kList) return true;
    map = &local_map->list;
  } else {
    const Json* n_devices = info.Get("n_devices");
    if (n_devices == nullptr || !EqualsInt(*n_devices, static_cast<long long>(local_count))) {
      return false;
    }
    for (size_t k = 0; k < local_count; ++k) {
      Json v;
      v.kind = Json::kInt;
      v.i = static_cast<long long>(k);
      identity.push_back(v);
    }
    map = &identity;
  }
  for (size_t local = 0; local < map->size(); ++local) {
    const Json& g = (*map)[local];
    // `global_ord in failed_global`: an int, bool or integral float matches
    if (!g.IsNumber()) continue;
    const double d = g.Number();
    if (d == std::floor(d) && std::fabs(d) < 9.2e18 &&
        failed_global.count(static_cast<long long>(d))) {
      out->insert(static_cast<long long>(local));
    }
  }
  return true;
}

// validator/status.py partial_sweep
bool PartialSweep(const Json& info, size_t local_count) {
  const Json* local_map = info.Get("local_chips");
  if (local_map != nullptr && local_map->kind == Json::kList && !local_map->list.empty()) {
    return local_map->list.size() != local_count;
  }
  const Json* n = info.Get("n_devices");
  if (n == nullptr) return false;
  if (n->kind == Json::kInt) return n->i < static_cast<long long>(local_count);
  if (n->kind == Json::kBool) return static_cast<size_t>(n->b) < local_count;
  return false;
}

size_t CountDevices(const char* globs_env) {
  std::vector<std::string> patterns;
  if (globs_env != nullptr && globs_env[0] != '\0') {
    const std::string raw(globs_env);
    size_t start = 0;
    while (start <= raw.size()) {
      size_t comma = raw.find(',', start);
      if (comma == std::string::npos) comma = raw.size();
      if (comma > start) patterns.emplace_back(raw.substr(start, comma - start));
      start = comma + 1;
    }
  } else {
    for (const char* pattern : kDevGlobs) patterns.emplace_back(pattern);
  }
  size_t count = 0;
  for (const auto& pattern : patterns) {
    glob_t results;
    if (glob(pattern.c_str(), 0, nullptr, &results) == 0) count += results.gl_pathc;
    globfree(&results);
  }
  return count;
}

// -- the text format, as metrics.py writes it --------------------------------

// repr() of a Python float: the shortest digits that read back the same,
// positional for exponents -4..15, else d.ddde+XX
std::string PyRepr(double v) {
  if (v == 0) return std::signbit(v) ? "-0.0" : "0.0";
  char buf[64];
  int precision = 1;
  for (; precision <= 17; ++precision) {
    std::snprintf(buf, sizeof(buf), "%.*e", precision - 1, v);
    if (std::strtod(buf, nullptr) == v) break;
  }
  std::string text(buf);
  const bool negative = text[0] == '-';
  if (negative) text.erase(0, 1);
  const size_t e_pos = text.find('e');
  const int exponent = std::atoi(text.c_str() + e_pos + 1);
  std::string digits;
  for (size_t k = 0; k < e_pos; ++k) {
    if (text[k] != '.') digits += text[k];
  }
  while (digits.size() > 1 && digits.back() == '0') digits.pop_back();
  std::string out;
  if (exponent >= -4 && exponent < 16) {
    if (exponent >= 0) {
      std::string whole = digits.substr(0, std::min(digits.size(), size_t(exponent) + 1));
      while (whole.size() < size_t(exponent) + 1) whole += '0';
      std::string frac = digits.size() > size_t(exponent) + 1 ? digits.substr(exponent + 1) : "0";
      out = whole + "." + frac;
    } else {
      out = "0." + std::string(-exponent - 1, '0') + digits;
    }
  } else {
    out = digits.substr(0, 1);
    if (digits.size() > 1) out += "." + digits.substr(1);
    char exp_buf[16];
    std::snprintf(exp_buf, sizeof(exp_buf), "e%c%02d", exponent < 0 ? '-' : '+',
                  std::abs(exponent));
    out += exp_buf;
  }
  return negative ? "-" + out : out;
}

// metrics.py _format_value: Go's float format, so a value at or above
// 10^6 goes to an exponent
std::string FormatValue(double v) {
  if (std::isinf(v)) return v > 0 ? "+Inf" : "-Inf";
  if (std::isnan(v)) return "NaN";
  const std::string s = PyRepr(v);
  const size_t dot = s.find('.');
  if (v > 0 && dot != std::string::npos && dot > 6) {
    std::string mantissa = s.substr(0, 1) + "." + s.substr(1, dot - 1) + s.substr(dot + 1);
    while (!mantissa.empty() && (mantissa.back() == '0' || mantissa.back() == '.')) {
      mantissa.pop_back();
    }
    return mantissa + "e+0" + std::to_string(dot - 1);
  }
  return s;
}

void Header(std::string* out, const std::string& name, const std::string& help) {
  *out += "# HELP " + name + " " + help + "\n# TYPE " + name + " gauge\n";
}

void Gauge(std::string* out, const std::string& name, const std::string& help, double value) {
  Header(out, name, help);
  *out += name + " " + FormatValue(value) + "\n";
}

// a perf reading as NodeMetrics sets it: a number (a bool counts as 0/1),
// else 0
double PerfValue(const Json* perf, const char* key, bool* measured) {
  const Json* v = perf != nullptr ? perf->Get(key) : nullptr;
  *measured = v != nullptr && (v->kind == Json::kInt || v->kind == Json::kFloat);
  return v != nullptr && v->IsNumber() ? v->Number() : 0;
}

std::string RenderMetrics(const std::string& status_dir, double now) {
  std::string out;
  for (const char* component : kComponents) {
    Gauge(&out, std::string("tpu_operator_node_") + component + "_ready",
          std::string("1 when the ") + component + " validation barrier is present on this node",
          Ready(status_dir, component) ? 1 : 0);
  }
  const size_t n_devices = CountDevices(std::getenv("GPU_DEV_GLOBS"));
  Gauge(&out, "tpu_operator_node_tpu_device_nodes", "TPU device nodes visible on this node",
        static_cast<double>(n_devices));

  Header(&out, "tpu_operator_node_chip_healthy",
         "1 when the most recent full-host workload sweep holds no failure attributed to this "
         "chip; 0 on attributed failure OR any unattributable/corrupt failure record (fail "
         "safe, every chip reads 0); series absent while only a partial-coverage sweep result "
         "exists");
  bool present = false;
  const auto workload = ReadBarrier(status_dir, "workload", &present);
  const bool corrupt = !workload && present;
  const Json* passed = workload ? workload->Get("passed") : nullptr;
  const bool failed_barrier = passed != nullptr && passed->IsFalse();
  if (!(workload && !failed_barrier && PartialSweep(*workload, n_devices))) {
    // a partial-coverage pass says nothing of the gated GPUs: no series
    bool all_failed = corrupt;
    std::set<long long> failed;
    if (!corrupt && workload && failed_barrier) {
      all_failed = !FailedLocalChips(*workload, n_devices, &failed);
    }
    for (size_t chip = 0; chip < n_devices; ++chip) {
      const bool bad = all_failed || failed.count(static_cast<long long>(chip)) > 0;
      out += "tpu_operator_node_chip_healthy{chip=\"" + std::to_string(chip) + "\"} " +
             FormatValue(bad ? 0 : 1) + "\n";
    }
  }
  Gauge(&out, "tpu_operator_node_metrics_last_refresh_ts_seconds",
        "Timestamp of the last metrics refresh", now);

  const auto perf = ReadBarrier(status_dir, "perf");
  bool measured;
  Gauge(&out, "tpu_operator_node_mxu_tflops",
        "Measured MXU throughput (bf16 TFLOP/s) from perf validation",
        PerfValue(perf.get(), "mxu_tflops", &measured));
  Gauge(&out, "tpu_operator_node_hbm_gbps", "Measured HBM bandwidth (GB/s) from perf validation",
        PerfValue(perf.get(), "hbm_gbps", &measured));
  // all-reduce bandwidth only once the barrier holds a number: one GPU
  // never measures it, and 0.0 would read as a dead fabric
  const double ici = PerfValue(perf.get(), "ici_allreduce_gbps", &measured);
  if (measured) {
    Gauge(&out, "tpu_operator_node_ici_allreduce_gbps",
          "Measured ICI allreduce bus bandwidth (GB/s) from perf validation; series absent "
          "when the sweep skipped the measurement (single chip)",
          ici);
  }
  return out;
}

double Now() {
  timeval tv;
  gettimeofday(&tv, nullptr);
  return static_cast<double>(tv.tv_sec) + tv.tv_usec / 1e6;
}

int Serve(int port, const std::string& status_dir) {
  // a scraper closing mid-write must not kill the process
  signal(SIGPIPE, SIG_IGN);
  const int server_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (server_fd < 0) {
    perror("socket");
    return 1;
  }
  int opt = 1;
  setsockopt(server_fd, SOL_SOCKET, SO_REUSEADDR, &opt, sizeof(opt));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(server_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      listen(server_fd, 16) < 0) {
    perror("bind/listen");
    close(server_fd);
    return 1;
  }
  std::fprintf(stderr, "gpu-exporter serving on :%d (status dir %s)\n", port,
               status_dir.c_str());
  for (;;) {
    const int client = accept(server_fd, nullptr, nullptr);
    if (client < 0) continue;
    // bound the read: an idle client must not wedge the accept loop
    timeval timeout{};
    timeout.tv_sec = 5;
    setsockopt(client, SOL_SOCKET, SO_RCVTIMEO, &timeout, sizeof(timeout));
    char request[2048];
    const ssize_t got = read(client, request, sizeof(request) - 1);
    if (got <= 0) {
      close(client);
      continue;
    }
    request[got] = '\0';
    std::string body, header;
    if (std::strncmp(request, "GET /metrics", 12) == 0) {
      body = RenderMetrics(status_dir, Now());
      header = "HTTP/1.1 200 OK\r\nContent-Type: text/plain; version=0.0.4\r\n";
    } else if (std::strncmp(request, "GET /healthz", 12) == 0) {
      body = "ok\n";
      header = "HTTP/1.1 200 OK\r\nContent-Type: text/plain\r\n";
    } else {
      body = "not found\n";
      header = "HTTP/1.1 404 Not Found\r\nContent-Type: text/plain\r\n";
    }
    header += "Content-Length: " + std::to_string(body.size()) + "\r\nConnection: close\r\n\r\n";
    (void)!write(client, header.c_str(), header.size());
    (void)!write(client, body.c_str(), body.size());
    close(client);
  }
}

}  // namespace

int main(int argc, char** argv) {
  int port = 8000;
  std::string status_dir = kDefaultStatusDir;
  bool dir_given = false;
  bool oneshot = false;
  for (int i = 1; i < argc; ++i) {
    const std::string arg = argv[i];
    if (arg.rfind("--port=", 0) == 0) {
      port = std::atoi(arg.c_str() + 7);
    } else if (arg == "--port" && i + 1 < argc) {
      port = std::atoi(argv[++i]);
    } else if (arg.rfind("--status-dir=", 0) == 0) {
      status_dir = arg.substr(13);
      dir_given = true;
    } else if (arg == "--status-dir" && i + 1 < argc) {
      status_dir = argv[++i];
      dir_given = true;
    } else if (arg == "--oneshot") {
      oneshot = true;
    } else {
      std::fprintf(stderr, "usage: gpu-exporter [--port N] [--status-dir DIR] [--oneshot]\n");
      return 2;
    }
  }
  const char* env_dir = std::getenv("STATUS_DIR");
  if (!dir_given && env_dir != nullptr && env_dir[0] != '\0') status_dir = env_dir;
  if (oneshot) {
    std::fputs(RenderMetrics(status_dir, Now()).c_str(), stdout);
    return 0;
  }
  return Serve(port, status_dir);
}
