// gpu-probe: fast on-node GPU driver probe (counterpart of
// native/tpu-probe/tpu_probe.cc).
//
// The driver installer's startupProbe: "is the CUDA driver library
// installed and are GPU device nodes visible", answered without starting
// an interpreter and without opening a CUDA context. The Python validator
// (tpu_operator_torch/validator/driver.py) runs this binary when it finds
// it and makes the same file checks itself otherwise; keep the two agreeing.
//
// Usage:
//   gpu-probe [--install-dir DIR] [--no-require-devices] [--json]
//   gpu-probe devices            # list device nodes, one per line
//
// Exit codes: 0 healthy, 1 unhealthy, 2 usage error. The --json keys are
// the reference's ("libtpu" holds the driver library), as the driver
// barrier's are.

#include <elf.h>
#include <glob.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr const char* kDefaultInstallDir = "/usr/lib/x86_64-linux-gnu";
constexpr const char* kDriverLib = "libcuda.so.1";
// per-GPU nodes only: nvidiactl and nvidia-uvm are not GPUs
constexpr const char* kDevGlobs[] = {"/dev/nvidia[0-9]*"};

std::vector<std::string> DiscoverDevices(const char* globs_env) {
  std::vector<std::string> patterns;
  if (globs_env != nullptr && globs_env[0] != '\0') {
    // comma-separated override, as the Python validator's GPU_DEV_GLOBS
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
  std::vector<std::string> found;
  for (const auto& pattern : patterns) {
    glob_t results;
    if (glob(pattern.c_str(), 0, nullptr, &results) == 0) {
      for (size_t i = 0; i < results.gl_pathc; ++i) found.emplace_back(results.gl_pathv[i]);
    }
    globfree(&results);
  }
  return found;
}

// installed = a readable file with the ELF magic, the same 4-byte check as
// driver.is_valid_driver_lib
bool CheckDriverLib(const std::string& install_dir, std::string* path_out) {
  *path_out = install_dir + "/" + kDriverLib;
  FILE* f = std::fopen(path_out->c_str(), "rb");
  if (f == nullptr) return false;
  unsigned char magic[SELFMAG] = {0};
  const size_t got = std::fread(magic, 1, sizeof(magic), f);
  std::fclose(f);
  return got == sizeof(magic) && std::memcmp(magic, ELFMAG, SELFMAG) == 0;
}

// a JSON string: quotes, backslashes and control characters escaped
std::string Quote(const std::string& s) {
  std::string out = "\"";
  for (const unsigned char c : s) {
    if (c == '"' || c == '\\') {
      out += '\\';
      out += static_cast<char>(c);
    } else if (c < 0x20) {
      char buf[8];
      std::snprintf(buf, sizeof(buf), "\\u%04x", c);
      out += buf;
    } else {
      out += static_cast<char>(c);
    }
  }
  return out + "\"";
}

}  // namespace

int main(int argc, char** argv) {
  std::string install_dir = kDefaultInstallDir;
  bool require_devices = true;
  bool json = false;
  bool list_devices = false;
  for (int i = 1; i < argc; ++i) {
    const std::string arg = argv[i];
    if (arg == "--install-dir" && i + 1 < argc) {
      install_dir = argv[++i];
    } else if (arg.rfind("--install-dir=", 0) == 0) {
      install_dir = arg.substr(std::strlen("--install-dir="));
    } else if (arg == "--no-require-devices") {
      require_devices = false;
    } else if (arg == "--json") {
      json = true;
    } else if (arg == "devices") {
      list_devices = true;
    } else if (arg == "--help" || arg == "-h") {
      std::fprintf(stderr, "usage: gpu-probe [--install-dir DIR] [--no-require-devices] "
                           "[--json] | gpu-probe devices\n");
      return 2;
    } else {
      std::fprintf(stderr, "gpu-probe: unknown argument %s\n", arg.c_str());
      return 2;
    }
  }

  const std::vector<std::string> devices = DiscoverDevices(std::getenv("GPU_DEV_GLOBS"));
  if (list_devices) {
    for (const auto& d : devices) std::printf("%s\n", d.c_str());
    return devices.empty() ? 1 : 0;
  }

  std::string lib_path;
  const bool lib_ok = CheckDriverLib(install_dir, &lib_path);
  const bool ok = lib_ok && (!require_devices || !devices.empty());
  if (json) {
    std::printf("{\"ok\":%s,\"libtpu\":{\"path\":%s,\"ok\":%s},\"devices\":[",
                ok ? "true" : "false", Quote(lib_path).c_str(), lib_ok ? "true" : "false");
    for (size_t i = 0; i < devices.size(); ++i) {
      std::printf("%s%s", i == 0 ? "" : ",", Quote(devices[i]).c_str());
    }
    std::printf("]}\n");
  } else if (!ok) {
    std::fprintf(stderr, "gpu-probe: unhealthy (%s %s: %s, %zu device node(s))\n", kDriverLib,
                 lib_ok ? "ok" : "missing/invalid", lib_path.c_str(), devices.size());
  }
  return ok ? 0 : 1;
}
