// aoti_run: serves a package through the native runner's C ABI
// (aoti_capi.h), for the tests and chip_smoke.py; no Python, and no torch
// header here (the runner library brings libtorch).
//
//   aoti_run --package P --device cpu|cuda[:N] [--in TYPE:DIMS:FILE]...
//            [--out DIR] [--reps N]
//       runs P once on the inputs (raw little-endian files, TYPE one of
//       f32 i32 i64 pred u8 f64, DIMS like 8x16, empty for a scalar),
//       writes result i to DIR/r<i>.bin, then times N more runs.
//   ... --step S --ticks N --state K
//       P is a decode's init and S its step: init once, then N ticks of
//       the step, the first K results of each fed back as the next
//       tick's first K inputs (the rest, the encoder's, stay init's);
//       init's results go to DIR/init_r<i>.bin and tick k's to
//       DIR/t<k>_r<i>.bin; then N more runs of each are timed.
//   aoti_run --op NAME --device cpu|cuda[:N] [--in TYPE:DIMS:FILE|none]...
//            [--int V]... [--out DIR]
//       calls the registered op NAME ("paddle_tpu_torch::lstm_fwd") once
//       with no package: the --in tensors ("none" for a None Tensor?) and
//       the --int ints and bools in its schema's order; writes result i to
//       DIR/r<i>.bin.
//   aoti_run --plans B,B,... H,H,...
//       prints the C++ plans (plans.h) of the LSTM and the GRU forwards
//       (float32 and bf16) at every (B, H), as JSON.
//
// The last line of the output is one JSON object: each program's result
// shapes, the kernel launches of its first run (of the ticks, all of
// them) and in all, and the median host microseconds of
// ptpu_aoti_execute_n over the timed runs (after the first run, a
// warm-up). A process start is no request's latency. Errors go to stderr
// with a non-zero exit: 2 where the runner cannot be created, 1 where a
// run fails.

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iterator>
#include <sstream>
#include <string>
#include <vector>

#include "aoti_capi.h"
#include "plans.h"

namespace {

const char* const kTags[] = {"f32", "i32", "i64", "pred",
                             "u8",  "f64", "bf16"};
const int64_t kSizes[] = {4, 4, 8, 1, 1, 8, 2};
constexpr int kNumTypes = 7;
// the kernels' launch counters, then the CPU implementations' calls
const char* const kKernels[] = {"fused_lstm",        "fused_lstm_bf16",
                                "fused_gru",         "fused_gru_cluster",
                                "fused_gru_bf16",    "fused_gru_cluster_bf16",
                                "lstm_fwd_cpu",      "gru_fwd_cpu"};
constexpr int kCounters = 8;
// the results --op takes from an op
constexpr int kMaxOpResults = 8;

[[noreturn]] void die(int code, const std::string& msg) {
  std::fprintf(stderr, "aoti_run: %s\n", msg.c_str());
  std::exit(code);
}

std::vector<std::string> split(const std::string& s, char sep) {
  std::vector<std::string> out;
  std::string cur;
  std::istringstream in(s);
  while (std::getline(in, cur, sep)) out.push_back(cur);
  return out;
}

// one host tensor with the bytes it owns
struct Buffer {
  ptpu_aoti_tensor t{};
  std::vector<char> bytes;
  void own(const ptpu_aoti_tensor& from) {
    t = from;
    bytes.assign((const char*)from.data,
                 (const char*)from.data + from.size_bytes);
    t.data = bytes.data();
  }
};

// "f32:8x16:path", or "none" (no data: a None Tensor? of an op)
Buffer read_input(const std::string& arg) {
  if (arg == "none") return Buffer{};
  const size_t a = arg.find(':'), b = arg.find(':', a + 1);
  if (a == std::string::npos || b == std::string::npos)
    die(1, "--in wants TYPE:DIMS:FILE, got " + arg);
  Buffer buf;
  const std::string tag = arg.substr(0, a);
  buf.t.dtype = -1;
  for (int i = 0; i < kNumTypes; ++i)
    if (tag == kTags[i]) buf.t.dtype = i;
  if (buf.t.dtype < 0) die(1, "unknown dtype in --in " + arg);
  int64_t elems = 1;
  for (const std::string& d : split(arg.substr(a + 1, b - a - 1), 'x')) {
    if (buf.t.rank == PTPU_AOTI_MAX_RANK) die(1, "rank past 8: " + arg);
    buf.t.dims[buf.t.rank++] = std::stoll(d);
    elems *= buf.t.dims[buf.t.rank - 1];
  }
  const std::string path = arg.substr(b + 1);
  std::ifstream f(path, std::ios::binary);
  if (!f) die(1, "cannot read " + path);
  buf.bytes.assign(std::istreambuf_iterator<char>(f),
                   std::istreambuf_iterator<char>());
  if ((int64_t)buf.bytes.size() != elems * kSizes[buf.t.dtype])
    die(1, path + " holds " + std::to_string(buf.bytes.size()) +
               " bytes, " + arg + " needs " +
               std::to_string(elems * kSizes[buf.t.dtype]));
  buf.t.data = buf.bytes.data();
  buf.t.size_bytes = (int64_t)buf.bytes.size();
  return buf;
}

void write_file(const std::string& path, const ptpu_aoti_tensor& t) {
  std::ofstream f(path, std::ios::binary);
  f.write((const char*)t.data, t.size_bytes);
  if (!f) die(1, "cannot write " + path);
}

struct Launches {
  int64_t n[kCounters] = {};
  static Launches now() {
    Launches l;
    for (int i = 0; i < kCounters; ++i)
      l.n[i] = ptpu_aoti_launches(kKernels[i]);
    return l;
  }
  Launches operator-(const Launches& o) const {
    Launches l;
    for (int i = 0; i < kCounters; ++i) l.n[i] = n[i] - o.n[i];
    return l;
  }
  Launches& operator+=(const Launches& o) {
    for (int i = 0; i < kCounters; ++i) n[i] += o.n[i];
    return *this;
  }
  std::string json() const {
    std::ostringstream o;
    o << "{";
    for (int i = 0; i < kCounters; ++i)
      o << (i ? ", " : "") << "\"" << kKernels[i] << "\": " << n[i];
    o << "}";
    return o.str();
  }
};

// a runner and its result buffers
struct Program {
  void* h = nullptr;
  std::vector<Buffer> results;
  Launches first, total;
  std::vector<double> us;

  Program(const std::string& path, const std::string& device) {
    h = ptpu_aoti_create(path.c_str(), device.c_str());
    if (h == nullptr) die(2, ptpu_aoti_last_error());
    results.resize(ptpu_aoti_num_outputs(h));
    for (Buffer& r : results) r.bytes.resize(1 << 16);
  }
  ~Program() { ptpu_aoti_destroy(h); }

  // one run on `args`: growing the results' buffers where they are short
  // (the launches and the time are those of the run that fits)
  Launches run(std::vector<Buffer>& args, double* us_out) {
    std::vector<ptpu_aoti_tensor> a, r(results.size());
    for (Buffer& b : args) a.push_back(b.t);
    for (;;) {
      for (size_t i = 0; i < results.size(); ++i) {
        r[i] = ptpu_aoti_tensor{};
        r[i].data = results[i].bytes.data();
        r[i].size_bytes = (int64_t)results[i].bytes.size();
      }
      const Launches before = Launches::now();
      const auto t0 = std::chrono::steady_clock::now();
      const int rc = ptpu_aoti_execute_n(h, a.data(), (int32_t)a.size(),
                                         r.data(), (int32_t)r.size());
      const auto t1 = std::chrono::steady_clock::now();
      if (rc == -1) die(1, ptpu_aoti_last_error());
      if (rc == -2) {
        for (size_t i = 0; i < results.size(); ++i)
          results[i].bytes.resize(
              std::max<int64_t>(r[i].size_bytes, results[i].bytes.size()));
        continue;
      }
      for (size_t i = 0; i < results.size(); ++i) {
        results[i].t = r[i];
      }
      const Launches rose = Launches::now() - before;
      total += rose;
      if (us_out)
        *us_out = std::chrono::duration<double, std::micro>(t1 - t0).count();
      return rose;
    }
  }

  void timed(std::vector<Buffer>& args, int reps) {
    for (int i = 0; i < reps; ++i) {
      double t;
      run(args, &t);
      us.push_back(t);
    }
  }

  void write(const std::string& dir, const std::string& prefix) const {
    for (size_t i = 0; i < results.size(); ++i)
      write_file(dir + "/" + prefix + "r" + std::to_string(i) + ".bin",
                 results[i].t);
  }

  std::string json(const char* extra = "") const {
    std::ostringstream o;
    o << "{\"outputs\": [";
    for (size_t i = 0; i < results.size(); ++i) {
      const ptpu_aoti_tensor& t = results[i].t;
      o << (i ? ", " : "") << "{\"dtype\": \"" << kTags[t.dtype]
        << "\", \"shape\": [";
      for (int d = 0; d < t.rank; ++d) o << (d ? ", " : "") << t.dims[d];
      o << "]}";
    }
    std::vector<double> s = us;
    std::sort(s.begin(), s.end());
    o << "], \"launches\": " << first.json()
      << ", \"launches_total\": " << total.json() << ", \"timed_runs\": "
      << s.size() << ", \"median_us\": ";
    if (s.empty()) {
      o << "null";
    } else {
      const size_t n = s.size();
      o << (n % 2 ? s[n / 2] : (s[n / 2 - 1] + s[n / 2]) / 2);
    }
    o << extra << "}";
    return o.str();
  }
};

std::vector<int64_t> ints(const std::string& s) {
  std::vector<int64_t> out;
  for (const std::string& x : split(s, ',')) out.push_back(std::stoll(x));
  return out;
}

int plans(const std::string& bs, const std::string& hs) {
  std::ostringstream o;
  o << "{";
  for (const bool bf16 : {false, true}) {
    o << (bf16 ? ", \"lstm_bf16\": [" : "\"lstm\": [");
    bool first = true;
    for (const int64_t B : ints(bs))
      for (const int64_t H : ints(hs)) {
        ptpu::LstmFwdPlan p;
        o << (first ? "" : ", ") << "[" << B << ", " << H << ", ";
        if (ptpu::lstm_fwd_plan(B, H, &p, bf16))
          o << "[" << p.U << ", " << p.R << ", " << p.blocks << ", "
            << p.smem << "]]";
        else
          o << "null]";
        first = false;
      }
    o << "]";
  }
  for (const bool bf16 : {false, true}) {
    o << (bf16 ? ", \"gru_bf16\": [" : ", \"gru\": [");
    bool first = true;
    for (const int64_t B : ints(bs))
      for (const int64_t H : ints(hs)) {
        const ptpu::GruFwdPlan p = ptpu::gru_fwd_plan(B, H, bf16);
        o << (first ? "" : ", ") << "[" << B << ", " << H << ", [\""
          << (p.path == ptpu::kGruCluster ? "cluster" : "grid") << "\", "
          << p.C << ", " << p.R << ", " << p.smem << "]]";
        first = false;
      }
    o << "]";
  }
  o << "}";
  std::printf("%s\n", o.str().c_str());
  return 0;
}

// one call of the op `name`, its results to `dir`, big enough buffers
// found as Program::run finds them (the launches are the fitting call's)
int call_op(const std::string& name, const std::string& device,
            std::vector<Buffer>& args, const std::vector<int64_t>& scalars,
            const std::string& dir) {
  std::vector<ptpu_aoti_tensor> a;
  for (Buffer& b : args) a.push_back(b.t);
  std::vector<Buffer> results(kMaxOpResults);
  for (Buffer& r : results) r.bytes.resize(1 << 16);
  std::vector<ptpu_aoti_tensor> r(results.size());
  for (;;) {
    for (size_t i = 0; i < r.size(); ++i) {
      r[i] = ptpu_aoti_tensor{};
      r[i].data = results[i].bytes.data();
      r[i].size_bytes = (int64_t)results[i].bytes.size();
    }
    const Launches before = Launches::now();
    const int n = ptpu_aoti_call_op(
        name.c_str(), device.c_str(), a.data(), (int32_t)a.size(),
        scalars.data(), (int32_t)scalars.size(), r.data(), (int32_t)r.size());
    if (n == -1) die(1, ptpu_aoti_last_error());
    const Launches rose = Launches::now() - before;
    if (n == -2) {
      for (size_t i = 0; i < r.size(); ++i)
        results[i].bytes.resize(
            std::max<int64_t>(r[i].size_bytes, results[i].bytes.size()));
      continue;
    }
    if (n > kMaxOpResults)
      die(1, name + " has more results than " +
                 std::to_string(kMaxOpResults));
    std::ostringstream o;
    o << "{\"outputs\": [";
    for (int32_t i = 0; i < n; ++i) {
      write_file(dir + "/r" + std::to_string(i) + ".bin", r[i]);
      o << (i ? ", " : "") << "{\"dtype\": \"" << kTags[r[i].dtype]
        << "\", \"shape\": [";
      for (int d = 0; d < r[i].rank; ++d) o << (d ? ", " : "") << r[i].dims[d];
      o << "]}";
    }
    o << "], \"launches\": " << rose.json() << "}";
    std::printf("%s\n", o.str().c_str());
    return 0;
  }
}

}  // namespace

int main(int argc, char** argv) {
  std::string package, step, op, device = "cuda", out = ".";
  std::vector<Buffer> args;
  std::vector<int64_t> scalars;
  int reps = 0, ticks = 0, state = 0;
  for (int i = 1; i < argc; ++i) {
    const std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) die(1, a + " wants a value");
      return argv[++i];
    };
    if (a == "--plans") {
      const std::string bs = next();
      return plans(bs, next());
    } else if (a == "--package") {
      package = next();
    } else if (a == "--op") {
      op = next();
    } else if (a == "--int") {
      scalars.push_back(std::stoll(next()));
    } else if (a == "--device") {
      device = next();
    } else if (a == "--in") {
      args.push_back(read_input(next()));
    } else if (a == "--out") {
      out = next();
    } else if (a == "--reps") {
      reps = std::stoi(next());
    } else if (a == "--step") {
      step = next();
    } else if (a == "--ticks") {
      ticks = std::stoi(next());
    } else if (a == "--state") {
      state = std::stoi(next());
    } else {
      die(1, "unknown argument " + a);
    }
  }
  if (!op.empty()) return call_op(op, device, args, scalars, out);
  if (package.empty()) die(1, "no --package");

  Program prog(package, device);
  prog.first = prog.run(args, nullptr);
  prog.write(out, step.empty() ? "" : "init_");
  if (step.empty()) {
    prog.timed(args, reps);
    std::printf("%s\n", prog.json().c_str());
    return 0;
  }

  // the decode: init's results are the step's inputs
  Program stepper(step, device);
  std::vector<Buffer> sargs(prog.results.size());
  for (size_t i = 0; i < sargs.size(); ++i) sargs[i].own(prog.results[i].t);
  if (state < 0 || state > (int)std::min(sargs.size(), stepper.results.size()))
    die(1, "--state " + std::to_string(state) + " past the step's results");
  std::vector<double> tick_us;
  for (int k = 0; k < ticks; ++k) {
    double t;
    const Launches rose = stepper.run(sargs, &t);
    stepper.first += rose;
    tick_us.push_back(t);
    stepper.write(out, "t" + std::to_string(k) + "_");
    if (k + 1 < ticks)
      for (int i = 0; i < state; ++i) sargs[i].own(stepper.results[i].t);
  }
  prog.timed(args, reps);
  stepper.timed(sargs, reps);
  std::ostringstream ticks_json;
  ticks_json << ", \"tick_us\": [";
  for (size_t i = 0; i < tick_us.size(); ++i)
    ticks_json << (i ? ", " : "") << tick_us[i];
  ticks_json << "]";
  const std::string step_json = stepper.json(ticks_json.str().c_str());
  std::printf("{\"init\": %s, \"step\": %s, \"ticks\": %d}\n",
              prog.json().c_str(), step_json.c_str(), ticks);
  return 0;
}
