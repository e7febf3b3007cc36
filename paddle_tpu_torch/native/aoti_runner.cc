// The native runner: serves an AOTInductor package of the port (the
// forward, or a decode step's init or step, io/merged_model.py
// export_forward_aoti_ex and export_decode_step_artifacts_ex) with no
// Python, through torch::inductor::AOTIModelPackageLoader. The
// counterpart of the JAX package's PJRT runner (paddle_tpu/native/
// pjrt_runner.cc), with its C ABI's shape (aoti_capi.h):
//
//   ptpu_aoti_create(package_path, device)   -> handle | NULL
//   ptpu_aoti_num_outputs(h)
//   ptpu_aoti_execute_n(h, args[], nargs, results[], nresults)
//       typed host tensors in, typed host tensors out; -2 with the bytes
//       required where a result's capacity is too small
//   ptpu_aoti_destroy(h) / ptpu_aoti_last_error()
//   ptpu_aoti_call_op(op, device, args[], ..., scalars[], ..., results[])
//       one registered op called by name, with no package
//   ptpu_aoti_launches(kernel) (torch_ops.cc)
//
// A package carries its signature in its metadata (`ptpu_inputs`,
// `ptpu_outputs`: "dtype:dim,dim;..." with "b" the batch), which the
// runner checks every call against. The LSTM's and the GRU's forwards are
// extern calls in a package, which the loader resolves by name in the
// dispatcher (and refuses, naming the op, where one is not registered):
// this library registers them (torch_ops.cc). It links libtorch (and, in the
// CUDA flavour, libtorch_cuda and the kernel libraries), never libpython.

#include <ATen/ATen.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <c10/util/Exception.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <sys/stat.h>

#include <algorithm>
#include <cstring>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

#include "aoti_capi.h"

namespace {

thread_local std::string g_err;

// one entry of a package's signature: a dtype and dims, -1 the batch
struct Spec {
  int32_t dtype;
  std::vector<int64_t> dims;
};

struct Runner {
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  c10::Device device{c10::kCPU};
  std::vector<Spec> inputs, outputs;
};

const char* const kTags[] = {"f32", "i32", "i64", "pred",
                             "u8",  "f64", "bf16"};
const at::ScalarType kTypes[] = {at::kFloat, at::kInt,    at::kLong,
                                 at::kBool,  at::kByte,   at::kDouble,
                                 at::kBFloat16};
const int64_t kSizes[] = {4, 4, 8, 1, 1, 8, 2};
constexpr int kNumTypes = 7;

int dtype_of(const std::string& tag) {
  for (int i = 0; i < kNumTypes; ++i)
    if (tag == kTags[i]) return i;
  return -1;
}

int dtype_of(at::ScalarType t) {
  for (int i = 0; i < kNumTypes; ++i)
    if (t == kTypes[i]) return i;
  return -1;
}

std::vector<std::string> split(const std::string& s, char sep) {
  std::vector<std::string> out;
  std::string cur;
  std::istringstream in(s);
  while (std::getline(in, cur, sep)) out.push_back(cur);
  return out;
}

// "f32:b,7;i32:b" -> specs; throws on a malformed entry
std::vector<Spec> parse_specs(const std::string& key, const std::string& s) {
  std::vector<Spec> specs;
  for (const std::string& entry : split(s, ';')) {
    const size_t colon = entry.find(':');
    TORCH_CHECK(colon != std::string::npos, "package metadata ", key,
                ": malformed entry '", entry, "'");
    Spec spec;
    spec.dtype = dtype_of(entry.substr(0, colon));
    TORCH_CHECK(spec.dtype >= 0, "package metadata ", key,
                ": unknown dtype in '", entry, "'");
    for (const std::string& d : split(entry.substr(colon + 1), ','))
      spec.dims.push_back(d == "b" ? -1 : std::stoll(d));
    specs.push_back(spec);
  }
  return specs;
}

std::string describe(const Spec& s) {
  std::ostringstream o;
  o << kTags[s.dtype] << "[";
  for (size_t i = 0; i < s.dims.size(); ++i)
    o << (i ? ", " : "") << (s.dims[i] < 0 ? std::string("b")
                                           : std::to_string(s.dims[i]));
  o << "]";
  return o.str();
}

std::string describe(const ptpu_aoti_tensor& t) {
  std::ostringstream o;
  o << (t.dtype >= 0 && t.dtype < kNumTypes ? kTags[t.dtype] : "dtype?")
    << "[";
  for (int i = 0; i < t.rank; ++i) o << (i ? ", " : "") << t.dims[i];
  o << "]";
  return o.str();
}

// the device a runner is asked for: "cpu", "cuda" or "cuda:N"
c10::Device parse_device(const std::string& name) {
  TORCH_CHECK(name == "cpu" || name.rfind("cuda", 0) == 0,
              "unknown device '", name, "': cpu, cuda or cuda:N");
  const c10::Device dev(name);
  if (dev.is_cuda()) {
#ifdef PTPU_WITH_CUDA
    TORCH_CHECK(at::hasCUDA(), "no CUDA device: the runner was asked for '",
                name, "' and this host has no card it can use");
    TORCH_CHECK(!dev.has_index() || (size_t)dev.index() < at::getNumGPUs(),
                "no CUDA device ", name, ": this host has ",
                at::getNumGPUs());
#else
    TORCH_CHECK(false, "no CUDA device: the runner was asked for '", name,
                "' but is the CPU flavour, built with no CUDA (build the "
                "cuda flavour on a host with a card)");
#endif
  }
  return dev;
}

Runner* create(const std::string& path, const std::string& device) {
  struct stat st;
  TORCH_CHECK(::stat(path.c_str(), &st) == 0 && S_ISREG(st.st_mode),
              "no package at ", path);
  auto runner = std::make_unique<Runner>();
  runner->device = parse_device(device);
  const auto meta =
      torch::inductor::AOTIModelPackageLoader::load_metadata_from_package(
          path, "model");
  auto get = [&](const char* key) -> std::string {
    auto it = meta.find(key);
    TORCH_CHECK(it != meta.end(), "package ", path, " has no ", key,
                " metadata: not written by paddle_tpu_torch.io.merged_model");
    return it->second;
  };
  const std::string built_for = get("AOTI_DEVICE_KEY");
  TORCH_CHECK(built_for == c10::DeviceTypeName(runner->device.type(), true),
              "package ", path, " is compiled for ", built_for,
              ", asked to run on ", device);
  runner->inputs = parse_specs("ptpu_inputs", get("ptpu_inputs"));
  runner->outputs = parse_specs("ptpu_outputs", get("ptpu_outputs"));
  runner->loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
      path, "model", false, 1,
      runner->device.is_cuda() && runner->device.has_index()
          ? runner->device.index()
          : -1);
  return runner.release();
}

// a host tensor of the ABI as an ATen tensor on `device` (a view of its
// bytes on the CPU)
at::Tensor tensor_on(const ptpu_aoti_tensor& a, c10::Device device) {
  at::Tensor t = at::from_blob(a.data, at::IntArrayRef(a.dims, a.rank),
                               at::TensorOptions().dtype(kTypes[a.dtype]));
  return device.is_cpu() ? t : t.to(device);
}

// the args as tensors on the package's device, checked against its
// signature
std::vector<at::Tensor> arguments(const Runner& r,
                                  const ptpu_aoti_tensor* args,
                                  int32_t nargs) {
  TORCH_CHECK(nargs == (int32_t)r.inputs.size(), "the package takes ",
              r.inputs.size(), " inputs, got ", nargs);
  int64_t batch = -1;
  std::vector<at::Tensor> out;
  for (int32_t i = 0; i < nargs; ++i) {
    const ptpu_aoti_tensor& a = args[i];
    const Spec& s = r.inputs[i];
    bool ok = a.dtype == s.dtype && a.rank == (int32_t)s.dims.size();
    int64_t elems = 1;
    for (int32_t d = 0; ok && d < a.rank; ++d) {
      elems *= a.dims[d];
      if (s.dims[d] >= 0) {
        ok = a.dims[d] == s.dims[d];
      } else {
        ok = a.dims[d] >= 1 && (batch < 0 || a.dims[d] == batch);
        batch = a.dims[d];
      }
    }
    TORCH_CHECK(ok, "input ", i, " must be ", describe(s), " (one b across "
                "the inputs), got ", describe(a));
    TORCH_CHECK(a.size_bytes == elems * kSizes[a.dtype], "input ", i,
                ": size_bytes ", a.size_bytes, " for ", describe(a));
    out.push_back(tensor_on(a, r.device));
  }
  return out;
}

// `outs` copied into the caller's result buffers: 0, or -2 where one is
// short (each then describes what it needs)
int write_results(const std::vector<at::Tensor>& outs,
                  ptpu_aoti_tensor* results, int32_t nresults) {
  bool short_capacity = false;
  for (int32_t i = 0; i < nresults; ++i) {
    const at::Tensor t = outs[i].to(at::kCPU).contiguous();
    ptpu_aoti_tensor& res = results[i];
    const int dt = dtype_of(t.scalar_type());
    TORCH_CHECK(dt >= 0 && t.dim() <= PTPU_AOTI_MAX_RANK, "result ", i,
                ": unsupported ", t.scalar_type(), " of rank ", t.dim());
    const int64_t need = (int64_t)t.nbytes();
    const int64_t capacity = res.size_bytes;
    res.dtype = dt;
    res.rank = (int32_t)t.dim();
    for (int64_t d = 0; d < t.dim(); ++d) res.dims[d] = t.size(d);
    res.size_bytes = need;
    if (need > capacity || (need > 0 && res.data == nullptr)) {
      short_capacity = true;
      continue;
    }
    if (need) std::memcpy(res.data, t.data_ptr(), need);
  }
  return short_capacity ? -2 : 0;
}

int execute(Runner* r, const ptpu_aoti_tensor* args, int32_t nargs,
            ptpu_aoti_tensor* results, int32_t nresults) {
  TORCH_CHECK(nresults >= 0 && nresults <= (int32_t)r->outputs.size(),
              "the package has ", r->outputs.size(), " results, asked for ",
              nresults);
  std::vector<at::Tensor> outs = r->loader->run(arguments(*r, args, nargs));
  TORCH_CHECK(outs.size() == r->outputs.size(), "the package returned ",
              outs.size(), " results, its signature names ",
              r->outputs.size());
  return write_results(outs, results, nresults);
}

bool is_tensor(const c10::TypePtr& type) {
  return type->kind() == c10::TypeKind::TensorType;
}

int call_op(const std::string& name, const std::string& device,
            const ptpu_aoti_tensor* args, int32_t nargs,
            const int64_t* scalars, int32_t nscalars,
            ptpu_aoti_tensor* results, int32_t nresults) {
  const c10::Device dev = parse_device(device);
  const auto op = c10::Dispatcher::singleton().findSchema({name, ""});
  TORCH_CHECK(op.has_value(), "no op ", name, " is registered here");
  std::vector<c10::IValue> stack;
  int32_t ti = 0, si = 0;
  for (const c10::Argument& arg : op->schema().arguments()) {
    const c10::TypePtr& type = arg.type();
    const auto* opt = type->castRaw<c10::OptionalType>();
    if (is_tensor(type) || (opt && is_tensor(opt->getElementType()))) {
      TORCH_CHECK(ti < nargs, name, " takes more than the ", nargs,
                  " tensors given");
      const ptpu_aoti_tensor& a = args[ti++];
      TORCH_CHECK(a.dtype >= 0 && a.dtype < kNumTypes && a.rank >= 0 &&
                      a.rank <= PTPU_AOTI_MAX_RANK,
                  name, " argument ", arg.name(), ": bad tensor ",
                  describe(a));
      if (opt && a.data == nullptr) {
        stack.emplace_back();
        continue;
      }
      int64_t elems = 1;
      for (int32_t d = 0; d < a.rank; ++d) elems *= a.dims[d];
      TORCH_CHECK(a.size_bytes == elems * kSizes[a.dtype], name,
                  " argument ", arg.name(), ": size_bytes ", a.size_bytes,
                  " for ", describe(a));
      stack.emplace_back(tensor_on(a, dev));
    } else if (type->kind() == c10::TypeKind::IntType ||
               type->kind() == c10::TypeKind::BoolType) {
      TORCH_CHECK(si < nscalars, name, " takes more than the ", nscalars,
                  " ints given");
      const int64_t v = scalars[si++];
      if (type->kind() == c10::TypeKind::BoolType) {
        stack.emplace_back(v != 0);
      } else {
        stack.emplace_back(v);
      }
    } else {
      TORCH_CHECK(false, name, " argument ", arg.name(), ": type ",
                  type->str(), " is not one call_op passes");
    }
  }
  TORCH_CHECK(ti == nargs && si == nscalars, name, " takes ", ti,
              " tensors and ", si, " ints, got ", nargs, " and ", nscalars);
  op->callBoxed(&stack);
  std::vector<at::Tensor> outs;
  for (const c10::IValue& v : stack) outs.push_back(v.toTensor());
  TORCH_CHECK(nresults >= 0, "a negative number of results");
  const int rc = write_results(
      outs, results, std::min<int32_t>(nresults, (int32_t)outs.size()));
  return rc == 0 ? (int)outs.size() : rc;
}

template <typename F>
auto guarded(F f, decltype(f()) on_error) -> decltype(f()) {
  try {
    return f();
  } catch (const c10::Error& e) {
    g_err = e.what_without_backtrace();
  } catch (const std::exception& e) {
    g_err = e.what();
  }
  return on_error;
}

}  // namespace

extern "C" {

void* ptpu_aoti_create(const char* package_path, const char* device) {
  return guarded(
      [&]() -> void* {
        TORCH_CHECK(package_path && device, "null package path or device");
        return create(package_path, device);
      },
      nullptr);
}

int ptpu_aoti_num_outputs(void* h) {
  if (h == nullptr) {
    g_err = "null runner";
    return -1;
  }
  return (int)static_cast<Runner*>(h)->outputs.size();
}

int ptpu_aoti_execute_n(void* h, const ptpu_aoti_tensor* args,
                        int32_t num_args, ptpu_aoti_tensor* results,
                        int32_t num_results) {
  if (h == nullptr) {
    g_err = "null runner";
    return -1;
  }
  return guarded(
      [&]() {
        return execute(static_cast<Runner*>(h), args, num_args, results,
                       num_results);
      },
      -1);
}

void ptpu_aoti_destroy(void* h) { delete static_cast<Runner*>(h); }

int ptpu_aoti_call_op(const char* op, const char* device,
                      const ptpu_aoti_tensor* args, int32_t num_args,
                      const int64_t* scalars, int32_t num_scalars,
                      ptpu_aoti_tensor* results, int32_t num_results) {
  return guarded(
      [&]() {
        TORCH_CHECK(op && device, "null op or device");
        return call_op(op, device, args, num_args, scalars, num_scalars,
                       results, num_results);
      },
      -1);
}

const char* ptpu_aoti_last_error(void) { return g_err.c_str(); }

}  // extern "C"
