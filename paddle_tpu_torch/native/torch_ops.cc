// The recurrent forwards as dispatcher ops in C++, for the native runner
// (aoti_runner.cc): `paddle_tpu_torch::lstm_fwd` and `::gru_fwd`, the
// schemas of kernels/lstm.py and kernels/gru.py letter for letter, so that
// an AOTInductor package, which keeps each as an extern call through its
// proxy executor, finds them in a process with no Python.
//
// - The CPU implementations are the plain versions' math in ATen
//   (kernels/lstm.py fused_lstm_plain, kernels/gru.py fused_gru_plain): the
//   gate order, the mask-gated carry, the segment reset and the stash, and
//   on bf16 the plain versions' bf16 rule (float32 carries, each product's
//   operands rounded to bf16, the outputs rounded).
// - The CUDA implementations (built with PTPU_WITH_CUDA) make the Python
//   wrappers' checks (kernels/lstm.py _lstm_fwd_cuda, kernels/gru.py
//   _gru_fwd_cuda), resolve the plan at the batch they are given
//   (plans.h), and call the kernels' C entry points (csrc/lstm_fwd.cu
//   lstm_fwd and lstm_fwd_bf16, csrc/gru_fwd.cu gru_fwd, gru_fwd_bf16,
//   gru_fwd_cluster and gru_fwd_cluster_bf16)
//   on the current stream; the libraries kernels/_build.py builds from those sources are
//   linked in. A CUDA tensor launches the kernel or raises, with the
//   kernel's error string: nothing falls back to the plain version.
//
// This is host code: g++ compiles it against torch's and CUDA's headers.
// Its registrations collide with the Python ones (kernels/lstm.py
// defines the same schema), so it runs in a process of its own: the
// runner's, never one that imported paddle_tpu_torch.

#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <cstring>
#include <optional>
#include <tuple>
#include <vector>

#include "aoti_capi.h"
#include "plans.h"

#ifdef PTPU_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <map>
#include <mutex>

// the kernels' C entry points (csrc/lstm_fwd.cu, csrc/gru_fwd.cu)
extern "C" {
int lstm_fwd(const float* x4, const float* w, const float* bias,
             const float* mask, const float* reset, float* hs, float* cs,
             float* gates, int B, int T, int H, int U, int R, void* stream);
const char* lstm_fwd_error_string(int err);
// the bf16 forms: the bf16 tensors passed as untyped pointers (this host
// code has no bf16 type of CUDA's)
int lstm_fwd_bf16(const void* x4, const void* w, const void* bias,
                  const float* mask, const float* reset, void* hs, void* cs,
                  void* gates, int B, int T, int H, int U, int R,
                  void* stream);
const char* lstm_fwd_bf16_error_string(int err);
int gru_fwd(const float* x3, const float* wg, const float* wc,
            const float* bias, const float* mask, const float* reset,
            float* hs, float* gates, float* scratch, int B, int T, int H,
            void* stream);
int gru_fwd_max_coresident_blocks(int B, int H);
const char* gru_fwd_error_string(int err);
int gru_fwd_cluster(const float* x3, const float* wg, const float* wc,
                    const float* bias, const float* mask, const float* reset,
                    float* hs, float* gates, int B, int T, int H, int C, int R,
                    void* stream);
const char* gru_fwd_cluster_error_string(int err);
int gru_fwd_bf16(const void* x3, const void* wg, const void* wc,
                 const void* bias, const float* mask, const float* reset,
                 void* hs, void* gates, float* scratch, int B, int T, int H,
                 void* stream);
int gru_fwd_bf16_max_coresident_blocks(int B, int H);
const char* gru_fwd_bf16_error_string(int err);
int gru_fwd_cluster_bf16(const void* x3, const void* wg, const void* wc,
                         const void* bias, const float* mask,
                         const float* reset, void* hs, void* gates, int B,
                         int T, int H, int C, int R, void* stream);
const char* gru_fwd_cluster_bf16_error_string(int err);
}
#endif

namespace {

using at::Tensor;
using Lstm = std::tuple<Tensor, Tensor, Tensor>;
using Gru = std::tuple<Tensor, Tensor>;

// the launches of each kernel, counted where the op launches it
// (kernels.launches' names), and the calls of the CPU implementations
std::atomic<int64_t> g_fused_lstm{0}, g_fused_lstm_bf16{0}, g_fused_gru{0},
    g_fused_gru_cluster{0}, g_fused_gru_bf16{0}, g_fused_gru_cluster_bf16{0},
    g_lstm_fwd_cpu{0}, g_gru_fwd_cpu{0};

std::vector<int64_t> dims(const Tensor& a) { return a.sizes().vec(); }

// kernels/lstm.py _check_shapes: (B, T, H)
std::tuple<int64_t, int64_t, int64_t> lstm_shapes(
    const Tensor& x4, const Tensor& w, const Tensor& bias, const Tensor& mask,
    const std::optional<Tensor>& reset) {
  TORCH_CHECK(x4.dim() == 3 && x4.size(2) % 4 == 0,
              "fused_lstm: x4 must be [B, T, 4H], got ", x4.sizes());
  const int64_t B = x4.size(0), T = x4.size(1), H4 = x4.size(2), H = H4 / 4;
  TORCH_CHECK(B >= 1 && T >= 1 && H >= 1, "fused_lstm: empty input ",
              x4.sizes());
  TORCH_CHECK(dims(w) == std::vector<int64_t>({H, H4}),
              "fused_lstm: w must be [", H, ", ", H4, "], got ", w.sizes());
  TORCH_CHECK(dims(bias) == std::vector<int64_t>({7 * H}),
              "fused_lstm: bias must be [", 7 * H, "], got ", bias.sizes());
  TORCH_CHECK(dims(mask) == std::vector<int64_t>({B, T}),
              "fused_lstm: mask must be [", B, ", ", T, "], got ",
              mask.sizes());
  TORCH_CHECK(!reset || dims(*reset) == std::vector<int64_t>({B, T}),
              "fused_lstm: reset must be None or [", B, ", ", T, "]");
  return {B, T, H};
}

// kernels/gru.py _check_shapes: (B, T, H)
std::tuple<int64_t, int64_t, int64_t> gru_shapes(
    const Tensor& x3, const Tensor& wg, const Tensor& wc, const Tensor& bias,
    const Tensor& mask, const std::optional<Tensor>& reset) {
  TORCH_CHECK(x3.dim() == 3 && x3.size(2) % 3 == 0,
              "fused_gru: x3 must be [B, T, 3H], got ", x3.sizes());
  const int64_t B = x3.size(0), T = x3.size(1), H3 = x3.size(2), H = H3 / 3;
  TORCH_CHECK(B >= 1 && T >= 1 && H >= 1, "fused_gru: empty input ",
              x3.sizes());
  TORCH_CHECK(dims(wg) == std::vector<int64_t>({H, 2 * H}),
              "fused_gru: wg must be [", H, ", ", 2 * H, "], got ",
              wg.sizes());
  TORCH_CHECK(dims(wc) == std::vector<int64_t>({H, H}),
              "fused_gru: wc must be [", H, ", ", H, "], got ", wc.sizes());
  TORCH_CHECK(dims(bias) == std::vector<int64_t>({H3}),
              "fused_gru: bias must be [", H3, "], got ", bias.sizes());
  TORCH_CHECK(dims(mask) == std::vector<int64_t>({B, T}),
              "fused_gru: mask must be [", B, ", ", T, "], got ",
              mask.sizes());
  TORCH_CHECK(!reset || dims(*reset) == std::vector<int64_t>({B, T}),
              "fused_gru: reset must be None or [", B, ", ", T, "]");
  return {B, T, H};
}

// a step's column of a [B, T] tensor as [B, 1], in x's dtype
Tensor column(const Tensor& a, int64_t t, const Tensor& x) {
  return a.select(1, t).unsqueeze(1).to(x.scalar_type());
}

// --- CPU: the plain versions ------------------------------------------------

// kernels/lstm.py and kernels/gru.py _arith: (the dtype bf16 computes in,
// float32; and the rounding of a product's operand to bf16); any other
// dtype computes in itself
at::ScalarType compute_dtype(const Tensor& x) {
  return x.scalar_type() == at::kBFloat16 ? at::kFloat : x.scalar_type();
}

Tensor rounded(const Tensor& a, bool bf) {
  return bf ? a.to(at::kBFloat16).to(at::kFloat) : a;
}

Lstm lstm_fwd_cpu(const Tensor& x4, const Tensor& w, const Tensor& bias,
                  const Tensor& mask, const std::optional<Tensor>& reset,
                  bool stash, int64_t units, int64_t rows) {
  const auto [B, T, H] = lstm_shapes(x4, w, bias, mask, reset);
  ++g_lstm_fwd_cpu;
  const bool bf = x4.scalar_type() == at::kBFloat16;
  const at::ScalarType cd = compute_dtype(x4);
  const Tensor xs = x4.to(cd), wc = w.to(cd), bc = bias.to(cd);
  Tensor h = at::zeros({B, H}, xs.options());
  Tensor c = at::zeros({B, H}, xs.options());
  const Tensor pi = bc.slice(0, 4 * H, 5 * H);
  const Tensor pf = bc.slice(0, 5 * H, 6 * H);
  const Tensor po = bc.slice(0, 6 * H, 7 * H);
  std::vector<Tensor> hs, cs, gates;
  for (int64_t t = 0; t < T; ++t) {
    if (reset) {
      const Tensor p = 1.0 - column(*reset, t, xs);
      h = p * h;
      c = p * c;
    }
    Tensor pre = xs.select(1, t) + at::matmul(rounded(h, bf), wc);
    pre = pre + bc.slice(0, 0, 4 * H);
    const Tensor i = at::sigmoid(pre.slice(1, 0, H) + pi * c);
    const Tensor f = at::sigmoid(pre.slice(1, H, 2 * H) + pf * c);
    const Tensor g = at::tanh(pre.slice(1, 2 * H, 3 * H));
    const Tensor c_new = f * c + i * g;
    const Tensor o = at::sigmoid(pre.slice(1, 3 * H) + po * c_new);
    const Tensor h_new = o * at::tanh(c_new);
    const Tensor m = column(mask, t, xs);
    h = m * h_new + (1.0 - m) * h;
    c = m * c_new + (1.0 - m) * c;
    hs.push_back(h);
    cs.push_back(c);
    if (stash) gates.push_back(at::cat({i, f, g, o}, -1));
  }
  const at::ScalarType out = x4.scalar_type();
  return {at::stack(hs, 1).to(out), at::stack(cs, 1).to(out),
          stash ? at::stack(gates, 1).to(out) : at::empty({0}, x4.options())};
}

Gru gru_fwd_cpu(const Tensor& x3, const Tensor& wg, const Tensor& wc,
                const Tensor& bias, const Tensor& mask,
                const std::optional<Tensor>& reset, bool stash, int64_t path,
                int64_t C, int64_t R) {
  const auto [B, T, H] = gru_shapes(x3, wg, wc, bias, mask, reset);
  ++g_gru_fwd_cpu;
  const bool bf = x3.scalar_type() == at::kBFloat16;
  const at::ScalarType cd = compute_dtype(x3);
  const auto rnd = [bf](const Tensor& a) { return rounded(a, bf); };
  const Tensor xs = x3.to(cd), wgc = wg.to(cd), wcc = wc.to(cd),
               bc = bias.to(cd);
  Tensor h = at::zeros({B, H}, xs.options());
  std::vector<Tensor> hs, gates;
  for (int64_t t = 0; t < T; ++t) {
    if (reset) h = (1.0 - column(*reset, t, xs)) * h;
    const Tensor x = xs.select(1, t);
    const Tensor g = (x.slice(1, 0, 2 * H) + at::matmul(rnd(h), wgc)) +
                     bc.slice(0, 0, 2 * H);
    const Tensor z = at::sigmoid(g.slice(1, 0, H));
    const Tensor r = at::sigmoid(g.slice(1, H));
    const Tensor c =
        at::tanh((x.slice(1, 2 * H) + at::matmul(rnd(r * h), wcc)) +
                 bc.slice(0, 2 * H));
    const Tensor h_new = z * h + (1.0 - z) * c;
    const Tensor m = column(mask, t, xs);
    h = m * h_new + (1.0 - m) * h;
    hs.push_back(h);
    if (stash) gates.push_back(at::cat({z, r, c}, -1));
  }
  return {at::stack(hs, 1).to(x3.scalar_type()),
          stash ? at::stack(gates, 1).to(x3.scalar_type())
                : at::empty({0}, x3.options())};
}

#ifdef PTPU_WITH_CUDA

// --- CUDA: the kernels ------------------------------------------------------

// kernels/_build.py check_cuda_tensors
void check_cuda_tensors(const char* kernel, const std::vector<Tensor>& ts,
                        at::ScalarType dtype = at::kFloat) {
  const c10::Device dev = ts[0].device();
  TORCH_CHECK(dev.is_cuda(), kernel, ": no kernel for device ", dev);
  for (const Tensor& a : ts) {
    TORCH_CHECK(a.device() == dev, kernel, ": tensors on ", a.device(),
                " and ", dev);
    TORCH_CHECK(a.scalar_type() == dtype, kernel, ": the kernel takes ",
                dtype == at::kFloat ? "float32" : "bfloat16", ", got ",
                a.scalar_type());
    TORCH_CHECK(a.is_contiguous(), kernel,
                ": the kernel takes contiguous tensors");
  }
}

std::vector<Tensor> with_reset(std::vector<Tensor> ts,
                               const std::optional<Tensor>& reset) {
  if (reset) ts.push_back(*reset);
  return ts;
}

const float* ptr(const std::optional<Tensor>& a) {
  return a ? a->data_ptr<float>() : nullptr;
}

void* stream_of(const Tensor& a) {
  return c10::cuda::getCurrentCUDAStream(a.device().index()).stream();
}

// the bf16 form's inputs (kernels/lstm.py and kernels/gru.py
// _check_tensors): the data bf16, mask and reset float32 on the data's
// device, H a multiple of 8
void check_bf16(const char* kernel, const std::vector<Tensor>& data,
                const Tensor& m32, const std::optional<Tensor>& r32,
                int64_t H) {
  check_cuda_tensors(kernel, data, at::kBFloat16);
  check_cuda_tensors(kernel, with_reset({m32}, r32));
  TORCH_CHECK(m32.device() == data[0].device(), kernel, ": tensors on ",
              m32.device(), " and ", data[0].device());
  TORCH_CHECK(H % 8 == 0, kernel,
              ": the bf16 form takes H a multiple of 8, got H=", H);
}

// the mask or reset as the bf16 forms take it: float32 (0 and 1 exactly)
std::optional<Tensor> flag(const std::optional<Tensor>& a) {
  return a ? std::optional<Tensor>(a->to(at::kFloat)) : a;
}

Lstm lstm_fwd_cuda(const Tensor& x4, const Tensor& w, const Tensor& bias,
                   const Tensor& mask, const std::optional<Tensor>& reset,
                   bool stash, int64_t units, int64_t rows) {
  const auto [B, T, H] = lstm_shapes(x4, w, bias, mask, reset);
  const bool bf = x4.scalar_type() == at::kBFloat16;
  const Tensor m32 = bf ? mask.to(at::kFloat) : mask;
  const std::optional<Tensor> r32 = bf ? flag(reset) : reset;
  if (bf)
    check_bf16("fused_lstm", {x4, w, bias}, m32, r32, H);
  else
    check_cuda_tensors("fused_lstm", with_reset({x4, w, bias, mask}, reset));
  ptpu::LstmFwdPlan plan;
  if (units) {
    TORCH_CHECK(ptpu::lstm_forced_plan(B, H, units, rows, &plan, bf),
                "fused_lstm: no forward of U=", units, " units and R=", rows,
                " rows a block at B=", B, ", H=", H,
                " whose blocks fit an H100 at once");
  } else {
    TORCH_CHECK(ptpu::lstm_fwd_plan(B, H, &plan, bf),
                "fused_lstm: no forward whose blocks fit an H100 at once at "
                "B=",
                B, ", H=", H, " for ", x4.scalar_type());
  }
  const c10::cuda::CUDAGuard guard(x4.device());
  const Tensor hs = at::empty({B, T, H}, x4.options());
  const Tensor cs = at::empty_like(hs);
  const Tensor gates =
      stash ? at::empty_like(x4) : at::empty({0}, x4.options());
  if (bf) {
    const int err = lstm_fwd_bf16(
        x4.data_ptr(), w.data_ptr(), bias.data_ptr(), m32.data_ptr<float>(),
        ptr(r32), hs.data_ptr(), cs.data_ptr(),
        stash ? gates.data_ptr() : nullptr, (int)B, (int)T, (int)H,
        (int)plan.U, (int)plan.R, stream_of(x4));
    TORCH_CHECK(err == 0, "lstm_fwd_bf16: launch failed: CUDA error ", err,
                " (", lstm_fwd_bf16_error_string(err), ")");
    ++g_fused_lstm_bf16;
    return {hs, cs, gates};
  }
  const int err = lstm_fwd(
      x4.data_ptr<float>(), w.data_ptr<float>(), bias.data_ptr<float>(),
      mask.data_ptr<float>(), ptr(reset), hs.data_ptr<float>(),
      cs.data_ptr<float>(), stash ? gates.data_ptr<float>() : nullptr,
      (int)B, (int)T, (int)H, (int)plan.U, (int)plan.R, stream_of(x4));
  TORCH_CHECK(err == 0, "lstm_fwd: launch failed: CUDA error ", err, " (",
              lstm_fwd_error_string(err), ")");
  ++g_fused_lstm;
  return {hs, cs, gates};
}

// kernels/_build.py CooperativeKernel._check for gru_fwd or its bf16
// form: H / 4 blocks, all resident at once (the capacity asked once per
// form, B, H and device)
void check_coresident(int64_t B, int64_t H, int device, bool bf) {
  static std::mutex mu;
  static std::map<std::tuple<bool, int64_t, int64_t, int>, int> capacity;
  const char* name = bf ? "gru_fwd_bf16" : "gru_fwd";
  TORCH_CHECK(H % ptpu::kGruUnits == 0, name, ": H=", H,
              " is not a multiple of ", ptpu::kGruUnits);
  int cap;
  {
    const std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(bf, B, H, device);
    auto it = capacity.find(key);
    if (it == capacity.end()) {
      cap = bf ? gru_fwd_bf16_max_coresident_blocks((int)B, (int)H)
               : gru_fwd_max_coresident_blocks((int)B, (int)H);
      TORCH_CHECK(cap >= 0, name, ": occupancy query failed: CUDA error ",
                  -cap, " (", gru_fwd_error_string(-cap), ")");
      capacity[key] = cap;
    } else {
      cap = it->second;
    }
  }
  TORCH_CHECK(H / ptpu::kGruUnits <= cap, name, ": B=", B, ", H=", H,
              " needs ", H / ptpu::kGruUnits,
              " co-resident blocks, the device holds ", cap);
}

Gru gru_fwd_cuda(const Tensor& x3, const Tensor& wg, const Tensor& wc,
                 const Tensor& bias, const Tensor& mask,
                 const std::optional<Tensor>& reset, bool stash, int64_t path,
                 int64_t C, int64_t R) {
  const auto [B, T, H] = gru_shapes(x3, wg, wc, bias, mask, reset);
  const bool bf = x3.scalar_type() == at::kBFloat16;
  // kernels/gru.py _gru_fwd_cuda: the bf16 form takes the mask and the
  // reset as float32 (0 and 1 exactly) and H a multiple of 8
  const Tensor m32 = bf ? mask.to(at::kFloat) : mask;
  const std::optional<Tensor> r32 = bf ? flag(reset) : reset;
  if (bf) {
    check_bf16("fused_gru", {x3, wg, wc, bias}, m32, r32, H);
  } else {
    check_cuda_tensors("fused_gru",
                       with_reset({x3, wg, wc, bias, mask}, reset));
  }
  ptpu::GruFwdPlan plan;
  if (path == ptpu::kGruAuto) {
    plan = ptpu::gru_fwd_plan(B, H, bf);
  } else if (path == ptpu::kGruCluster) {
    TORCH_CHECK(ptpu::gru_cluster_plan(H, C, R, &plan, bf),
                "fused_gru: no cluster kernel of C=", C, " blocks and R=", R,
                " rows at H=", H, " within ", ptpu::kSmemPerBlock,
                " bytes of shared memory");
  } else {
    plan = ptpu::gru_grid_plan(H);
  }
  const c10::cuda::CUDAGuard guard(x3.device());
  const Tensor hs = at::empty({B, T, H}, x3.options());
  const Tensor gates =
      stash ? at::empty_like(x3) : at::empty({0}, x3.options());
  if (bf && plan.path == ptpu::kGruCluster) {
    const int err = gru_fwd_cluster_bf16(
        x3.data_ptr(), wg.data_ptr(), wc.data_ptr(), bias.data_ptr(),
        m32.data_ptr<float>(), ptr(r32), hs.data_ptr(),
        stash ? gates.data_ptr() : nullptr, (int)B, (int)T, (int)H,
        (int)plan.C, (int)plan.R, stream_of(x3));
    TORCH_CHECK(err == 0, "gru_fwd_cluster_bf16: launch failed: CUDA error ",
                err, " (", gru_fwd_cluster_bf16_error_string(err), ")");
    ++g_fused_gru_cluster_bf16;
    return {hs, gates};
  }
  if (bf) {
    check_coresident(B, H, x3.device().index(), true);
    // r*h_{t-1}, z and the float32 carry, exchanged between blocks
    const Tensor scratch = at::empty({3, B, H}, m32.options());
    const int err = gru_fwd_bf16(
        x3.data_ptr(), wg.data_ptr(), wc.data_ptr(), bias.data_ptr(),
        m32.data_ptr<float>(), ptr(r32), hs.data_ptr(),
        stash ? gates.data_ptr() : nullptr, scratch.data_ptr<float>(),
        (int)B, (int)T, (int)H, stream_of(x3));
    TORCH_CHECK(err == 0, "gru_fwd_bf16: launch failed: CUDA error ", err,
                " (", gru_fwd_bf16_error_string(err), ")");
    ++g_fused_gru_bf16;
    return {hs, gates};
  }
  float* gp = stash ? gates.data_ptr<float>() : nullptr;
  if (plan.path == ptpu::kGruCluster) {
    const int err = gru_fwd_cluster(
        x3.data_ptr<float>(), wg.data_ptr<float>(), wc.data_ptr<float>(),
        bias.data_ptr<float>(), mask.data_ptr<float>(), ptr(reset),
        hs.data_ptr<float>(), gp, (int)B, (int)T, (int)H, (int)plan.C,
        (int)plan.R, stream_of(x3));
    TORCH_CHECK(err == 0, "gru_fwd_cluster: launch failed: CUDA error ", err,
                " (", gru_fwd_cluster_error_string(err), ")");
    ++g_fused_gru_cluster;
    return {hs, gates};
  }
  check_coresident(B, H, x3.device().index(), false);
  // r*h_{t-1} and z of the current step, exchanged between blocks
  const Tensor scratch = at::empty({2, B, H}, x3.options());
  const int err = gru_fwd(
      x3.data_ptr<float>(), wg.data_ptr<float>(), wc.data_ptr<float>(),
      bias.data_ptr<float>(), mask.data_ptr<float>(), ptr(reset),
      hs.data_ptr<float>(), gp, scratch.data_ptr<float>(), (int)B, (int)T,
      (int)H, stream_of(x3));
  TORCH_CHECK(err == 0, "gru_fwd: launch failed: CUDA error ", err, " (",
              gru_fwd_error_string(err), ")");
  ++g_fused_gru;
  return {hs, gates};
}

#endif  // PTPU_WITH_CUDA

}  // namespace

TORCH_LIBRARY_FRAGMENT(paddle_tpu_torch, m) {
  m.def(
      "lstm_fwd(Tensor x4, Tensor w, Tensor bias, Tensor mask, "
      "Tensor? reset, bool stash, int units, int rows) "
      "-> (Tensor, Tensor, Tensor)");
  m.def(
      "gru_fwd(Tensor x3, Tensor wg, Tensor wc, Tensor bias, "
      "Tensor mask, Tensor? reset, bool stash, int path, int C, int R) "
      "-> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(paddle_tpu_torch, CPU, m) {
  m.impl("lstm_fwd", &lstm_fwd_cpu);
  m.impl("gru_fwd", &gru_fwd_cpu);
}

#ifdef PTPU_WITH_CUDA
TORCH_LIBRARY_IMPL(paddle_tpu_torch, CUDA, m) {
  m.impl("lstm_fwd", &lstm_fwd_cuda);
  m.impl("gru_fwd", &gru_fwd_cuda);
}
#endif

extern "C" {

int64_t ptpu_aoti_launches(const char* kernel) {
  if (std::strcmp(kernel, "fused_lstm") == 0) return g_fused_lstm.load();
  if (std::strcmp(kernel, "fused_lstm_bf16") == 0)
    return g_fused_lstm_bf16.load();
  if (std::strcmp(kernel, "fused_gru") == 0) return g_fused_gru.load();
  if (std::strcmp(kernel, "fused_gru_cluster") == 0)
    return g_fused_gru_cluster.load();
  if (std::strcmp(kernel, "fused_gru_bf16") == 0)
    return g_fused_gru_bf16.load();
  if (std::strcmp(kernel, "fused_gru_cluster_bf16") == 0)
    return g_fused_gru_cluster_bf16.load();
  if (std::strcmp(kernel, "lstm_fwd_cpu") == 0) return g_lstm_fwd_cpu.load();
  if (std::strcmp(kernel, "gru_fwd_cpu") == 0) return g_gru_fwd_cpu.load();
  return -1;
}

}  // extern "C"
