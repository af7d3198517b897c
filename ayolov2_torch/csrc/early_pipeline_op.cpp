// The operator ayolov2::early_pipeline registered from C++, for processes
// without Python: the native runner (csrc/aoti_runner.cpp) serving an
// AOTInductor package whose graph calls the operator through its proxy
// executor.
//
// The schema is the one torch.library.custom_op infers for the Python
// operator (ops/early_pipeline.py, early_pipeline_op), so that a package
// compiled in Python finds it here:
//
//   early_pipeline(Tensor images, Tensor wpack, SymInt c0, SymInt n,
//                  SymInt? c1=None, SymInt? ch=None, SymInt? c2=None) -> Tensor
//
// (bs, H, W, 3) uint8 images and the kernel's packed bf16 weights of widths
// c0, c1, ch, c2 (2 c0, c0, 4 c0 where left out) and C3 depth n ->
// (bs, H/8, W/8, c2) bf16 NHWC.
//
// - CPU: the plain version, the same ATen calls in the same order and dtypes
//   as early_pipeline_ref on the weights unpack_weights recovers from the
//   packed buffer, so that it equals the Python body bit for bit.
// - CUDA (built with -DAYOLOV2_WITH_CUDA): early_pipeline_launch of the
//   kernel's library for the padded width set (csrc/early_pipeline.cu, one
//   library per set), on the current stream, with the 14 ints of the
//   kernel's plan. Neither is known here: the caller passes both for each
//   width set through ayolov2_early_pipeline_configure before the first
//   call (the runner takes them from the package's sidecar, which the
//   packaging step writes from plan_early). A launch error raises, naming
//   the widths and the tile; nothing falls back to the CPU body.
//
// Never load this library into a Python process that has imported the
// Python operator: the two definitions of one name collide.

#include <ATen/core/Tensor.h>
#include <ATen/ops/add.h>
#include <ATen/ops/cat.h>
#include <ATen/ops/conv2d.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/pad.h>
#include <ATen/ops/silu.h>
#include <torch/library.h>

#include <dlfcn.h>

#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <optional>
#include <string>
#include <vector>

#ifdef AYOLOV2_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#endif

namespace {

using Widths = std::array<int64_t, 5>;  // c0, c1, ch, c2, n
constexpr int kPlanInts = 14;           // PLAN_FIELDS of ops/early_pipeline.py

Widths widths_of(int64_t c0, int64_t n, std::optional<int64_t> c1, std::optional<int64_t> ch,
                 std::optional<int64_t> c2) {
  return {c0, c1.value_or(2 * c0), ch.value_or(c0), c2.value_or(4 * c0), n};
}

std::string width_text(const Widths& w) {
  return "widths c0=" + std::to_string(w[0]) + " c1=" + std::to_string(w[1]) +
         " ch=" + std::to_string(w[2]) + " c2=" + std::to_string(w[3]) +
         " n=" + std::to_string(w[4]);
}

int64_t padded_width(int64_t c) { return c <= 160 ? (c + 15) / 16 * 16 : (c + 31) / 32 * 32; }

// k16 steps in one chunk of a layer with K = k: the largest of 4, 3, 2, 1
// that divides k / 16
int64_t steps_per_chunk(int64_t k) {
  for (int64_t c : {4, 3, 2, 1})
    if ((k / 16) % c == 0) return c;
  return 1;
}

// One product the kernel runs (_layers): taps, true and padded input and
// output channels. The stem is 9 taps of 12 space-to-depth planes, held as 16.
struct Layer {
  int64_t taps, cin, co, cin_p, co_p;
};

std::vector<Layer> layers(const Widths& w) {
  const int64_t c0 = w[0], c1 = w[1], ch = w[2], c2 = w[3], n = w[4];
  const int64_t p0 = padded_width(c0), p1 = padded_width(c1), ph = padded_width(ch),
                p2 = padded_width(c2);
  std::vector<Layer> out = {{9, 12, c0, 16, p0}, {9, c0, c1, p0, p1},
                            {1, c1, ch, p1, ph}, {1, c1, ch, p1, ph}};
  for (int64_t i = 0; i < n; ++i) {
    out.push_back({1, ch, ch, ph, ph});
    out.push_back({9, ch, ch, ph, ph});
  }
  out.push_back({2, ch, c1, ph, p1});
  out.push_back({9, c1, c2, p1, p2});
  return out;
}

// (co_p, K_p) of every product as packed: cv1 and cv2 are one product of
// 2 ch_p rows (packed_layout)
std::vector<std::pair<int64_t, int64_t>> packed_layout(const std::vector<Layer>& ls) {
  std::vector<std::pair<int64_t, int64_t>> out;
  for (size_t i = 0; i < ls.size(); ++i) {
    if (i == 3) continue;
    out.push_back({i == 2 ? 2 * ls[i].co_p : ls[i].co_p, ls[i].taps * ls[i].cin_p});
  }
  return out;
}

int64_t chunk_elems(int64_t co, int64_t k) { return co * 64 * (k / (16 * steps_per_chunk(k))); }

int64_t packed_numel(const Widths& w) {
  int64_t total = 0;
  for (auto [co, k] : packed_layout(layers(w))) total += chunk_elems(co, k) + co;
  return total;
}

// The true weights of one product: W (co, taps cin) and b (co,), bf16.
struct Conv {
  at::Tensor w, b;
};

// unpack_weights: every product's true matrix and bias out of the packed
// buffer. A chunk holds steps_per_chunk(K) k16 steps of 128-byte rows in
// the 128-byte-swizzle order: the 16-byte unit u of row r sits at u ^ (r % 8).
std::vector<Conv> unpack(const at::Tensor& wpack, const Widths& w) {
  const std::vector<Layer> ls = layers(w);
  const auto layout = packed_layout(ls);
  const uint16_t* src = reinterpret_cast<const uint16_t*>(wpack.data_ptr());
  std::vector<int64_t> mat_pos, bias_pos;
  int64_t pos = 0;
  for (auto [co, k] : layout) {
    mat_pos.push_back(pos);
    pos += chunk_elems(co, k);
  }
  for (auto [co, k] : layout) {
    bias_pos.push_back(pos);
    pos += co;
  }
  std::vector<Conv> out;
  for (size_t i = 0; i < ls.size(); ++i) {
    const Layer& l = ls[i];
    const size_t j = i < 3 ? i : i - 1;  // cv2 is the second half of product 2
    const int64_t row0 = i == 3 ? ls[2].co_p : 0;
    const int64_t co_p = layout[j].first, k = layout[j].second;
    const int64_t per = 16 * steps_per_chunk(k);
    at::Tensor wt = at::empty({l.co, l.taps * l.cin}, at::dtype(at::kBFloat16));
    at::Tensor bt = at::empty({l.co}, at::dtype(at::kBFloat16));
    uint16_t* dw = reinterpret_cast<uint16_t*>(wt.data_ptr());
    uint16_t* db = reinterpret_cast<uint16_t*>(bt.data_ptr());
    for (int64_t r = 0; r < l.co; ++r) {
      const int64_t row = row0 + r;
      for (int64_t t = 0; t < l.taps; ++t) {
        for (int64_t c = 0; c < l.cin; ++c) {
          const int64_t kk = t * l.cin_p + c, chunk = kk / per, within = kk % per;
          const int64_t unit = (within / 8) ^ (row % 8);
          dw[r * l.taps * l.cin + t * l.cin + c] =
              src[mat_pos[j] + (chunk * co_p + row) * 64 + unit * 8 + within % 8];
        }
      }
      db[r] = src[bias_pos[j] + row];
    }
    out.push_back({wt, bt});
  }
  return out;
}

void check_op(const at::Tensor& images, const at::Tensor& wpack, const Widths& w) {
  TORCH_CHECK(images.scalar_type() == at::kByte && images.dim() == 4 && images.size(3) == 3,
              "expected (bs, H, W, 3) uint8 images, got ", images.sizes(), " ",
              images.scalar_type());
  TORCH_CHECK(images.size(0) >= 1 && images.size(1) % 8 == 0 && images.size(2) % 8 == 0 &&
                  images.is_contiguous(),
              "image batch ", images.sizes(),
              ": need contiguous images, bs >= 1 and H, W multiples of 8");
  TORCH_CHECK(wpack.scalar_type() == at::kBFloat16 && wpack.device() == images.device() &&
                  wpack.dim() == 1 && wpack.is_contiguous(),
              "packed weights ", wpack.scalar_type(), " on ", wpack.device(),
              ": need one contiguous bf16 dimension on ", images.device());
  TORCH_CHECK(w[0] >= 1 && w[1] >= 1 && w[2] >= 1 && w[3] >= 1 && w[4] >= 1,
              "no early network of ", width_text(w));
  TORCH_CHECK(wpack.numel() == packed_numel(w), "packed weights of ", wpack.numel(),
              " elements do not hold ", width_text(w), " (", packed_numel(w), " elements)");
}

// _conv_silu: bf16 operands, f32 sums, bias + SiLU in f32, rounded to bf16;
// w (co, k k cin) in (kh, kw, cin) order
at::Tensor conv_silu(const at::Tensor& x, const Conv& c, int64_t k, int64_t stride = 1,
                     int64_t pad = 0) {
  const int64_t co = c.w.size(0), cin = x.size(1);
  at::Tensor wt = c.w.slice(1, 0, k * k * cin).to(at::kFloat).reshape({co, k, k, cin})
                      .permute({0, 3, 1, 2});
  at::Tensor y = at::conv2d(x.to(at::kFloat), wt, c.b.to(at::kFloat), {stride, stride},
                            {pad, pad});
  return at::silu(y).to(at::kBFloat16);
}

// early_pipeline_ref on the unpacked weights
at::Tensor early_pipeline_cpu(const at::Tensor& images, const at::Tensor& wpack, int64_t c0,
                              int64_t n, std::optional<int64_t> c1, std::optional<int64_t> ch,
                              std::optional<int64_t> c2) {
  const Widths w = widths_of(c0, n, c1, ch, c2);
  check_op(images, wpack, w);
  const std::vector<Conv> p = unpack(wpack, w);
  const int64_t bs = images.size(0), h = images.size(1), wd = images.size(2), cin = 3;
  at::Tensor x = at::pad(images.permute({0, 3, 1, 2}).to(at::kFloat), {2, 2, 2, 2});
  // space-to-depth planes in (p, q, c) order: s2d[a, b] = x[2a + p, 2b + q]
  x = x.reshape({bs, cin, (h + 4) / 2, 2, (wd + 4) / 2, 2});
  x = x.permute({0, 3, 5, 1, 2, 4}).reshape({bs, 4 * cin, (h + 4) / 2, (wd + 4) / 2});
  x = conv_silu(x, p[0], 3);
  x = conv_silu(x, p[1], 3, 2, 1);
  at::Tensor m = conv_silu(x, p[2], 1);
  for (int64_t i = 0; i < n; ++i) {
    at::Tensor r = conv_silu(conv_silu(m, p[4 + 2 * i], 1), p[5 + 2 * i], 3, 1, 1);
    m = at::add(m.to(at::kFloat), r.to(at::kFloat)).to(at::kBFloat16);
  }
  at::Tensor y = at::cat({m, conv_silu(x, p[3], 1)}, 1);
  y = conv_silu(y, p[4 + 2 * n], 1);
  y = conv_silu(y, p[5 + 2 * n], 3, 2, 1);
  return y.permute({0, 2, 3, 1}).contiguous();
}

// ---- the kernel: one configured library and plan per width set ----------------

using LaunchFn = int (*)(const void*, void*, const void*, void*, int, int, int, int, int, int,
                         int, int, int, const int*, void*);

struct Config {
  LaunchFn launch;
  std::array<int, kPlanInts> plan;
};

std::mutex g_mu;
std::map<Widths, Config> g_configs;
std::string g_error;
std::atomic<int64_t> g_launches{0};

#ifdef AYOLOV2_WITH_CUDA
at::Tensor early_pipeline_cuda(const at::Tensor& images, const at::Tensor& wpack, int64_t c0,
                               int64_t n, std::optional<int64_t> c1, std::optional<int64_t> ch,
                               std::optional<int64_t> c2) {
  const Widths w = widths_of(c0, n, c1, ch, c2);
  check_op(images, wpack, w);
  Config cfg;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_configs.find(w);
    TORCH_CHECK(it != g_configs.end(), "early_pipeline: no kernel library configured for ",
                width_text(w), " (ayolov2_early_pipeline_configure; the runner reads it from "
                "the package's sidecar)");
    cfg = it->second;
  }
  c10::cuda::CUDAGuard guard(images.device());
  const int64_t bs = images.size(0), h = images.size(1), wd = images.size(2);
  at::Tensor out = at::empty({bs, h / 8, wd / 8, w[3]}, images.options().dtype(at::kBFloat16));
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream(images.device().index()).stream();
  const int err = cfg.launch(images.data_ptr(), out.data_ptr(), wpack.data_ptr(), nullptr,
                             (int)bs, (int)h, (int)wd, (int)padded_width(w[0]),
                             (int)padded_width(w[1]), (int)padded_width(w[2]),
                             (int)padded_width(w[3]), (int)w[3], (int)w[4], cfg.plan.data(),
                             stream);
  TORCH_CHECK(err == 0, "early_pipeline kernel launch failed: error ", err, " (", width_text(w),
              ", tile ", cfg.plan[0], "x", cfg.plan[1], ")");
  g_launches.fetch_add(1);
  return out;
}
#endif

}  // namespace

TORCH_LIBRARY(ayolov2, m) {
  m.def("early_pipeline(Tensor images, Tensor wpack, SymInt c0, SymInt n, SymInt? c1=None, "
        "SymInt? ch=None, SymInt? c2=None) -> Tensor");
}

TORCH_LIBRARY_IMPL(ayolov2, CPU, m) { m.impl("early_pipeline", &early_pipeline_cpu); }

#ifdef AYOLOV2_WITH_CUDA
TORCH_LIBRARY_IMPL(ayolov2, CUDA, m) { m.impl("early_pipeline", &early_pipeline_cuda); }
#endif

// The kernel's library (a build of csrc/early_pipeline.cu for the padded set of
// these widths) and the 14 ints of plan_early for widths (c0, c1, ch, c2, n).
// Returns 0, or -1 where the library does not load or lacks the launch
// function (ayolov2_early_pipeline_error says why).
extern "C" int ayolov2_early_pipeline_configure(const char* library, const int64_t* widths,
                                                const int* plan) {
  std::lock_guard<std::mutex> lock(g_mu);
  void* handle = dlopen(library, RTLD_NOW | RTLD_LOCAL);
  void* fn = handle ? dlsym(handle, "early_pipeline_launch") : nullptr;
  if (!fn) {
    const char* why = dlerror();
    g_error = std::string("early_pipeline: cannot load ") + library + ": " +
              (why ? why : "no early_pipeline_launch");
    return -1;
  }
  Config cfg;
  cfg.launch = reinterpret_cast<LaunchFn>(fn);
  std::memcpy(cfg.plan.data(), plan, sizeof(int) * kPlanInts);
  g_configs[{widths[0], widths[1], widths[2], widths[3], widths[4]}] = cfg;
  return 0;
}

extern "C" const char* ayolov2_early_pipeline_error() { return g_error.c_str(); }

// Kernel launches since the library was loaded; the CPU body launches nothing.
extern "C" int64_t ayolov2_early_pipeline_launches() { return g_launches.load(); }
