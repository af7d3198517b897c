// Fused early network of a BN-folded YOLOv5 v6 model, for Hopper (sm_90a).
//
// Replaces the Pallas kernel K1 of the JAX package:
// ayolov2_tpu/ops/early_pipeline.py, `early_pipeline` (pallas_call at :496,
// body `_make_kernel.kernel` at :241). It computes layers 0..3, each
// followed by SiLU:
//
//   stem  Conv 6x6/s2/p2 (the /255 lives in the weights)   -> /2 level, c0
//   conv1 Conv 3x3/s2                                      -> /4 level, c1
//   C3    cv1 1x1; n x [1x1, 3x3, residual]; cv2 1x1 on
//         the conv1 output; concat; cv3 1x1                -> /4 level, c1
//   conv2 Conv 3x3/s2                                      -> /8 level, c2
//
// in:  (bs, H, W, 3) uint8, H and W multiples of 8
// out: (bs, H/8, W/8, c2) bf16, NHWC
//
// No intermediate is written to device memory. Each block owns a TH x TW
// tile of the /8 output of one image and recomputes its receptive field at
// every level in shared memory: the raw uint8 patch, the stem output, the
// conv1 output, the two bottleneck buffers and the C3 output. The stem
// buffer is dead once conv1 has read it, so the bottleneck and C3 buffers
// reuse its space. The host picks the largest tile that fits the 227 KB a
// block may use (`early_pipeline_smem_bytes`).
//
// Numerics follow K1: uint8 pixels convert exactly to bf16, products are
// bf16 x bf16 with f32 accumulation (mma.sync m16n8k16), bias and SiLU are
// applied in f32 and the result is rounded to bf16 when stored; the
// bottleneck residual is added in bf16. The JAX model zero-pads each conv's
// input at that conv's own level, and silu(bias) != 0, so every buffer that
// a 3x3 (or the stem) reads is zeroed outside the image before it is read:
// the input patch, the stem output, the bottleneck 1x1 output and the C3
// output.
//
// What bounds it: per 640x640 image yolov5s needs 3.54 GFLOP against 1.23 MB
// in and 1.64 MB out, so at batch 32 the bf16 tensor-core time (0.115 ms
// at 989 TFLOP/s) is four times the memory time: the bound is compute.
// This first version keeps the tensor cores busy only in part: the weights
// are read from L2 for every pixel tile (no shared-memory staging), the
// halo recomputation adds about a third to the work at an 8x8 tile, and
// mma.sync stands where wgmma would be faster. Those are the levers for
// a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStemK = 112;  // 3x3 taps x 12 space-to-depth planes = 108, padded to 112
constexpr int kPad = 8;      // extra bf16 per pixel in shared buffers (bank spread)

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Shared-memory layout of one block. All offsets in bytes.
struct Layout {
  int r3, c3, r1, c1, r0, c0, ri, ci;   // region rows/cols: C3 out, conv1/m, stem, input
  int p0, p1, ph;                        // pixel pitch (elements) of c0-, c1-, ch-channel buffers
  int off_c1, off_in, off_stem, off_ma, off_mb, off_c3, off_tab, total;
};

__host__ __device__ inline Layout make_layout(int c0, int c1, int ch, int n, int th, int tw) {
  Layout L;
  L.r3 = 2 * th + 1;  L.c3 = 2 * tw + 1;
  L.r1 = L.r3 + 2 * n;  L.c1 = L.c3 + 2 * n;
  L.r0 = 2 * L.r1 + 1;  L.c0 = 2 * L.c1 + 1;
  L.ri = 2 * L.r0 + 4;  L.ci = 2 * L.c0 + 4;
  L.p0 = c0 + kPad;  L.p1 = c1 + kPad;  L.ph = ch + kPad;
  L.off_c1 = 0;
  const int phase = align16(L.r1 * L.c1 * L.p1 * 2);
  // phase 1: input patch + stem output; phase 2 (after conv1): m_a, m_b, C3 out
  L.off_in = phase;
  L.off_stem = L.off_in + align16(L.ri * L.ci * 3);
  const int end1 = L.off_stem + L.r0 * L.c0 * L.p0 * 2;
  L.off_ma = phase;
  L.off_mb = L.off_ma + align16(L.r1 * L.c1 * L.ph * 2);
  L.off_c3 = L.off_mb + align16(L.r1 * L.c1 * L.ph * 2);
  const int end2 = L.off_c3 + L.r3 * L.c3 * L.p1 * 2;
  L.off_tab = align16(end1 > end2 ? end1 : end2);
  L.total = L.off_tab + kStemK * 4;
  return L;
}

// One conv layer: out pixel (orow, ocol), tap (kh, kw) reads source pixel
// (orow*stride + kh, ocol*stride + kw) of the source buffer (the caller
// offsets the pointers so that this holds).
struct Conv {
  const __nv_bfloat16* a0;  // source, channels [0, ksplit)
  const __nv_bfloat16* a1;  // source, channels [ksplit, cin) (1x1 concat only)
  int ksplit;
  int s_cols, s_pitch, cin, ks, stride;
  int o_rows, o_cols;
  __nv_bfloat16* d;         // destination of out pixel (0, 0)
  int d_cols, d_pitch;
  const __nv_bfloat16* w;   // (co, K) bf16, K in (kh, kw, cin) order
  const __nv_bfloat16* b;   // (co,) bf16
  int co, K;
  int g_r0, g_c0, g_h, g_w;  // image coordinates of out pixel (0, 0), image size at this level
  int mode;                  // see Mode
};

enum Mode { kPlain = 0, kMask = 1, kResidual = 2, kGlobal = 3 };

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + __expf(-x)); }

// MT m-tiles of 16 output pixels x NG n-tiles of 8 channels per work item.
// STEM: the source is the uint8 input patch, gathered through `tab`.
template <int MT, int NG, bool STEM>
__device__ void conv_layer(const Conv& cv, const uint8_t* in_u8, const int* tab) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int M = cv.o_rows * cv.o_cols;
  const int m_items = (M + 16 * MT - 1) / (16 * MT);
  const int n_tiles = cv.co / 8;
  const int n_items = (n_tiles + NG - 1) / NG;

  for (int item = warp; item < m_items * n_items; item += kWarps) {
    const int mi = item % m_items, ni = item / m_items;
    // source offset (elements) and validity of this thread's 2*MT rows
    int src[MT][2];
    int pix[MT][2];
    #pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        int p = (mi * MT + mt) * 16 + g + 8 * h;
        pix[mt][h] = p;
        int pc = p < M ? p : M - 1;
        int orow = pc / cv.o_cols, ocol = pc - orow * cv.o_cols;
        int sp = (orow * cv.stride) * cv.s_cols + ocol * cv.stride;
        src[mt][h] = STEM ? sp * 3 : sp * cv.s_pitch;
      }
    }
    float acc[MT][NG][4];
    #pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      #pragma unroll
      for (int nt = 0; nt < NG; ++nt)
        #pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    const __nv_bfloat16* wrow[NG];
    #pragma unroll
    for (int nt = 0; nt < NG; ++nt) {
      int n = (ni * NG + nt) * 8 + g;
      wrow[nt] = cv.w + (size_t)(n < cv.co ? n : 0) * cv.K + 2 * t;
    }

    if constexpr (STEM) {
      for (int k0 = 0; k0 < kStemK; k0 += 16) {
        int o[4];
        #pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = tab[k0 + 2 * t + (e & 1) + 8 * (e >> 1)];
        uint32_t a[MT][4];
        #pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          #pragma unroll
          for (int r = 0; r < 4; ++r) {  // a0: row g, k lo; a1: row g+8, k lo; a2/a3: k hi
            const int h = r & 1, kh = r >> 1;
            const int base = src[mt][h];
            float lo = o[2 * kh] >= 0 ? (float)in_u8[base + o[2 * kh]] : 0.f;
            float hi = o[2 * kh + 1] >= 0 ? (float)in_u8[base + o[2 * kh + 1]] : 0.f;
            a[mt][r] = pack_bf16(lo, hi);
          }
        }
        #pragma unroll
        for (int nt = 0; nt < NG; ++nt) {
          if ((ni * NG + nt) >= n_tiles) continue;
          uint32_t b0 = ldg32(wrow[nt] + k0), b1 = ldg32(wrow[nt] + k0 + 8);
          #pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma16816(acc[mt][nt], a[mt], b0, b1);
        }
      }
    } else {
      int kidx = 0;
      for (int kh = 0; kh < cv.ks; ++kh) {
        for (int kw = 0; kw < cv.ks; ++kw) {
          const int tap = (kh * cv.s_cols + kw) * cv.s_pitch;
          for (int cc = 0; cc < cv.cin; cc += 16, kidx += 16) {
            const __nv_bfloat16* s = cc < cv.ksplit ? cv.a0 : cv.a1;
            const int ci = (cc < cv.ksplit ? cc : cc - cv.ksplit) + 2 * t + tap;
            uint32_t a[MT][4];
            #pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              a[mt][0] = ld32(s + src[mt][0] + ci);
              a[mt][1] = ld32(s + src[mt][1] + ci);
              a[mt][2] = ld32(s + src[mt][0] + ci + 8);
              a[mt][3] = ld32(s + src[mt][1] + ci + 8);
            }
            #pragma unroll
            for (int nt = 0; nt < NG; ++nt) {
              if ((ni * NG + nt) >= n_tiles) continue;
              uint32_t b0 = ldg32(wrow[nt] + kidx), b1 = ldg32(wrow[nt] + kidx + 8);
              #pragma unroll
              for (int mt = 0; mt < MT; ++mt) mma16816(acc[mt][nt], a[mt], b0, b1);
            }
          }
        }
      }
    }

    // epilogue: bias + SiLU in f32, round to bf16, mask / residual / store
    #pragma unroll
    for (int nt = 0; nt < NG; ++nt) {
      if ((ni * NG + nt) >= n_tiles) continue;
      const int ch0 = (ni * NG + nt) * 8 + 2 * t;
      const float bias0 = __bfloat162float(cv.b[ch0]);
      const float bias1 = __bfloat162float(cv.b[ch0 + 1]);
      #pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = pix[mt][h];
          if (p >= M) continue;
          const int orow = p / cv.o_cols, ocol = p - orow * cv.o_cols;
          const int gr = cv.g_r0 + orow, gc = cv.g_c0 + ocol;
          const bool inside = gr >= 0 && gr < cv.g_h && gc >= 0 && gc < cv.g_w;
          __nv_bfloat162 y = __floats2bfloat162_rn(silu(acc[mt][nt][2 * h] + bias0),
                                                   silu(acc[mt][nt][2 * h + 1] + bias1));
          if (cv.mode == kGlobal) {
            if (!inside) continue;
            __nv_bfloat16* dst = cv.d + ((size_t)orow * cv.d_cols + ocol) * cv.d_pitch + ch0;
            *reinterpret_cast<__nv_bfloat162*>(dst) = y;
            continue;
          }
          __nv_bfloat16* dst = cv.d + (orow * cv.d_cols + ocol) * cv.d_pitch + ch0;
          if (cv.mode == kMask && !inside) {
            y = __floats2bfloat162_rn(0.f, 0.f);
          } else if (cv.mode == kResidual) {
            __nv_bfloat162 old = *reinterpret_cast<__nv_bfloat162*>(dst);
            y = __floats2bfloat162_rn(__bfloat162float(old.x) + __bfloat162float(y.x),
                                      __bfloat162float(old.y) + __bfloat162float(y.y));
          }
          *reinterpret_cast<__nv_bfloat162*>(dst) = y;
        }
      }
    }
  }
}

// Weight segments in `wpack`, by index into `offs` (element offsets):
// 0 w_stem, 1 b_stem, 2 w_c1, 3 b_c1, 4 w_cv1, 5 b_cv1,
// 6 + 4i: w_m_cv1[i], b_m_cv1[i], w_m_cv2[i], b_m_cv2[i]   (i < n),
// 6 + 4n: w_cv2, b_cv2, w_cv3, b_cv3, w_c2, b_c2.
__global__ void __launch_bounds__(kThreads, 1)
early_pipeline_kernel(const uint8_t* __restrict__ img, __nv_bfloat16* __restrict__ out,
                      const __nv_bfloat16* __restrict__ wpack, const int* __restrict__ offs,
                      int H, int W, int c0, int c1, int ch, int c2, int n, int th, int tw) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = make_layout(c0, c1, ch, n, th, tw);
  const int b = blockIdx.z;
  const int h8 = H / 8, w8 = W / 8;
  const int z0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  // image coordinates of each region's (0, 0), at that region's level
  const int r3 = 2 * z0 - 1, q3 = 2 * x0 - 1;
  const int r1 = r3 - n, q1 = q3 - n;
  const int r0 = 2 * r1 - 1, q0 = 2 * q1 - 1;
  const int ri = 2 * r0 - 2, qi = 2 * q0 - 2;

  __nv_bfloat16* s_c1 = reinterpret_cast<__nv_bfloat16*>(smem + L.off_c1);
  uint8_t* s_in = smem + L.off_in;
  __nv_bfloat16* s_stem = reinterpret_cast<__nv_bfloat16*>(smem + L.off_stem);
  __nv_bfloat16* s_ma = reinterpret_cast<__nv_bfloat16*>(smem + L.off_ma);
  __nv_bfloat16* s_mb = reinterpret_cast<__nv_bfloat16*>(smem + L.off_mb);
  __nv_bfloat16* s_c3 = reinterpret_cast<__nv_bfloat16*>(smem + L.off_c3);
  int* tab = reinterpret_cast<int*>(smem + L.off_tab);

  // stem K index (i, j, p, q, c) -> byte offset in the input patch
  for (int k = threadIdx.x; k < kStemK; k += kThreads) {
    int v = -1;
    if (k < 108) {
      int i = k / 36, j = (k % 36) / 12, pl = k % 12;
      int p = pl / 6, q = (pl % 6) / 3, c = pl % 3;
      v = ((2 * i + p) * L.ci + (2 * j + q)) * 3 + c;
    }
    tab[k] = v;
  }
  // input patch, zero outside the image
  const uint8_t* im = img + (size_t)b * H * W * 3;
  const int row_bytes = L.ci * 3;
  for (int idx = threadIdx.x; idx < L.ri * row_bytes; idx += kThreads) {
    int r = idx / row_bytes, cb = idx - r * row_bytes;
    int gr = ri + r, gcb = qi * 3 + cb;
    s_in[idx] = (gr >= 0 && gr < H && gcb >= 0 && gcb < W * 3) ? im[(size_t)gr * W * 3 + gcb] : 0;
  }
  __syncthreads();

  Conv cv;
  const __nv_bfloat16* wp = wpack;
  // stem: 6x6/s2 as 3x3 over the 12 space-to-depth planes (gathered via tab)
  cv = Conv{nullptr, nullptr, 0, L.ci, 3, 3, 3, 2, L.r0, L.c0, s_stem, L.c0, L.p0,
            wp + offs[0], wp + offs[1], c0, kStemK, r0, q0, H / 2, W / 2, kMask};
  conv_layer<2, 4, true>(cv, s_in, tab);
  __syncthreads();
  // conv1: 3x3/s2, stem -> c1
  cv = Conv{s_stem, s_stem, c0, L.c0, L.p0, c0, 3, 2, L.r1, L.c1, s_c1, L.c1, L.p1,
            wp + offs[2], wp + offs[3], c1, 9 * c0, r1, q1, H / 4, W / 4, kPlain};
  conv_layer<2, 4, false>(cv, nullptr, nullptr);
  __syncthreads();
  // C3 cv1: 1x1, c1 -> m_a (over the whole conv1 region)
  cv = Conv{s_c1, s_c1, c1, L.c1, L.p1, c1, 1, 1, L.r1, L.c1, s_ma, L.c1, L.ph,
            wp + offs[4], wp + offs[5], ch, c1, r1, q1, H / 4, W / 4, kPlain};
  conv_layer<2, 4, false>(cv, nullptr, nullptr);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int* o = offs + 6 + 4 * i;
    // bottleneck 1x1: m_a -> m_b, zero outside the image (a 3x3 reads it next)
    cv = Conv{s_ma, s_ma, ch, L.c1, L.ph, ch, 1, 1, L.r1, L.c1, s_mb, L.c1, L.ph,
              wp + o[0], wp + o[1], ch, ch, r1, q1, H / 4, W / 4, kMask};
    conv_layer<2, 4, false>(cv, nullptr, nullptr);
    __syncthreads();
    // bottleneck 3x3 + residual: m_a[interior] += conv(m_b)
    cv = Conv{s_mb, s_mb, ch, L.c1, L.ph, ch, 3, 1, L.r1 - 2, L.c1 - 2,
              s_ma + (L.c1 + 1) * L.ph, L.c1, L.ph,
              wp + o[2], wp + o[3], ch, 9 * ch, r1 + 1, q1 + 1, H / 4, W / 4, kResidual};
    conv_layer<2, 4, false>(cv, nullptr, nullptr);
    __syncthreads();
  }
  const int* o = offs + 6 + 4 * n;
  // C3 cv2: 1x1 on the conv1 output -> m_b
  cv = Conv{s_c1, s_c1, c1, L.c1, L.p1, c1, 1, 1, L.r1, L.c1, s_mb, L.c1, L.ph,
            wp + o[0], wp + o[1], ch, c1, r1, q1, H / 4, W / 4, kPlain};
  conv_layer<2, 4, false>(cv, nullptr, nullptr);
  __syncthreads();
  // C3 cv3: 1x1 on concat(m_a, m_b) over the C3 region, zero outside the image
  {
    const int sh = (n * L.c1 + n) * L.ph;
    cv = Conv{s_ma + sh, s_mb + sh, ch, L.c1, L.ph, 2 * ch, 1, 1, L.r3, L.c3, s_c3, L.c3, L.p1,
              wp + o[2], wp + o[3], c1, 2 * ch, r3, q3, H / 4, W / 4, kMask};
    conv_layer<2, 4, false>(cv, nullptr, nullptr);
  }
  __syncthreads();
  // conv2: 3x3/s2 -> the /8 output tile in device memory
  {
    const int rows = min(th, h8 - z0), cols = min(tw, w8 - x0);
    __nv_bfloat16* dst = out + (((size_t)b * h8 + z0) * w8 + x0) * c2;
    cv = Conv{s_c3, s_c3, c1, L.c3, L.p1, c1, 3, 2, rows, cols, dst, w8, c2,
              wp + o[4], wp + o[5], c2, 9 * c1, z0, x0, h8, w8, kGlobal};
    conv_layer<2, 4, false>(cv, nullptr, nullptr);
  }
}

}  // namespace

extern "C" int early_pipeline_smem_bytes(int c0, int c1, int ch, int n, int th, int tw) {
  return make_layout(c0, c1, ch, n, th, tw).total;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int early_pipeline_launch(const void* img, void* out, const void* wpack,
                                     const void* offs, int bs, int H, int W, int c0, int c1,
                                     int ch, int c2, int n, int th, int tw, void* stream) {
  const int smem = make_layout(c0, c1, ch, n, th, tw).total;
  cudaError_t err = cudaFuncSetAttribute(early_pipeline_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W / 8 + tw - 1) / tw, (H / 8 + th - 1) / th, bs);
  early_pipeline_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (__nv_bfloat16*)out, (const __nv_bfloat16*)wpack,
      (const int*)offs, H, W, c0, c1, ch, c2, n, th, tw);
  return (int)cudaGetLastError();
}
