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
// widths: any c0, c1, ch, c2 whose padded forms (below) are at most 80, 160,
// 80 and 320, as a v6 model of width_multiple 0.125 to 1.25 has them
//
// Two forms, one library. The fused form (this kernel, early_pipeline_kernel)
// writes no intermediate to device memory: a persistent grid of one block per
// SM walks the TH x TW tiles of the /8 output, and a block recomputes a tile's
// receptive field at every level in shared memory. The staged form (below,
// "the staged form") runs 2 + n kernels of the same make through device
// memory, each with a halo of at most one conv: for the wide width sets, where
// the fused tile that fits a block is 2x2 and recomputes its field 11-19
// times. The host's plan picks the form per width set (plan_early: a cost of
// MACs done in 64-row tiles, weight bytes streamed, activation bytes and
// launches).
//
// Every width is held padded: c0, c1 and ch to multiples of 16 (so that a
// tap's channels are whole k16 steps and a pixel pitch is an odd multiple of
// 16 bytes), c2 to a multiple of its N tile (a multiple of 8, below). The
// host packs zero weight rows and columns and zero biases for the padded
// channels, so each is SiLU(0) = 0 wherever it is stored and adds nothing
// where it is read; conv2 stores only the true c2 channels.
//
// Numerics follow K1: uint8 pixels convert exactly to bf16, products are
// bf16 x bf16 with f32 accumulation, bias and SiLU are applied in f32 and
// the result is rounded to bf16 when stored; the bottleneck residual is
// added in bf16. SiLU uses the hardware's tanh (see `silu`). The JAX model
// zero-pads each conv's input at that conv's own level, and silu(bias) != 0,
// so every buffer that a 3x3 (or the stem) reads is zero outside the image:
// the input patch, the stem output, the bottleneck 1x1 output and the C3
// output.
//
// What bounds it (the fused form): per 640x640 image yolov5s needs 3.54 GFLOP against 1.23 MB
// in and 1.64 MB out, so at batch 32 the bf16 tensor-core time (0.115 ms at
// 989 TFLOP/s) is four times the memory time: the bound is operations. In
// practice the products are narrow (N = 32 or 64 channels, K = 144 to 576),
// and the wgmmas, the epilogues (whose SiLU runs on the special-function
// unit) and the rest (input conversion, fragment loads, barriers, the scalar
// set-up of each product) take about a third of the time each and overlap
// little (PERF.md has the ablations). What the design does about it:
//
// - Every conv is a product of 64-pixel row tiles (M) by NT output channels
//   by k16 steps over (tap, cin), run by one warpgroup with `wgmma`: A (the
//   pixels) comes from registers filled by `ldmatrix.x4`, because a tap of
//   a 3x3 over a padded pixel-major buffer, or a stride-2 tap, addresses
//   pixels that no shared-memory matrix descriptor describes (the stem is
//   the exception, below); B (the weights) comes from shared memory.
// - Weights are packed on the host into chunks of 4, 3, 2 or 1 k16 steps
//   (whichever divides the layer's K, so that no chunk is ragged and the
//   wgmmas of a chunk are straight-line code), co rows of 128 bytes each in
//   the 128-byte-swizzle order that the wgmma descriptor reads. One producer
//   warp streams them with `cp.async.bulk`, as many whole chunks as a stage
//   holds per copy, into a ring of stages, each guarded by a full and an
//   empty `mbarrier`; its schedule is fixed by the geometry, so it runs ahead
//   across layers and tiles while the three consumer warpgroups multiply.
//   While one chunk multiplies, the next chunk's A fragments are loaded.
// - The stem is a 3x3 with no byte gathers: the uint8 patch arrives by
//   `cp.async` (ahead of use, zero-filled outside the image) and is converted
//   once to a bf16 space-to-depth buffer of 12 planes padded to 16 per /2
//   pixel, so each of the nine taps is one k16 step (stem K = 144, zero
//   columns). Its stride is 1, so a tap only shifts the first pixel: the
//   buffer is laid out as two planes of 16-byte pixels, which a wgmma
//   descriptor without swizzle reads directly (A from shared memory, no
//   `ldmatrix`, all nine wgmmas in one group). A row tile is 64 consecutive
//   pixels of the plane, whose rows carry two columns that are not kept.
// - The stem rolls: it is computed in bands of rows that conv1 consumes at
//   once, so its buffer holds 2 RB + 1 rows and not the whole region; the
//   last row of a band is carried over, not recomputed.
// - Buffers read by a stride-2 conv (stem output, C3 output) keep even and
//   odd columns in separate planes, so that the eight rows of an `ldmatrix`
//   phase are neighbours in memory; every pixel pitch is an odd multiple of
//   16 bytes, which spreads those rows over all banks.
// - cv1 and cv2 of the C3 run as one product (N = 2 ch) into the concat
//   buffer that cv3 reads; the conv1 buffer is dead after it and holds the
//   C3 output.
// - Work items (M tile x N tile) are dealt to the three warpgroups in
//   rounds; NT is the widest of co, co / 2, co / 4 that is at most 80, so
//   that the accumulators leave the wgmmas the registers they need to stay
//   asynchronous. Three consumer warpgroups and not four: with the producer's
//   warpgroup that is 512 threads and 128 registers a thread; four leave 96,
//   and ptxas then serializes every wgmma. Of the producer's warpgroup one
//   warp works; all of it gives its registers back (`setmaxnreg`), so that a
//   consumer thread has 152 and the product loops do not spill.
// - Each of the seven kinds of product (stem, conv1, cv1|cv2, m.cv1, m.cv2,
//   cv3, conv2) is one inlined instantiation: ptxas serializes a wgmma
//   pipeline that crosses a call, and more bodies than these cost time. The
//   kind and the width fix, at compile time, the N tile, the taps and chunks
//   (the loop over chunks is unrolled, so every k16 step's offset is plain
//   arithmetic on the tap strides) and how the epilogue masks and addresses
//   its output; only the geometry of the tile is read at run time.
//
// The form, each kernel's tile, the band height, the ring depth and every
// buffer offset are planned on the host (`plan_early` in
// ops/early_pipeline.py) and checked here against the geometry before the
// launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// One library per padded width set: build with -DEARLY_C0, -DEARLY_C1,
// -DEARLY_CH and -DEARLY_C2 (ops/early_pipeline.py: kernel_defines; ops/_build.py
// starts one compiler per set, all together). -DEARLY_PROFILE adds
// clock stamps at the layer boundaries (see early_pipeline_profile_slots).
// -DEARLY_ABLATE=k takes one part out, for timing only (the results are wrong):
// 1 the SiLU arithmetic, 2 the wgmmas, 3 the ldmatrix loads, 4 the epilogue's
// stores, 5 the whole epilogue, 6 the copies of the weights, 7 the wgmmas and
// the epilogue, 8 all three.
#ifndef EARLY_ABLATE
#define EARLY_ABLATE 0
#endif
#if !defined(EARLY_C0) || !defined(EARLY_C1) || !defined(EARLY_CH) || !defined(EARLY_C2)
#error "build with -DEARLY_C0, -DEARLY_C1, -DEARLY_CH and -DEARLY_C2 (the padded widths)"
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarpgroups = 3;                    // consumer warpgroups
constexpr int kConsumerThreads = 128 * kWarpgroups;
constexpr int kThreads = kConsumerThreads + 128;  // plus the producer's warpgroup: one warp works
// Registers a thread after `setmaxnreg`: the block is launched with 128 each
// (65536 / 512); the producer's warpgroup gives back all but EARLY_PRODUCER_REGS
// and each consumer takes EARLY_CONSUMER_REGS (128 x 40 + 384 x 152 <= 65536).
#define EARLY_PRODUCER_REGS "40"
#define EARLY_CONSUMER_REGS "152"
constexpr int kPad = 8;          // extra bf16 per pixel: pitch = odd multiple of 16 bytes
constexpr int kS2dBytes = 32;    // bytes per space-to-depth pixel: two planes of 8 bf16
constexpr int kMaxStages = 4;
constexpr int kMaxNT = 80;       // widest N tile: its accumulators must leave the wgmmas their registers
constexpr int kMaxLayers = 16;   // 5 + 2 n layers, n <= 4
constexpr int kSmemLimit = 232448;
// the padded widths of this build: stem, conv1 (and cv3), the C3's hidden, conv2
constexpr int kC0 = EARLY_C0, kC1 = EARLY_C1, kCH = EARLY_CH, kC2 = EARLY_C2;
static_assert(kC0 % 16 == 0 && kC1 % 16 == 0 && kCH % 16 == 0 && kC2 % 16 == 0,
              "widths are padded to multiples of 16");
static_assert(kC0 >= 16 && kC0 <= 80 && kCH >= 16 && kCH <= 80 && kC1 >= 16 && kC1 <= 160
              && kC2 >= 16 && kC2 <= 320, "widths beyond what the N tiles cover");
// Rows of 128 bytes in one ring stage: the widest product's chunk, and the
// stem's three chunks, which its nine wgmmas read from one stage.
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kStageRows = cmax(cmax(3 * kC0, kC1), cmax(2 * kCH, kC2));

// The host's plan (ops/early_pipeline.py: PLAN_FIELDS, same order).
struct Plan {
  int th, tw, rb, stages, stage_bytes;
  int off_ring, off_c1, off_raw, off_s2d, off_stem, off_mcat, off_mt, off_bias, total;
};

// p / d for 0 <= p < 2^32 / d, with magic = magic_of(d): one multiply.
__host__ __device__ inline uint32_t magic_of(int d) { return 0xFFFFFFFFu / (uint32_t)d + 1u; }
__device__ __forceinline__ int fast_div(int p, uint32_t magic, int d) {
  return d == 1 ? p : (int)__umulhi((uint32_t)p, magic);
}

// Regions of one tile, in pixels of their level.
struct Geo {
  int r3, c3;      // C3 output (conv2's input), /4
  int r1, c1;      // conv1 output and the bottleneck buffers, /4
  int r0, c0;      // stem output, /2
  int cs;          // space-to-depth columns, /2
  int half0, half3;  // columns of one parity plane of the stem / C3 buffers
  int raw_pitch;   // bytes of one raw input row in shared memory
  uint32_t m_cs, m_c1, m_c1i, m_c3, m_raw;  // magic_of cs, c1, c1 - 2, c3, raw_pitch / 8
};

// The regions of a conv1 output of r1 x c1 pixels, of which the r3 x c3 C3
// output is kept (1 x 1 where no C3 output is kept).
__host__ __device__ inline Geo geo_of(int r1, int c1, int r3, int c3) {
  Geo g;
  g.r3 = r3;  g.c3 = c3;
  g.r1 = r1;  g.c1 = c1;
  g.r0 = 2 * g.r1 + 1;  g.c0 = 2 * g.c1 + 1;
  g.cs = g.c0 + 2;
  g.half0 = (g.c0 + 1) / 2;  g.half3 = (g.c3 + 1) / 2;
  g.raw_pitch = (6 * g.cs + 14) / 8 * 8;
  g.m_cs = magic_of(g.cs);  g.m_c1 = magic_of(g.c1);  g.m_c1i = magic_of(g.c1 - 2);
  g.m_c3 = magic_of(g.c3);  g.m_raw = magic_of(g.raw_pitch / 8);
  return g;
}

// A th x tw tile of the fused form's /8 output: its C3 output, and the conv1
// output the n bottlenecks' 3x3 convs read around it.
__host__ __device__ inline Geo make_geo(int n, int th, int tw) {
  return geo_of(2 * th + 1 + 2 * n, 2 * tw + 1 + 2 * n, 2 * th + 1, 2 * tw + 1);
}

// One layer's weights in the packed buffer.
struct LayerW {
  int goff;      // byte offset of its first chunk
  int co;        // rows of a chunk; a chunk is co * 128 bytes
  int ksteps;    // k16 steps = taps * cin / 16
  int kpc;       // k16 steps per chunk: the largest of 4, 3, 2, 1 that divides ksteps
  int group;     // chunks per ring stage (one copy, one barrier): divides the chunk count
  int boff;      // index of its first bias
};

__host__ __device__ constexpr int steps_per_chunk(int ksteps) {
  return ksteps % 4 == 0 ? 4 : ksteps % 3 == 0 ? 3 : ksteps % 2 == 0 ? 2 : 1;
}

// Chunks per ring stage: a stage holds kStageRows rows of 128 bytes, so as many
// whole chunks of co rows as fit and divide the layer's chunk count.
__host__ __device__ constexpr int group_of(int co, int nchunks) {
  int group = kStageRows / co;
  while (nchunks % group) --group;
  return group;
}

// Layer order: 0 stem, 1 conv1, 2 cv1|cv2, 3+2i m[i].cv1, 4+2i m[i].cv2,
// 3+2n cv3, 4+2n conv2. Returns the bytes of all chunks (the biases follow).
__host__ __device__ inline int fill_layers(LayerW* tab, int n) {
  const int c0 = kC0, c1 = kC1, ch = kCH, c2 = kC2;
  int goff = 0, boff = 0, l = 0;
  auto add = [&](int co, int ksteps) {
    tab[l].goff = goff;  tab[l].co = co;  tab[l].ksteps = ksteps;  tab[l].boff = boff;
    tab[l].kpc = steps_per_chunk(ksteps);
    // a stage holds kStageRows rows of 128 bytes: as many whole chunks as fit and divide the count
    tab[l].group = group_of(co, ksteps / tab[l].kpc);
    goff += (ksteps / tab[l].kpc) * co * 128;
    boff += co;
    ++l;
  };
  add(c0, 9);                  // stem: 9 taps x 16 planes
  add(c1, 9 * c0 / 16);        // conv1
  add(2 * ch, c1 / 16);        // cv1 | cv2
  for (int i = 0; i < n; ++i) {
    add(ch, ch / 16);          // m.cv1
    add(ch, 9 * ch / 16);      // m.cv2
  }
  add(c1, 2 * ch / 16);        // cv3
  add(c2, 9 * c1 / 16);        // conv2
  return goff;
}

__host__ __device__ inline int total_bias(int n) { return kC0 + kC1 + 2 * kCH + n * 2 * kCH + kC1 + kC2; }

// How a layer's M x N outputs are dealt to the warpgroups. An item is a
// 64-pixel row tile by NT channels; every round gives each warpgroup at most
// one item and streams the layer's weights once. NT is the widest of co,
// co / 2, co / 4 that is at most kMaxNT: a wgmma costs about the same at any
// N this narrow, so fewer and wider ones win. With co padded to a multiple of
// 16 (of 32 above 160) it is a multiple of 8, as a wgmma's N must be.
__host__ __device__ constexpr int nt_of(int co) {
  return co <= kMaxNT ? co : co / 2 <= kMaxNT ? co / 2 : co / 4;
}

__host__ __device__ inline int rounds_of(int M, int co) {
  return ((M + 63) / 64 * (co / nt_of(co)) + kWarpgroups - 1) / kWarpgroups;
}

// ---- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Returns when the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// 8 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Barrier of the consumer threads (the producer warp never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps a register live (and unmoved) up to this point: the operands of an
// asynchronous wgmma must not be reused before its group has been waited for.
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r) :: "memory"); }

// Shared-memory matrix descriptor of a K-major, 128-byte-swizzled B tile:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32)
         | ((uint64_t)1 << 62);
}

// Shared-memory matrix descriptor of a K-major A tile without swizzle: 64 rows
// (pixels) of 8 values, 16 bytes apart, so that every 8 x 8 core matrix is 128
// contiguous bytes; the next 8 rows follow at once (SBO = 128), the next 8
// values of K lie `plane` bytes on (LBO).
__device__ __forceinline__ uint64_t a_desc(uint32_t addr, int plane) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(plane >> 4) << 16) | ((uint64_t)8 << 32);
}

// D (64 x N, f32, registers) += A (64 x 16, bf16, registers) x B (16 x N, shared).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);

template <> __device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<56>(float (&d)[28], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<72>(float (&d)[36], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// D (64 x N) += A (64 x 16, shared, by descriptor) x B (16 x N, shared).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b);

template <> __device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_ss<56>(float (&d)[28], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "%28, %29, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_ss<72>(float (&d)[36], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35}, "
      "%36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_ss<80>(float (&d)[40], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// x * sigmoid(x) = h + h tanh(h), h = x / 2, with the hardware's tanh: one
// special-function instruction per value where 2^x and 1/x take two, and the
// special-function unit is what bounds the epilogues. tanh.approx.f32 is
// within 2^-11 of tanh, so the result is within |x| 2^-12 of x sigmoid(x).
__device__ __forceinline__ float silu(float x) {
  const float h = 0.5f * x;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// ---- one conv layer ---------------------------------------------------------

enum Mode { kPlain = 0, kMask = 1, kResidual = 2, kGlobal = 3 };

// Output pixel (orow, ocol), tap (kh, kw), k16 step cc reads 32 bytes at
//   src + (orow * row_mul + ocol) * pitch + kh * tap_a + (kw & 1) * tap_b + (kw >> 1) * tap_c
//       + cc * 32
// which covers both a plain buffer (stride 1) and a parity-split one (stride 2).
// The stem instead reads planes of 16-byte pixels by descriptor: src is pixel
// (0, 0) of the first plane, row_mul the bytes from one plane to the next, and
// its output rows are whole rows of the planes (o_cols), of which v_cols are kept.
struct Conv {
  uint32_t src;
  int row_mul, pitch, tap_a, tap_b, tap_c;
  int o_rows, o_cols;
  uint32_t cols_magic;         // magic_of(o_cols)
  int v_cols;                  // output columns kept (the stem's rows carry 2 more)
  uint8_t* dst;                // shared (or, kGlobal, device) address of out pixel (0, 0)
  int d_cols, d_pitch;         // columns (of one parity plane if split), bytes per pixel
  int co_store;                // kGlobal: channels stored (the true c2; the rest are padding)
  int layer;                   // index into the layer table
  int g_r0, g_c0, g_h, g_w;    // image coordinates of out pixel (0, 0); image size at this level
};

struct Pipe {
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) { stage = 0; phase ^= 1; }
  }
};

struct Shared {
  unsigned long long full[kMaxStages], empty[kMaxStages];
  LayerW tab[kMaxLayers];
#ifdef EARLY_PROFILE
  // per warpgroup: waiting for weights, products, epilogue, no item, block barrier
  long long wg_clocks[4][5];
#endif
};

#ifdef EARLY_PROFILE
#define WG_PROF(k) do { if ((threadIdx.x & 127) == 0) { long long now_ = clock64(); \
    const_cast<Shared&>(sh).wg_clocks[threadIdx.x >> 7][k] += now_ - wg_last; wg_last = now_; } } while (0)
#else
#define WG_PROF(k) do { } while (0)
#endif

template <int CO, int KS, int KSTEPS, bool STEM, int MODE, bool SPLIT>
__device__ __forceinline__ void conv_layer(const Conv& cv_in, Pipe& pipe_io, const Shared& sh,
                                           uint32_t ring, int stage_bytes, int stages,
                                           const bf16* s_bias) {
  // all fixed by the kind of product and the width: N tile, k16 steps per chunk
  // and per tap, chunks, chunks per ring stage, bytes of a chunk
  constexpr int NT = nt_of(CO), KPC = steps_per_chunk(KSTEPS), CPK = KSTEPS / (KS * KS);
  constexpr int nchunks = KSTEPS / KPC, group = group_of(CO, nchunks), chunk_bytes = CO * 128;
  static_assert(NT % 8 == 0 && CO % NT == 0 && NT <= kMaxNT, "an N tile a wgmma takes");
  static_assert(!STEM || group == nchunks, "the stem's chunks share one stage");
  const Conv cv = cv_in;   // registers, not the caller's stack
  Pipe pipe = pipe_io;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const LayerW lw = sh.tab[cv.layer];
  const int M = cv.o_rows * cv.o_cols;
  const int m_tiles = (M + 63) / 64;
  const int items = m_tiles * (CO / NT), rounds = (items + kWarpgroups - 1) / kWarpgroups;
  const uint32_t cols_magic = cv.cols_magic;
  // only a product with several N tiles (conv2) divides an item into (N tile, row tile)
  const uint32_t tiles_magic = CO == NT ? 0u : magic_of(m_tiles);
  const uint32_t full0 = smem_u32(&sh.full[0]), empty0 = smem_u32(&sh.empty[0]);
#ifdef EARLY_PROFILE
  long long wg_last = clock64();
#endif
  for (int r = 0; r < rounds; ++r) {
    const int item = r * kWarpgroups + wg;
    WG_PROF(2);
    if (item >= items) {
      // no item this round: pass the stages on
      for (int c = 0; c < nchunks; c += group) {
        mbar_wait(full0 + 8 * pipe.stage, pipe.phase);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * pipe.stage);
        pipe.advance(stages);
      }
      WG_PROF(3);
      continue;
    }
    const int ni = CO == NT ? 0 : fast_div(item, tiles_magic, m_tiles), mi = item - ni * m_tiles;
    uint32_t abase;
    {
      int p = mi * 64 + wq * 16 + (lane & 15);
      p = p < M ? p : M - 1;
      const int orow = fast_div(p, cols_magic, cv.o_cols), ocol = p - orow * cv.o_cols;
      abase = cv.src + (orow * cv.row_mul + ocol) * cv.pitch + (lane >> 4) * 16;
    }
    const uint32_t boff = ni * NT * 128;
    float acc[NT / 2];
    #pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    int kidx = 0;
    int sub = 0;   // chunk within its stage

    // The A fragments of one chunk: KPC k16 steps along (tap, cin).
    auto load = [&](uint32_t (&a)[KPC][4]) {
      #pragma unroll
      for (int s = 0; s < KPC; ++s) {
        if (EARLY_ABLATE == 3) a[s][0] = a[s][1] = a[s][2] = a[s][3] = abase + kidx++;
        else {
          const int ti = kidx / CPK, cc = kidx - ti * CPK, kh = ti / KS, kw = ti - kh * KS;
          ldmatrix_x4(a[s], abase + kh * cv.tap_a + (kw & 1) * cv.tap_b + (kw >> 1) * cv.tap_c + cc * 32);
          ++kidx;
        }
      }
    };
    // One chunk's wgmmas as one group, straight-line, once its weights are in.
    auto mma = [&](const uint32_t (&a)[KPC][4]) {
      WG_PROF(1);
      if (sub == 0) mbar_wait(full0 + 8 * pipe.stage, pipe.phase);
      WG_PROF(0);
      const uint64_t desc = b_desc(ring + pipe.stage * stage_bytes + sub * chunk_bytes + boff);
      wgmma_fence();
      #pragma unroll
      for (int s = 0; s < KPC; ++s)
        if (EARLY_ABLATE != 2 && EARLY_ABLATE < 7) wgmma_rs<NT>(acc, a[s], desc + 2 * s);
      wgmma_commit();
    };
    // The group is complete: its A registers may be loaded again and, after
    // the stage's last chunk, the stage goes back to the producer.
    auto done = [&](uint32_t (&a)[KPC][4]) {
      wgmma_wait<0>();
      #pragma unroll
      for (int s = 0; s < KPC; ++s)
        #pragma unroll
        for (int e = 0; e < 4; ++e) keep(a[s][e]);
      if (++sub == group) {
        sub = 0;
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * pipe.stage);
        pipe.advance(stages);
      }
    };

    if constexpr (STEM) {
      // The stem reads the space-to-depth planes through a descriptor: the 64
      // rows of a tile are 64 consecutive pixels, a tap shifts the start by
      // whole pixels. Nine wgmmas, one per tap, are one group; the three
      // chunks of its weights share one stage.
      WG_PROF(1);
      mbar_wait(full0 + 8 * pipe.stage, pipe.phase);
      WG_PROF(0);
      const uint64_t da = a_desc(cv.src + mi * 64 * 16, cv.row_mul);
      const uint64_t db = b_desc(ring + pipe.stage * stage_bytes + boff);
      wgmma_fence();
      #pragma unroll
      for (int kh = 0; kh < 3; ++kh)
        #pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          if (EARLY_ABLATE != 2 && EARLY_ABLATE < 7)
            wgmma_ss<NT>(acc, da + (kh * cv.o_cols + kw), db + kh * (chunk_bytes >> 4) + 2 * kw);
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * pipe.stage);
      pipe.advance(stages);
    } else {
      // while one chunk multiplies, the next one's fragments are loaded
      uint32_t a0[KPC][4], a1[KPC][4];
      load(a0);
      #pragma unroll
      for (int c = 0; c < nchunks; c += 2) {
        mma(a0);
        if (c + 1 < nchunks) load(a1);
        done(a0);
        if (c + 1 < nchunks) {
          mma(a1);
          if (c + 2 < nchunks) load(a0);
          done(a1);
        }
      }
    }
    #pragma unroll
    for (int i = 0; i < NT / 2; ++i) keep(acc[i]);
    WG_PROF(1);

    if ((EARLY_ABLATE == 5 || EARLY_ABLATE >= 7) && acc[0] != 12345.f) continue;
    // epilogue: bias + SiLU in f32, round to bf16, mask / residual / store.
    // acc[4 j + 2 h + e]: row g + 8 h of this warp's 16, channel 8 j + 2 t + e.
    const bf16* bias = s_bias + lw.boff + ni * NT + 2 * t;
    {
      uint8_t* row[2];
      bool valid[2];
      uint32_t keep_bits[2];   // 0 for a pixel outside the image where a 3x3 reads this next
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mi * 64 + wq * 16 + g + 8 * h;
        const int orow = fast_div(p, cols_magic, cv.o_cols), ocol = p - orow * cv.o_cols;
        valid[h] = p < M && ocol < cv.v_cols;
        const int gr = cv.g_r0 + orow, gc = cv.g_c0 + ocol;
        const bool inside = gr >= 0 && gr < cv.g_h && gc >= 0 && gc < cv.g_w;
        keep_bits[h] = MODE == kMask && !inside ? 0u : 0xFFFFFFFFu;
        if (MODE == kGlobal) {
          row[h] = cv.dst + ((size_t)orow * cv.d_cols + ocol) * cv.d_pitch;
        } else if (SPLIT) {
          row[h] = cv.dst + ((orow * 2 + (ocol & 1)) * cv.d_cols + (ocol >> 1)) * cv.d_pitch;
        } else {
          row[h] = cv.dst + (orow * cv.d_cols + ocol) * cv.d_pitch;
        }
        row[h] += 2 * (ni * NT + 2 * t);
      }
      // first every value (independent chains), then the stores
      uint32_t y[NT / 8][2];
      #pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + 8 * j));
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162 v = __floats2bfloat162_rn(silu(acc[4 * j + 2 * h] + b.x),
                                                   silu(acc[4 * j + 2 * h + 1] + b.y));
          y[j][h] = (EARLY_ABLATE == 1 ? __float_as_uint(acc[4 * j + 2 * h])
                                       : *reinterpret_cast<uint32_t*>(&v)) & keep_bits[h];
        }
      }
      if (MODE == kResidual) {
        #pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          #pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!valid[h]) continue;
            __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(row[h] + 16 * j);
            const __nv_bfloat162 old = *d, v = *reinterpret_cast<__nv_bfloat162*>(&y[j][h]);
            *d = __floats2bfloat162_rn(__bfloat162float(old.x) + __bfloat162float(v.x),
                                       __bfloat162float(old.y) + __bfloat162float(v.y));
          }
        }
      } else {
        #pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          // the padded channels of the output (a pair is wholly in or out: c2 is even)
          const bool stored = MODE != kGlobal || ni * NT + 8 * j + 2 * t < cv.co_store;
          #pragma unroll
          for (int h = 0; h < 2; ++h)
            if (valid[h] && stored && (EARLY_ABLATE != 4 || y[j][h] == 0x12345678u))
              *reinterpret_cast<uint32_t*>(row[h] + 16 * j) = y[j][h];
        }
      }
    }
  }
  WG_PROF(2);
  pipe_io = pipe;
}

// ---- the kernel -------------------------------------------------------------

struct Args {
  const uint8_t* img;
  bf16* out;
  const uint8_t* wpack;
  long long* prof;
  int bs, H, W, n, c2, tiles_x, tiles_y;   // c2: the true output channels (at most kC2)
  Plan p;
};

// A tile's position and the image coordinates of each region's (0, 0).
struct Tile {
  int b, z0, x0;       // image, first /8 row and column
  int r3, q3, r1, q1, r0, q0;
  int rows8, cols8;    // valid /8 rows and columns
  uint32_t m_cols8;    // magic_of(cols8)
};

__device__ __forceinline__ Tile make_tile(int tile, const Args& a) {
  Tile t;
  const int per = a.tiles_x * a.tiles_y;
  t.b = tile / per;
  const int rem = tile - t.b * per;
  const int ty = rem / a.tiles_x;
  t.z0 = ty * a.p.th;  t.x0 = (rem - ty * a.tiles_x) * a.p.tw;
  t.r3 = 2 * t.z0 - 1;  t.q3 = 2 * t.x0 - 1;
  t.r1 = t.r3 - a.n;  t.q1 = t.q3 - a.n;
  t.r0 = 2 * t.r1 - 1;  t.q0 = 2 * t.q1 - 1;
  t.rows8 = min(a.p.th, a.H / 8 - t.z0);
  t.cols8 = min(a.p.tw, a.W / 8 - t.x0);
  t.m_cols8 = magic_of(t.cols8);
  return t;
}

// Band b of a tile: conv1 rows [rb0, rb0 + rows); the stem rows it needs are
// local rows [first, 2 rows + 1) of the band buffer (row 0 is carried over
// from the band before, except in band 0).
struct Band {
  int rb0, rows, first, stem_rows, s2d_rows;
};

__device__ __forceinline__ Band make_band(int b, int rb, int r1) {
  Band d;
  d.rb0 = b * rb;
  d.rows = min(rb, r1 - d.rb0);
  d.first = b > 0 ? 1 : 0;
  d.stem_rows = 2 * d.rows + 1 - d.first;
  d.s2d_rows = d.stem_rows + 2;
  return d;
}

// Starts the copy of a band's raw uint8 rows into shared memory: 8-byte
// pieces, zeros where the piece lies outside the image. Row j of the buffer
// is image row 2 (r0 + 2 rb0 + first) - 2 + j; its first byte is byte
// floor8(3 (2 q0 - 2)) of that row.
__device__ __forceinline__ void start_raw(const uint8_t* img, int H, int W, const Geo& geo,
                                          const Tile& t, const Band& bd, uint32_t s_raw) {
  const int rows = 2 * bd.s2d_rows;
  const int per_row = geo.raw_pitch / 8;
  const int gr0 = 2 * (t.r0 + 2 * bd.rb0 + bd.first) - 2;
  const int gb0 = (3 * (2 * t.q0 - 2)) & ~7;
  const uint8_t* im = img + (size_t)t.b * H * W * 3;
  const int row_bytes = W * 3;
  for (int i = threadIdx.x; i < rows * per_row; i += kConsumerThreads) {
    const int j = fast_div(i, geo.m_raw, per_row), k = i - j * per_row;
    const int gr = gr0 + j, gb = gb0 + 8 * k;
    const bool ok = gr >= 0 && gr < H && gb >= 0 && gb < row_bytes;
    const uint8_t* src = ok ? im + (size_t)gr * row_bytes + gb : im;
    cp_async8(s_raw + j * geo.raw_pitch + 8 * k, src, ok ? 8 : 0);
  }
}

// Raw rows -> bf16 space-to-depth pixels: pixel (a, b) holds the 2 x 2 x 3
// raw values of rows 2a, 2a+1 and columns 2b, 2b+1 in (p, q, c) order, then
// four zeros, as two planes of 8 values (16 bytes) a pixel, `plane` bytes
// apart: the layout a wgmma descriptor without swizzle reads. uint8 -> bf16
// is exact.
__device__ __forceinline__ void convert_s2d(const Geo& geo, const Tile& t, const Band& bd,
                                            const uint8_t* s_raw, uint8_t* s_s2d, int plane) {
  const int delta = 3 * (2 * t.q0 - 2) - ((3 * (2 * t.q0 - 2)) & ~7);
  const int total = bd.s2d_rows * geo.cs;
  for (int i = threadIdx.x; i < total; i += kConsumerThreads) {
    const int ar = fast_div(i, geo.m_cs, geo.cs), bc = i - ar * geo.cs;
    uint32_t w[8];
    #pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint8_t* s = s_raw + (2 * ar + p) * geo.raw_pitch + delta + 6 * bc;
      #pragma unroll
      for (int e = 0; e < 3; ++e) {
        // two pixels' bytes by one 16-bit load (the offset is even); 2^23 + b as float
        // bits, minus 2^23, is b exactly, without the conversion unit
        const uint32_t two = reinterpret_cast<const uint16_t*>(s)[e];
        __nv_bfloat162 v = __floats2bfloat162_rn(
            __uint_as_float(0x4B000000u | (two & 0xFFu)) - 8388608.f,
            __uint_as_float(0x4B000000u | (two >> 8)) - 8388608.f);
        w[3 * p + e] = *reinterpret_cast<uint32_t*>(&v);
      }
    }
    w[6] = 0;  w[7] = 0;
    *reinterpret_cast<uint4*>(s_s2d + (size_t)i * 16) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(s_s2d + plane + (size_t)i * 16) = make_uint4(w[4], w[5], w[6], w[7]);
  }
  // the stem's wgmmas read these planes through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A build with -DEARLY_PROFILE sums clocks per block: slots 0-7 by thread 0
// (0 wait for raw rows, 1 convert, 2 stem, 3 conv1, 4 cv1|cv2, 5 bottlenecks,
// 6 cv3, 7 conv2), then 4 warpgroups x 5 (Shared::wg_clocks).
#ifdef EARLY_PROFILE
constexpr int kProfSlots = 8 + 20;
#define PROF(k) do { if (threadIdx.x == 0) { long long now_ = clock64(); \
                     prof_acc[k] += now_ - prof_last; prof_last = now_; } } while (0)
#define TIMED_SYNC() do { const long long t0_ = clock64(); consumer_sync(); \
    if ((threadIdx.x & 127) == 0) sh.wg_clocks[threadIdx.x >> 7][4] += clock64() - t0_; } while (0)
#else
constexpr int kProfSlots = 0;
#define PROF(k) do { } while (0)
#define TIMED_SYNC() consumer_sync()
#endif

// The barriers of the ring and the layer table; every thread waits for them.
__device__ __forceinline__ void init_shared(Shared& sh, int stages, int n) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&sh.full[s]), 1);
      mbar_init(smem_u32(&sh.empty[s]), kConsumerThreads / 32);
    }
    fill_layers(sh.tab, n);
#ifdef EARLY_PROFILE
    for (int k = 0; k < 20; ++k) sh.wg_clocks[k / 5][k % 5] = 0;
#endif
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer's part of one product of M pixels: the layer's chunks, once a
// round, `group` chunks (contiguous in the packed buffer) a stage. Items run
// N tile by N tile (64-row tiles within), so a round's items use the rows of
// a run of N tiles: a layer of several N tiles copies only those rows of each
// chunk, to where they lie in a whole chunk (one copy a stage where they are
// all the rows).
__device__ __forceinline__ void emit_layer(const Shared& sh, Pipe& pp, const Plan& P,
                                           uint32_t ring, const uint8_t* wpack, int layer, int M) {
  const LayerW lw = sh.tab[layer];
  const int nt = nt_of(lw.co), m_tiles = (M + 63) / 64, items = m_tiles * (lw.co / nt);
  const int rounds = rounds_of(M, lw.co), chunk = lw.co * 128;
  const int nchunks = lw.ksteps / lw.kpc / lw.group, bytes = lw.group * chunk;
  for (int r = 0; r < rounds; ++r) {
    const int first = r * kWarpgroups, last = min(items, first + kWarpgroups) - 1;
    const int row0 = first / m_tiles * nt * 128, rows = (last / m_tiles + 1) * nt * 128 - row0;
    for (int c = 0; c < nchunks; ++c) {
      mbar_wait(smem_u32(&sh.empty[pp.stage]), pp.phase ^ 1);
      const uint32_t full = smem_u32(&sh.full[pp.stage]);
      const uint32_t dst = ring + pp.stage * P.stage_bytes;
      const uint8_t* src = wpack + lw.goff + (size_t)c * bytes;
      if (EARLY_ABLATE == 6 || EARLY_ABLATE == 8) {
        mbar_arrive(full);
      } else if (rows == chunk) {
        mbar_expect_tx(full, bytes);
        bulk_copy(dst, src, bytes, full);
      } else {
        mbar_expect_tx(full, lw.group * rows);
        for (int g = 0; g < lw.group; ++g)
          bulk_copy(dst + g * chunk + row0, src + g * chunk + row0, rows, full);
      }
      pp.advance(P.stages);
    }
  }
}

// Every product's bias, from behind the last layer's chunks, into shared memory.
__device__ __forceinline__ void load_biases(bf16* s_bias, const Shared& sh, const uint8_t* wpack,
                                            int n) {
  const LayerW& last = sh.tab[4 + 2 * n];
  const bf16* gb = reinterpret_cast<const bf16*>(wpack + last.goff
                                                 + (last.ksteps / last.kpc) * last.co * 128);
  for (int i = threadIdx.x; i < total_bias(n); i += kConsumerThreads) s_bias[i] = gb[i];
}

// Carries the last stem row of the band before over to row 0 of the band buffer.
__device__ __forceinline__ void carry_stem_row(const Geo& geo, uint8_t* s_stem, int rb, int p0) {
  const int words = 2 * geo.half0 * p0 / 16;
  const uint4* src = reinterpret_cast<const uint4*>(s_stem + (size_t)(2 * rb) * words * 16);
  uint4* dst = reinterpret_cast<uint4*>(s_stem);
  for (int i = threadIdx.x; i < words; i += kConsumerThreads) dst[i] = src[i];
}

// The stem of band bd: 3x3 over the space-to-depth pixels -> the band buffer
// (parity-split), zero outside the image. Its rows are whole rows of the planes
// (cs pixels, the last 2 not kept), read by descriptor: row_mul carries the
// plane stride, there are no k-step offsets.
__device__ __forceinline__ void stem_conv(Conv& cv, const Geo& geo, const Tile& t, const Band& bd,
                                          uint8_t* s_s2d, uint8_t* s_stem, int s2d_plane, int p0,
                                          int H2, int W2) {
  cv.src = smem_u32(s_s2d);
  cv.row_mul = s2d_plane;  cv.pitch = 0;
  cv.tap_a = 0;  cv.tap_b = 0;  cv.tap_c = 0;
  cv.o_rows = bd.stem_rows;  cv.o_cols = geo.cs;  cv.cols_magic = geo.m_cs;  cv.v_cols = geo.c0;
  cv.dst = s_stem + (size_t)bd.first * 2 * geo.half0 * p0;
  cv.d_cols = geo.half0;  cv.d_pitch = p0;
  cv.layer = 0;
  cv.g_r0 = t.r0 + 2 * bd.rb0 + bd.first;  cv.g_c0 = t.q0;  cv.g_h = H2;  cv.g_w = W2;
}

// conv1 of band bd: 3x3/s2 over the band -> rows [rb0, rb0 + rows) of the conv1 buffer.
__device__ __forceinline__ void conv1_conv(Conv& cv, const Geo& geo, const Tile& t, const Band& bd,
                                           uint8_t* s_stem, uint8_t* s_c1, int p0, int p1,
                                           int H4, int W4) {
  cv.src = smem_u32(s_stem);
  cv.row_mul = 4 * geo.half0;  cv.pitch = p0;
  cv.tap_a = 2 * geo.half0 * p0;  cv.tap_b = geo.half0 * p0;  cv.tap_c = p0;
  cv.o_rows = bd.rows;  cv.o_cols = geo.c1;  cv.cols_magic = geo.m_c1;  cv.v_cols = geo.c1;
  cv.dst = s_c1 + (size_t)bd.rb0 * geo.c1 * p1;
  cv.d_cols = geo.c1;  cv.d_pitch = p1;
  cv.layer = 1;
  cv.g_r0 = t.r1 + bd.rb0;  cv.g_c0 = t.q1;  cv.g_h = H4;  cv.g_w = W4;
}

__global__ void __launch_bounds__(kThreads, 1) early_pipeline_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw_base[];
  __shared__ Shared sh;
  constexpr int c0 = kC0, c1 = kC1, ch = kCH, c2 = kC2;
  constexpr int p0 = (c0 + kPad) * 2, p1 = (c1 + kPad) * 2, pc = (2 * ch + kPad) * 2,
                ph = (ch + kPad) * 2;   // pixel pitches in bytes
  const Plan& P = a.p;
  const int n = a.n;
  const Geo geo = make_geo(n, P.th, P.tw);
  // the ring needs 1024-byte alignment for the 128-byte swizzle
  uint8_t* smem = smem_raw_base + ((1024 - (smem_u32(smem_raw_base) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem + P.off_ring);
  const int ntiles = a.bs * a.tiles_x * a.tiles_y;
  const int nbands = (geo.r1 + P.rb - 1) / P.rb;
  const int layers = 5 + 2 * n;
  const int s2d_plane = (2 * P.rb + 3) * geo.cs * 16;   // bytes of one space-to-depth plane

  init_shared(sh, P.stages, n);

  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 " EARLY_PRODUCER_REGS ";\n");
    // ---- producer warp: streams the weight chunks in the consumers' order ----
    if (threadIdx.x == kConsumerThreads) {
      Pipe pp{0, 0};
      auto emit = [&](int layer, int M) { emit_layer(sh, pp, P, ring, a.wpack, layer, M); };
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const Tile t = make_tile(tile, a);
        for (int b = 0; b < nbands; ++b) {
          const Band bd = make_band(b, P.rb, geo.r1);
          emit(0, bd.stem_rows * geo.cs);
          emit(1, bd.rows * geo.c1);
        }
        emit(2, geo.r1 * geo.c1);
        for (int i = 0; i < n; ++i) {
          emit(3 + 2 * i, geo.r1 * geo.c1);
          emit(4 + 2 * i, (geo.r1 - 2) * (geo.c1 - 2));
        }
        emit(layers - 2, geo.r3 * geo.c3);
        emit(layers - 1, t.rows8 * t.cols8);
      }
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 " EARLY_CONSUMER_REGS ";\n");
  uint8_t* s_c1 = smem + P.off_c1;      // conv1 output; later the C3 output
  uint8_t* s_raw = smem + P.off_raw;
  uint8_t* s_s2d = smem + P.off_s2d;
  uint8_t* s_stem = smem + P.off_stem;
  uint8_t* s_mcat = smem + P.off_mcat;  // cv1 output (+ residuals) | cv2 output
  uint8_t* s_mt = smem + P.off_mt;      // bottleneck 1x1 output
  bf16* s_bias = reinterpret_cast<bf16*>(smem + P.off_bias);
  load_biases(s_bias, sh, a.wpack, n);
#ifdef EARLY_PROFILE
  long long prof_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long prof_last = clock64();
#endif
  Pipe pipe{0, 0};
  const int H2 = a.H / 2, W2 = a.W / 2, H4 = a.H / 4, W4 = a.W / 4;
  Conv cv;

  if ((int)blockIdx.x < ntiles) {
    const Tile t = make_tile(blockIdx.x, a);
    start_raw(a.img, a.H, a.W, geo, t, make_band(0, P.rb, geo.r1), smem_u32(s_raw));
  }
  // One tile is a fixed sequence of products: per band the stem and conv1,
  // then cv1|cv2, n x [m.cv1, m.cv2], cv3, conv2: seven kinds, each inlined
  // once (ptxas serializes a wgmma pipeline that crosses a call).
  const int steps = 2 * nbands + 3 + 2 * n;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile t = make_tile(tile, a);
    for (int step = 0; step < steps; ++step) {
      const int k = step - 2 * nbands;   // >= 0: a product of the C3 or conv2
      int slot;
      bool next_raw = false;
      if (k < 0) {
        const Band bd = make_band(step >> 1, P.rb, geo.r1);
        if ((step & 1) == 0) {
          cp_async_wait_all();
          TIMED_SYNC();   // the raw rows are in; every earlier product is done
          PROF(0);
          convert_s2d(geo, t, bd, s_raw, s_s2d, s2d_plane);
          if (bd.first) carry_stem_row(geo, s_stem, P.rb, p0);
          PROF(1);
          next_raw = true;
          stem_conv(cv, geo, t, bd, s_s2d, s_stem, s2d_plane, p0, H2, W2);
          slot = 2;
        } else {
          conv1_conv(cv, geo, t, bd, s_stem, s_c1, p0, p1, H4, W4);
          slot = 3;
        }
      } else if (k == 0) {
        // cv1 | cv2: 1x1 on the conv1 output -> concat buffer, channels [0, ch) | [ch, 2 ch)
        cv.src = smem_u32(s_c1);
        cv.row_mul = geo.c1;  cv.pitch = p1;
        cv.tap_a = 0;  cv.tap_b = 0;  cv.tap_c = 0;
        cv.o_rows = geo.r1;  cv.o_cols = geo.c1;  cv.cols_magic = geo.m_c1;  cv.v_cols = geo.c1;
        cv.dst = s_mcat;
        cv.d_cols = geo.c1;  cv.d_pitch = pc;
        cv.layer = 2;
        cv.g_r0 = t.r1;  cv.g_c0 = t.q1;  cv.g_h = H4;  cv.g_w = W4;
        slot = 4;
      } else if (k <= 2 * n) {
        cv.layer = 2 + k;
        cv.g_h = H4;  cv.g_w = W4;
        if (k & 1) {
          // bottleneck 1x1: concat[0, ch) -> mt, zero outside the image (a 3x3 reads it next)
          cv.src = smem_u32(s_mcat);
          cv.row_mul = geo.c1;  cv.pitch = pc;
          cv.tap_a = 0;  cv.tap_b = 0;  cv.tap_c = 0;
          cv.o_rows = geo.r1;  cv.o_cols = geo.c1;  cv.cols_magic = geo.m_c1;  cv.v_cols = geo.c1;
          cv.dst = s_mt;
          cv.d_cols = geo.c1;  cv.d_pitch = ph;
          cv.g_r0 = t.r1;  cv.g_c0 = t.q1;
        } else {
          // bottleneck 3x3 + residual: concat[0, ch) of the interior += conv(mt)
          cv.src = smem_u32(s_mt);
          cv.row_mul = geo.c1;  cv.pitch = ph;
          cv.tap_a = geo.c1 * ph;  cv.tap_b = ph;  cv.tap_c = 2 * ph;
          cv.o_rows = geo.r1 - 2;  cv.o_cols = geo.c1 - 2;  cv.cols_magic = geo.m_c1i;  cv.v_cols = geo.c1 - 2;
          cv.dst = s_mcat + (size_t)(geo.c1 + 1) * pc;
          cv.d_cols = geo.c1;  cv.d_pitch = pc;
          cv.g_r0 = t.r1 + 1;  cv.g_c0 = t.q1 + 1;
        }
        slot = 5;
      } else if (k == 2 * n + 1) {
        // cv3: 1x1 on the concat buffer over the C3 region -> parity-split, zero outside
        cv.src = smem_u32(s_mcat + (size_t)(n * geo.c1 + n) * pc);
        cv.row_mul = geo.c1;  cv.pitch = pc;
        cv.tap_a = 0;  cv.tap_b = 0;  cv.tap_c = 0;
        cv.o_rows = geo.r3;  cv.o_cols = geo.c3;  cv.cols_magic = geo.m_c3;  cv.v_cols = geo.c3;
        cv.dst = s_c1;
        cv.d_cols = geo.half3;  cv.d_pitch = p1;
        cv.layer = layers - 2;
        cv.g_r0 = t.r3;  cv.g_c0 = t.q3;  cv.g_h = H4;  cv.g_w = W4;
        slot = 6;
      } else {
        // conv2: 3x3/s2 -> the /8 output tile in device memory
        cv.src = smem_u32(s_c1);
        cv.row_mul = 4 * geo.half3;  cv.pitch = p1;
        cv.tap_a = 2 * geo.half3 * p1;  cv.tap_b = geo.half3 * p1;  cv.tap_c = p1;
        cv.o_rows = t.rows8;  cv.o_cols = t.cols8;  cv.cols_magic = t.m_cols8;  cv.v_cols = t.cols8;
        cv.dst = reinterpret_cast<uint8_t*>(
            a.out + (((size_t)t.b * (a.H / 8) + t.z0) * (a.W / 8) + t.x0) * a.c2);
        cv.d_cols = a.W / 8;  cv.d_pitch = a.c2 * 2;  cv.co_store = a.c2;
        cv.layer = layers - 1;
        cv.g_r0 = t.z0;  cv.g_c0 = t.x0;  cv.g_h = a.H / 8;  cv.g_w = a.W / 8;
        slot = 7;
      }
      TIMED_SYNC();   // what the product before wrote is there
      if (next_raw) {
        // the raw buffer is free: start the next band's rows (or the next tile's first)
        if (step + 2 < 2 * nbands) {
          start_raw(a.img, a.H, a.W, geo, t, make_band((step >> 1) + 1, P.rb, geo.r1),
                    smem_u32(s_raw));
        } else if (tile + (int)gridDim.x < ntiles) {
          start_raw(a.img, a.H, a.W, geo, make_tile(tile + gridDim.x, a),
                    make_band(0, P.rb, geo.r1), smem_u32(s_raw));
        }
      }
      // one instantiation per kind of product: <co, kernel size, k16 steps, stem?, what the
      // epilogue does, parity-split output?>
      switch (slot) {
        case 2: conv_layer<c0, 3, 9, true, kMask, true>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias); break;
        case 3: conv_layer<c1, 3, 9 * c0 / 16, false, kPlain, false>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias); break;
        case 4: conv_layer<2 * ch, 1, c1 / 16, false, kPlain, false>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias); break;
        case 5:
          if (k & 1) conv_layer<ch, 1, ch / 16, false, kMask, false>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias);
          else conv_layer<ch, 3, 9 * ch / 16, false, kResidual, false>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias);
          break;
        case 6: conv_layer<c1, 1, 2 * ch / 16, false, kMask, true>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias); break;
        default: conv_layer<c2, 3, 9 * c1 / 16, false, kGlobal, false>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias); break;
      }
      PROF(slot);
    }
  }
#ifdef EARLY_PROFILE
  consumer_sync();
  if (threadIdx.x == 0 && a.prof != nullptr) {
    for (int k = 0; k < 8; ++k) a.prof[blockIdx.x * kProfSlots + k] = prof_acc[k];
    for (int k = 0; k < 20; ++k) a.prof[blockIdx.x * kProfSlots + 8 + k] = sh.wg_clocks[k / 5][k % 5];
  }
#endif
}

// ---- the staged form ----------------------------------------------------------
//
// For the wide width sets (yolov5x, yolov5l, the width-1.05 config) a fused
// tile that fits one block's shared memory is so small that it recomputes its
// receptive field many times over and streams every weight again for a few
// output pixels. The staged form runs the network as 2 + n kernels through
// device memory instead, each with a halo of at most one 3x3:
//
//   head        stem, conv1, cv1|cv2 of a /4 tile (the stem rolls in bands as
//               above) -> G (bs, H/4, W/4, 2 ch): the C3's two branches
//   bottleneck  m[i] of a /4 tile: its input m (channels [0, ch) of G, then of
//               the last bottleneck's output) with a ring of one pixel, the
//               1x1 over the ring and tile, the 3x3 + residual over the tile
//               -> m in device memory; the last one also runs cv3 on the tile
//               (m | cv2's half of G) -> the C3 output (bs, H/4, W/4, c1)
//   tail        conv2 of a /8 tile: the C3 output it reads, parity-split
//               -> out
//
// Each is a persistent grid of the fused kernel's shape (the producer warp's
// ring, three consumer warpgroups, the same products and epilogues); a
// kernel reads its region by cp.async, zeros outside the image. The
// intermediates (the workspace, `early_pipeline_workspace` bytes) are written
// once and read about once: 0.46 GB a call for yolov5x at bs 8, 640, against
// 33 GB of weights the fused 2x2 tile streams from L2.

struct StageArgs {
  const uint8_t* img;   // head: the images
  const bf16* src;      // bottleneck: its input m; tail: the C3 output
  const bf16* cat;      // the last bottleneck: cv2's output, channels [ch, 2 ch) of G
  bf16* dst;            // head: G; bottleneck: its output m (the last: the C3 output); tail: out
  const uint8_t* wpack;
  int bs, H, W, n, c2, tiles_x, tiles_y;
  int src_pitch;        // channels a pixel of src
  int layer;            // bottleneck: the layer of m[i].cv1, 3 + 2 i
  int last;             // bottleneck: the last one, which also runs cv3
  Plan p;
};

// Tile `tile` of a kernel whose tiles are th x tw pixels of an h x w level:
// its image, its first row and column, and its rows and columns in the image.
__device__ __forceinline__ Tile make_stage_tile(int tile, const StageArgs& a, int h, int w) {
  Tile t;
  const int per = a.tiles_x * a.tiles_y;
  t.b = tile / per;
  const int rem = tile - t.b * per;
  const int ty = rem / a.tiles_x;
  t.z0 = ty * a.p.th;  t.x0 = (rem - ty * a.tiles_x) * a.p.tw;
  t.rows8 = min(a.p.th, h - t.z0);
  t.cols8 = min(a.p.tw, w - t.x0);
  t.m_cols8 = magic_of(t.cols8);
  // the head's regions: conv1 output at (z0, x0) of the /4 level, the stem's from /2 row 2 z0 - 1
  t.r1 = t.z0;  t.q1 = t.x0;
  t.r0 = 2 * t.r1 - 1;  t.q0 = 2 * t.q1 - 1;
  t.r3 = 0;  t.q3 = 0;
  return t;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// Starts copying rows x cols pixels, from (r0, q0) on, of image b of an NHWC
// tensor of an h x w level (`pitch` channels a pixel; its first NCH channels
// from `src` on) to shared memory at dst, `spitch` bytes a pixel: pixel (i, j)
// at i cols + j, or parity-split where half > 0 ((2 i + j % 2) half + j / 2).
// Zeros for pixels outside the image.
template <int NCH>
__device__ __forceinline__ void load_region(const bf16* src, int pitch, int b, int h, int w,
                                            int r0, int q0, int rows, int cols, uint8_t* dst,
                                            int spitch, int half) {
  constexpr int per = NCH / 8;   // 16-byte pieces a pixel
  const uint32_t m_cols = magic_of(cols);
  const int total = rows * cols * per;
  for (int i = threadIdx.x; i < total; i += kConsumerThreads) {
    const int pix = i / per, k = i - pix * per;
    const int r = fast_div(pix, m_cols, cols), c = pix - r * cols;
    const int gr = r0 + r, gc = q0 + c;
    const bool ok = gr >= 0 && gr < h && gc >= 0 && gc < w;
    const bf16* s = ok ? src + (((size_t)b * h + gr) * w + gc) * pitch + 8 * k : src;
    const int slot = half > 0 ? (2 * r + (c & 1)) * half + (c >> 1) : r * cols + c;
    cp_async16(smem_u32(dst + slot * spitch + 16 * k), s, ok ? 16 : 0);
  }
}

// Stores rows x cols pixels (NCH channels) of a shared buffer of `scols`
// pixels a row, `spitch` bytes a pixel, to image b of an NHWC tensor of an
// h x w level with NCH channels a pixel, from (r0, q0) on.
template <int NCH>
__device__ __forceinline__ void store_region(const uint8_t* src, int scols, int spitch, bf16* dst,
                                             int b, int h, int w, int r0, int q0, int rows,
                                             int cols) {
  constexpr int per = NCH / 8;
  const uint32_t m_cols = magic_of(cols);
  const int total = rows * cols * per;
  for (int i = threadIdx.x; i < total; i += kConsumerThreads) {
    const int pix = i / per, k = i - pix * per;
    const int r = fast_div(pix, m_cols, cols), c = pix - r * cols;
    const uint4 v = *reinterpret_cast<const uint4*>(src + (r * scols + c) * spitch + 16 * k);
    *reinterpret_cast<uint4*>(dst + (((size_t)b * h + r0 + r) * w + q0 + c) * NCH + 8 * k) = v;
  }
}

// The head: stem, conv1 and cv1|cv2 of a th x tw tile of the /4 level -> G.
__global__ void __launch_bounds__(kThreads, 1) early_head_kernel(const StageArgs a) {
  extern __shared__ uint8_t smem_raw_base[];
  __shared__ Shared sh;
  constexpr int c0 = kC0, c1 = kC1, ch = kCH;
  constexpr int p0 = (c0 + kPad) * 2, p1 = (c1 + kPad) * 2;
  const Plan& P = a.p;
  const int n = a.n;
  const Geo geo = geo_of(P.th, P.tw, 1, 1);
  uint8_t* smem = smem_raw_base + ((1024 - (smem_u32(smem_raw_base) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem + P.off_ring);
  const int ntiles = a.bs * a.tiles_x * a.tiles_y;
  const int nbands = (geo.r1 + P.rb - 1) / P.rb;
  const int s2d_plane = (2 * P.rb + 3) * geo.cs * 16;
  const int H2 = a.H / 2, W2 = a.W / 2, H4 = a.H / 4, W4 = a.W / 4;
  init_shared(sh, P.stages, n);

  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 " EARLY_PRODUCER_REGS ";\n");
    if (threadIdx.x == kConsumerThreads) {
      Pipe pp{0, 0};
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const Tile t = make_stage_tile(tile, a, H4, W4);
        for (int b = 0; b < nbands; ++b) {
          const Band bd = make_band(b, P.rb, geo.r1);
          emit_layer(sh, pp, P, ring, a.wpack, 0, bd.stem_rows * geo.cs);
          emit_layer(sh, pp, P, ring, a.wpack, 1, bd.rows * geo.c1);
        }
        emit_layer(sh, pp, P, ring, a.wpack, 2, t.rows8 * t.cols8);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 " EARLY_CONSUMER_REGS ";\n");
  uint8_t* s_c1 = smem + P.off_c1;
  uint8_t* s_raw = smem + P.off_raw;
  uint8_t* s_s2d = smem + P.off_s2d;
  uint8_t* s_stem = smem + P.off_stem;
  bf16* s_bias = reinterpret_cast<bf16*>(smem + P.off_bias);
  load_biases(s_bias, sh, a.wpack, n);
  Pipe pipe{0, 0};
  Conv cv;
  if ((int)blockIdx.x < ntiles)
    start_raw(a.img, a.H, a.W, geo, make_stage_tile(blockIdx.x, a, H4, W4),
              make_band(0, P.rb, geo.r1), smem_u32(s_raw));
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile t = make_stage_tile(tile, a, H4, W4);
    for (int step = 0; step <= 2 * nbands; ++step) {
      const Band bd = make_band(step >> 1, P.rb, geo.r1);
      bool next_raw = false;
      if (step == 2 * nbands) {
        // cv1 | cv2: 1x1 on the tile's conv1 output -> G, the pixels inside the image
        cv.src = smem_u32(s_c1);
        cv.row_mul = geo.c1;  cv.pitch = p1;
        cv.tap_a = 0;  cv.tap_b = 0;  cv.tap_c = 0;
        cv.o_rows = t.rows8;  cv.o_cols = t.cols8;  cv.cols_magic = t.m_cols8;  cv.v_cols = t.cols8;
        cv.dst = reinterpret_cast<uint8_t*>(a.dst + (((size_t)t.b * H4 + t.z0) * W4 + t.x0) * 2 * ch);
        cv.d_cols = W4;  cv.d_pitch = 2 * ch * 2;  cv.co_store = 2 * ch;
        cv.layer = 2;
      } else if ((step & 1) == 0) {
        cp_async_wait_all();
        consumer_sync();   // the raw rows are in; every earlier product is done
        convert_s2d(geo, t, bd, s_raw, s_s2d, s2d_plane);
        if (bd.first) carry_stem_row(geo, s_stem, P.rb, p0);
        next_raw = true;
        stem_conv(cv, geo, t, bd, s_s2d, s_stem, s2d_plane, p0, H2, W2);
      } else {
        conv1_conv(cv, geo, t, bd, s_stem, s_c1, p0, p1, H4, W4);
      }
      consumer_sync();   // what the product before wrote is there
      if (next_raw) {
        if (step + 2 < 2 * nbands) {
          start_raw(a.img, a.H, a.W, geo, t, make_band((step >> 1) + 1, P.rb, geo.r1),
                    smem_u32(s_raw));
        } else if (tile + (int)gridDim.x < ntiles) {
          start_raw(a.img, a.H, a.W, geo, make_stage_tile(tile + gridDim.x, a, H4, W4),
                    make_band(0, P.rb, geo.r1), smem_u32(s_raw));
        }
      }
      if (step == 2 * nbands)
        conv_layer<2 * ch, 1, c1 / 16, false, kGlobal, false>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias);
      else if ((step & 1) == 0)
        conv_layer<c0, 3, 9, true, kMask, true>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias);
      else
        conv_layer<c1, 3, 9 * c0 / 16, false, kPlain, false>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias);
    }
  }
}

// One bottleneck, m[i], of a th x tw tile of the /4 level: m + SiLU(3x3(SiLU(1x1(m))))
// -> its output m; the last bottleneck then runs cv3 on (m | cv2's output) -> the C3 output.
__global__ void __launch_bounds__(kThreads, 1) early_bottleneck_kernel(const StageArgs a) {
  extern __shared__ uint8_t smem_raw_base[];
  __shared__ Shared sh;
  constexpr int c1 = kC1, ch = kCH;
  constexpr int pc = (2 * ch + kPad) * 2, ph = (ch + kPad) * 2;
  const Plan& P = a.p;
  const int n = a.n;
  const int rp = P.th + 2, cp = P.tw + 2;   // the tile and its ring of one pixel
  const uint32_t m_cp = magic_of(cp), m_tw = magic_of(P.tw);
  uint8_t* smem = smem_raw_base + ((1024 - (smem_u32(smem_raw_base) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem + P.off_ring);
  const int ntiles = a.bs * a.tiles_x * a.tiles_y;
  const int H4 = a.H / 4, W4 = a.W / 4;
  init_shared(sh, P.stages, n);

  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 " EARLY_PRODUCER_REGS ";\n");
    if (threadIdx.x == kConsumerThreads) {
      Pipe pp{0, 0};
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const Tile t = make_stage_tile(tile, a, H4, W4);
        emit_layer(sh, pp, P, ring, a.wpack, a.layer, rp * cp);
        emit_layer(sh, pp, P, ring, a.wpack, a.layer + 1, P.th * P.tw);
        if (a.last) emit_layer(sh, pp, P, ring, a.wpack, 3 + 2 * n, t.rows8 * t.cols8);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 " EARLY_CONSUMER_REGS ";\n");
  uint8_t* s_cat = smem + P.off_mcat;   // m (+ the residual), and cv2's output for cv3
  uint8_t* s_mt = smem + P.off_mt;      // the 1x1's output
  bf16* s_bias = reinterpret_cast<bf16*>(smem + P.off_bias);
  load_biases(s_bias, sh, a.wpack, n);
  Pipe pipe{0, 0};
  Conv cv;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile t = make_stage_tile(tile, a, H4, W4);
    consumer_sync();   // the tile before is stored: its buffers are free
    load_region<ch>(a.src, a.src_pitch, t.b, H4, W4, t.z0 - 1, t.x0 - 1, rp, cp, s_cat, pc, 0);
    if (a.last)
      load_region<ch>(a.cat, 2 * ch, t.b, H4, W4, t.z0 - 1, t.x0 - 1, rp, cp, s_cat + 2 * ch,
                      pc, 0);
    cp_async_wait_all();
    consumer_sync();
    // m.cv1: 1x1 over the tile and its ring -> mt, zero outside the image (the 3x3 reads it)
    cv.src = smem_u32(s_cat);
    cv.row_mul = cp;  cv.pitch = pc;
    cv.tap_a = 0;  cv.tap_b = 0;  cv.tap_c = 0;
    cv.o_rows = rp;  cv.o_cols = cp;  cv.cols_magic = m_cp;  cv.v_cols = cp;
    cv.dst = s_mt;
    cv.d_cols = cp;  cv.d_pitch = ph;
    cv.layer = a.layer;
    cv.g_r0 = t.z0 - 1;  cv.g_c0 = t.x0 - 1;  cv.g_h = H4;  cv.g_w = W4;
    conv_layer<ch, 1, ch / 16, false, kMask, false>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias);
    consumer_sync();
    // m.cv2: 3x3 over mt + the residual -> m of the tile
    cv.src = smem_u32(s_mt);
    cv.row_mul = cp;  cv.pitch = ph;
    cv.tap_a = cp * ph;  cv.tap_b = ph;  cv.tap_c = 2 * ph;
    cv.o_rows = P.th;  cv.o_cols = P.tw;  cv.cols_magic = m_tw;  cv.v_cols = P.tw;
    cv.dst = s_cat + (size_t)(cp + 1) * pc;
    cv.d_cols = cp;  cv.d_pitch = pc;
    cv.layer = a.layer + 1;
    conv_layer<ch, 3, 9 * ch / 16, false, kResidual, false>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias);
    consumer_sync();
    if (!a.last) {
      store_region<ch>(s_cat + (size_t)(cp + 1) * pc, cp, pc, a.dst, t.b, H4, W4, t.z0, t.x0,
                       t.rows8, t.cols8);
      continue;
    }
    // cv3: 1x1 on (m | cv2's output) of the tile -> the C3 output, the pixels inside the image
    cv.src = smem_u32(s_cat + (size_t)(cp + 1) * pc);
    cv.row_mul = cp;  cv.pitch = pc;
    cv.tap_a = 0;  cv.tap_b = 0;  cv.tap_c = 0;
    cv.o_rows = t.rows8;  cv.o_cols = t.cols8;  cv.cols_magic = t.m_cols8;  cv.v_cols = t.cols8;
    cv.dst = reinterpret_cast<uint8_t*>(a.dst + (((size_t)t.b * H4 + t.z0) * W4 + t.x0) * c1);
    cv.d_cols = W4;  cv.d_pitch = c1 * 2;  cv.co_store = c1;
    cv.layer = 3 + 2 * n;
    conv_layer<c1, 1, 2 * ch / 16, false, kGlobal, false>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias);
  }
}

// The tail: conv2 of a th x tw tile of the /8 output, from the C3 output.
__global__ void __launch_bounds__(kThreads, 1) early_tail_kernel(const StageArgs a) {
  extern __shared__ uint8_t smem_raw_base[];
  __shared__ Shared sh;
  constexpr int c1 = kC1, c2 = kC2;
  constexpr int p1 = (c1 + kPad) * 2;
  const Plan& P = a.p;
  const int n = a.n;
  const int r3 = 2 * P.th + 1, c3 = 2 * P.tw + 1, half3 = P.tw + 1;
  uint8_t* smem = smem_raw_base + ((1024 - (smem_u32(smem_raw_base) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem + P.off_ring);
  const int ntiles = a.bs * a.tiles_x * a.tiles_y;
  const int H4 = a.H / 4, W4 = a.W / 4, H8 = a.H / 8, W8 = a.W / 8;
  init_shared(sh, P.stages, n);

  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 " EARLY_PRODUCER_REGS ";\n");
    if (threadIdx.x == kConsumerThreads) {
      Pipe pp{0, 0};
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const Tile t = make_stage_tile(tile, a, H8, W8);
        emit_layer(sh, pp, P, ring, a.wpack, 4 + 2 * n, t.rows8 * t.cols8);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 " EARLY_CONSUMER_REGS ";\n");
  uint8_t* s_c3 = smem + P.off_c1;   // the C3 output conv2 reads, parity-split
  bf16* s_bias = reinterpret_cast<bf16*>(smem + P.off_bias);
  load_biases(s_bias, sh, a.wpack, n);
  Pipe pipe{0, 0};
  Conv cv;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile t = make_stage_tile(tile, a, H8, W8);
    consumer_sync();   // the tile before is done with the buffer
    load_region<c1>(a.src, c1, t.b, H4, W4, 2 * t.z0 - 1, 2 * t.x0 - 1, r3, c3, s_c3, p1, half3);
    cp_async_wait_all();
    consumer_sync();
    cv.src = smem_u32(s_c3);
    cv.row_mul = 4 * half3;  cv.pitch = p1;
    cv.tap_a = 2 * half3 * p1;  cv.tap_b = half3 * p1;  cv.tap_c = p1;
    cv.o_rows = t.rows8;  cv.o_cols = t.cols8;  cv.cols_magic = t.m_cols8;  cv.v_cols = t.cols8;
    cv.dst = reinterpret_cast<uint8_t*>(a.dst + (((size_t)t.b * H8 + t.z0) * W8 + t.x0) * a.c2);
    cv.d_cols = W8;  cv.d_pitch = a.c2 * 2;  cv.co_store = a.c2;
    cv.layer = 4 + 2 * n;
    conv_layer<c2, 3, 9 * c1 / 16, false, kGlobal, false>(cv, pipe, sh, ring, P.stage_bytes, P.stages, s_bias);
  }
}

// The bytes the kernel touches under this plan, or -1 if two buffers that are
// live together overlap or an offset is not aligned.
int plan_extent(const Plan& P, int n) {
  constexpr int c0 = kC0, c1 = kC1, ch = kCH;
  const Geo g = make_geo(n, P.th, P.tw);
  const int p0 = (c0 + kPad) * 2, p1 = (c1 + kPad) * 2, pc = (2 * ch + kPad) * 2, ph = (ch + kPad) * 2;
  if (P.rb < 1 || P.rb > g.r1 || P.stages < 2 || P.stages > kMaxStages || n < 1
      || 5 + 2 * n > kMaxLayers || P.stage_bytes < kStageRows * 128)
    return -1;
  const int s2d_rows = 2 * P.rb + 3;
  const int size[8] = {
      P.stages * P.stage_bytes,
      (g.r1 * g.c1 > g.r3 * 2 * g.half3 ? g.r1 * g.c1 : g.r3 * 2 * g.half3) * p1,
      2 * s2d_rows * g.raw_pitch,
      s2d_rows * g.cs * kS2dBytes,
      (2 * P.rb + 1) * 2 * g.half0 * p0,
      g.r1 * g.c1 * pc,
      g.r1 * g.c1 * ph,
      total_bias(n) * 2};
  const int off[8] = {P.off_ring, P.off_c1, P.off_raw, P.off_s2d, P.off_stem, P.off_mcat,
                      P.off_mt, P.off_bias};
  // live together: everything, except that {s2d, stem} and {mcat, mt} share their space
  int end = 0;
  for (int i = 0; i < 8; ++i) {
    if (off[i] < 0 || off[i] % (i == 0 ? 1024 : 128)) return -1;
    end = off[i] + size[i] > end ? off[i] + size[i] : end;
    for (int j = 0; j < i; ++j) {
      const bool phase1 = i == 3 || i == 4, phase2 = i == 5 || i == 6;
      const bool other1 = j == 3 || j == 4, other2 = j == 5 || j == 6;
      if ((phase1 && other2) || (phase2 && other1)) continue;
      if (off[i] < off[j] + size[j] && off[j] < off[i] + size[i]) return -1;
    }
  }
  return end;
}

int launch(const Args& a, cudaStream_t stream, int grid) {
  cudaError_t err = cudaFuncSetAttribute(early_pipeline_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.total);
  if (err != cudaSuccess) return (int)err;
  early_pipeline_kernel<<<grid, kThreads, a.p.total, stream>>>(a);
  return (int)cudaGetLastError();
}

// The staged kernels' kinds: the plan's parts 1-3 (ops/early_pipeline.py: StagePlan.kind).
enum Kind { kHeadKind = 1, kBottleneckKind = 2, kTailKind = 3 };

// The bytes a staged kernel of this kind touches under this part of the plan,
// or -1 if two of its buffers overlap, an offset is not aligned or the tile
// is not one the kernel takes (ops/early_pipeline.py: _buffer_sizes).
int stage_extent(const Plan& P, int n, int kind) {
  constexpr int c0 = kC0, c1 = kC1, ch = kCH;
  const int p0 = (c0 + kPad) * 2, p1 = (c1 + kPad) * 2, pc = (2 * ch + kPad) * 2, ph = (ch + kPad) * 2;
  if (P.th < 1 || P.tw < 1 || P.stages < 2 || P.stages > kMaxStages || n < 1
      || 5 + 2 * n > kMaxLayers || P.stage_bytes < kStageRows * 128)
    return -1;
  int size[8] = {P.stages * P.stage_bytes, 0, 0, 0, 0, 0, 0, total_bias(n) * 2};
  if (kind == kHeadKind) {
    const Geo g = geo_of(P.th, P.tw, 1, 1);
    if (P.rb < 1 || P.rb > P.th) return -1;
    const int s2d_rows = 2 * P.rb + 3;
    size[1] = P.th * P.tw * p1;
    size[2] = 2 * s2d_rows * g.raw_pitch;
    size[3] = s2d_rows * g.cs * kS2dBytes;
    size[4] = (2 * P.rb + 1) * 2 * g.half0 * p0;
  } else if (kind == kBottleneckKind) {
    size[5] = (P.th + 2) * (P.tw + 2) * pc;
    size[6] = (P.th + 2) * (P.tw + 2) * ph;
  } else if (kind == kTailKind) {
    size[1] = (2 * P.th + 1) * 2 * (P.tw + 1) * p1;
  } else {
    return -1;
  }
  const int off[8] = {P.off_ring, P.off_c1, P.off_raw, P.off_s2d, P.off_stem, P.off_mcat,
                      P.off_mt, P.off_bias};
  // every buffer of a staged kernel is live all the time
  int end = 0;
  for (int i = 0; i < 8; ++i) {
    if (size[i] == 0) continue;
    if (off[i] < 0 || off[i] % (i == 0 ? 1024 : 128)) return -1;
    end = off[i] + size[i] > end ? off[i] + size[i] : end;
    for (int j = 0; j < i; ++j)
      if (size[j] > 0 && off[i] < off[j] + size[j] && off[j] < off[i] + size[i]) return -1;
  }
  return end;
}

template <typename Kernel>
int launch_stage(Kernel kernel, const StageArgs& a, cudaStream_t stream, int sms) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a.p.total);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = a.bs * a.tiles_x * a.tiles_y;
  const int grid = ntiles < sms ? ntiles : sms;
  kernel<<<grid, kThreads, a.p.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`. c0, c1, ch, c2 are the padded widths of the packed
// weights, c2_out the output's true channels; `plan` holds the 14 ints of
// `Plan`; `prof` is null or, in a build with -DEARLY_PROFILE, room for 28 clock
// sums per block. Returns cudaGetLastError() (0 on success), -1 for widths other
// than this build's, -2 for a plan that does not cover what the kernel uses.
extern "C" int early_pipeline_launch(const void* img, void* out, const void* wpack, void* prof,
                                     int bs, int H, int W, int c0, int c1, int ch, int c2,
                                     int c2_out, int n, const int* plan, void* stream) {
  Args a;
  a.img = (const uint8_t*)img;  a.out = (bf16*)out;  a.wpack = (const uint8_t*)wpack;
  a.prof = (long long*)prof;
  a.bs = bs;  a.H = H;  a.W = W;  a.n = n;  a.c2 = c2_out;
  a.p = Plan{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6], plan[7], plan[8],
             plan[9], plan[10], plan[11], plan[12], plan[13]};
  a.tiles_x = (W / 8 + a.p.tw - 1) / a.p.tw;
  a.tiles_y = (H / 8 + a.p.th - 1) / a.p.th;
  if (c0 != kC0 || c1 != kC1 || ch != kCH || c2 != kC2 || c2_out < 2 || c2_out > kC2
      || c2_out % 2)
    return -1;
  const int extent = plan_extent(a.p, n);
  // 1024 bytes of the total are slack for aligning the ring; the barriers and
  // the layer table are static shared memory beside it
  if (extent < 0 || extent + 1024 > a.p.total || a.p.total + (int)sizeof(Shared) > kSmemLimit)
    return -2;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = bs * a.tiles_x * a.tiles_y;
  const int grid = ntiles < sms ? ntiles : sms;
  return launch(a, (cudaStream_t)stream, grid);
}

extern "C" int early_pipeline_profile_slots() { return kProfSlots; }

// Bytes of device memory the staged form needs between its kernels for a
// batch of bs images of H x W: G (2 ch channels at /4), two buffers of m
// (ch) and the C3 output (c1), at this build's padded widths.
extern "C" long long early_pipeline_workspace(int bs, int H, int W) {
  return (long long)bs * (H / 4) * (W / 4) * (4 * kCH + kC1) * 2;
}

// The staged form (see above) on `stream`: the head, n bottleneck kernels and
// the tail, in turn. Arguments as early_pipeline_launch's, without `prof`;
// `work` is early_pipeline_workspace(bs, H, W) bytes of device memory; `plan`
// holds 3 x 14 ints: the head's, the bottlenecks' and the tail's `Plan`.
// Returns 0, the first launch's error, -1 for widths other than this build's,
// -2 for a plan that does not cover what a kernel uses.
extern "C" int early_pipeline_launch_staged(const void* img, void* out, const void* wpack,
                                            void* work, int bs, int H, int W, int c0, int c1,
                                            int ch, int c2, int c2_out, int n, const int* plan,
                                            void* stream) {
  if (c0 != kC0 || c1 != kC1 || ch != kCH || c2 != kC2 || c2_out < 2 || c2_out > kC2
      || c2_out % 2 || work == nullptr)
    return -1;
  Plan parts[3];
  for (int k = 0; k < 3; ++k) {
    const int* q = plan + 14 * k;
    parts[k] = Plan{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9], q[10], q[11],
                    q[12], q[13]};
    const int extent = stage_extent(parts[k], n, k + 1);
    if (extent < 0 || extent + 1024 > parts[k].total
        || parts[k].total + (int)sizeof(Shared) > kSmemLimit)
      return -2;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t px4 = (size_t)bs * (H / 4) * (W / 4);
  bf16* g = (bf16*)work;                 // (bs, H/4, W/4, 2 ch): m | cv2's output
  bf16* m[2] = {g + px4 * 2 * kCH, g + px4 * 3 * kCH};
  bf16* c3 = g + px4 * 4 * kCH;          // (bs, H/4, W/4, c1)
  StageArgs a{};
  a.img = (const uint8_t*)img;  a.wpack = (const uint8_t*)wpack;
  a.bs = bs;  a.H = H;  a.W = W;  a.n = n;  a.c2 = c2_out;
  const cudaStream_t s = (cudaStream_t)stream;
  auto tiles = [&](const Plan& p, int level) {
    a.p = p;
    a.tiles_x = (W / level + p.tw - 1) / p.tw;
    a.tiles_y = (H / level + p.th - 1) / p.th;
  };
  tiles(parts[0], 4);
  a.dst = g;
  int rc = launch_stage(early_head_kernel, a, s, sms);
  tiles(parts[1], 4);
  for (int i = 0; i < n && rc == 0; ++i) {
    a.src = i == 0 ? g : m[(i - 1) & 1];
    a.src_pitch = i == 0 ? 2 * kCH : kCH;
    a.last = i == n - 1;
    a.cat = g + kCH;
    a.dst = a.last ? c3 : m[i & 1];
    a.layer = 3 + 2 * i;
    rc = launch_stage(early_bottleneck_kernel, a, s, sms);
  }
  if (rc == 0) {
    tiles(parts[2], 8);
    a.src = c3;
    a.dst = (bf16*)out;
    rc = launch_stage(early_tail_kernel, a, s, sms);
  }
  return rc;
}
