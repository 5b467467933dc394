// Forward 3x3x3 convolution, stride 1, zero padding 1, channels-last.
//
// Replaces segmentation_pipeline_tpu/ops/pallas_conv.py::_pallas_conv3x3_s1p1
// (the Pallas TPU kernel _conv3x3_kernel). Computed from the definition:
//
//   out[n,w,h,d,co] = sum_{dw,dh,dd,ci} x[n, w+dw-1, h+dh-1, d+dd-1, ci]
//                                       * k[dw,dh,dd,ci,co]
//
// with x read as zero outside the volume (cross-correlation, no flip).
// x is (N, W, H, D, Cin), k is (3, 3, 3, Cin, Cout), out is (N, W, H, D, Cout),
// all contiguous and of one type (float or bfloat16). Sums are kept in f32;
// the output has the input's type.
//
// What bounds it on an H100: ops = 2*N*W*H*D*27*Cin*Cout operations against
// (N*W*H*D*(Cin+Cout) + 27*Cin*Cout) * sizeof(T) bytes. At the NestedResUNet
// widths (Cin 2..120, Cout 2..120) that is 100-1000 operations per byte, so
// the arithmetic, not the memory, is the limit. Both types run on the tensor
// cores: bf16 at 989 TFLOP/s; f32 as three TF32 products per multiply-add,
// so its bound is max(3 * ops / 495 TFLOP/s, bytes / 3.35 TB/s), 2.5x below
// the 67 TFLOP/s of f32 FMAs on the CUDA cores.
//
// What the design does about it. Per block the work is a GEMM: M = a 4x8x8
// tile of output voxels (grid.x), 256 rows in 16 m16 tiles of two D-runs of
// 8, eight warps of two m16 tiles each; K = 27 taps x Cin, walked in chunks of
// Cin; N = the block's Cout chunk (grid.y), NT n8 tiles (a template
// parameter, 1-5), Cout's n8 tiles shared out evenly over the chunks (5 for
// Cout 40, 5+5 for 80, 5+5+5 for 120, one padded tile for Cout 2), so no
// block computes padded channels and the NT*2*4 f32 sums of a thread stay in
// registers. For each Cin chunk a block stages the zero-masked 6x10x10 input
// halo and the chunk's weights in shared memory (the TPU kernel keeps all
// 27*Cin*Cout weights resident, 518 KB at 120->40 in f32, which no block can
// hold); whole rows of channels go by cp.async with zero fill, ragged channel
// counts (Cin 3, Cin 2, Cout 2) take plain loads, and no padded copy is made.
// One buffer, so a block stages while the other resident blocks compute. A
// fragments (16 voxels x the step's channels) come from ldmatrix.x4 without
// .trans, each lane giving its own voxel's halo row shifted by the tap, so a
// tap is only another address; the warps share a tap's B fragments.
//
// bf16 (conv3x3_s1p1_mma_kernel): mma.sync m16n8k16 (bf16 x bf16, f32 sums,
// the output rounded once to bf16), K steps of 16 channels of one tap. Staging
// keeps bf16: the halo as [600][24] (48-byte rows) and the weights as
// [27][16][(NT|1)*8] (rows an odd number of 16 bytes), so ldmatrix reads are
// free of bank conflicts; 63 KB at NT 5, three blocks per SM (80 registers a
// thread). B fragments (16 channels x 8 Cout) come from ldmatrix.x4.trans.
//
// f32 (conv3x3_s1p1_tf32x3_kernel): mma.sync m16n8k8 in TF32 (f32 sums), K
// steps of 8 channels of one tap, the Cin chunk 8 channels. Each operand is
// split in registers after its load: hi = v rounded to TF32 (cvt.rna), lo =
// v - hi (exact in f32), itself rounded to TF32 (the tensor core reads only
// the top 19 bits of a .tf32 register and would truncate a raw lo). A step
// sums lo*hi + hi*lo + hi*hi, small terms first, and drops lo*lo: each
// product is then within about 2^-21 of the f32 one. The three products of a
// step are summed from zero and the step's sum is added to the running
// f32 sum with an FADD (rounded to nearest): the tensor core's own f32
// accumulation truncates, and up to 1,215 truncations of one running sum
// (27 taps x 15 chunks x 3 at Cin 120) would bias it toward zero. Splitting
// in registers keeps the staging at f32 (halo [600][12], 48-byte rows;
// weights [27][8][(NT|1)*8], row strides of 8 or 24 banks mod 32, so B's
// 32-bit loads of 4 k-rows x 8 columns hit 32 banks) and 63 KB at NT 5,
// where staged hi and lo halves would double it. The split costs 3
// instructions per loaded value, A once per tap for all NT n8 tiles, B once
// per tap for both m16 tiles. The tap loop stays rolled, so that each
// thread's 40 sums, a tap's hi/lo fragments and the step sums fit in the 128
// registers that two resident blocks per SM allow, with no spills.
//
// The PTX helpers (ldmatrix, mma, cp.async, load8) are copies of those in
// conv3x3_s1p1_dw.cu: each source is built and hashed on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int TW = 4, TH = 8, TD = 8;                // output tile (W, H, D)
constexpr int HW = TW + 2, HH = TH + 2, HD = TD + 2;  // input halo tile
constexpr int HALO = HW * HH * HD;
constexpr int TILE = TW * TH * TD;
constexpr int TAPS = 27;

// The bf16 tensor-core kernel.
constexpr int MMA_CIK = 16;          // input channels per K chunk: two groups of 8
constexpr int MMA_XS = 24;           // halo row stride in elements: 48 bytes
constexpr int MMA_COUT_BLOCK = 40;   // at most this many output channels per block (grid.y)
constexpr int MMA_WARPS = 8;
constexpr int MMA_MT = 2;            // m16 tiles per warp: 8 * 2 * 16 = TILE voxels
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_MIN_BLOCKS = 3;    // resident blocks per SM the registers must allow

// The f32 3xTF32 tensor-core kernel: the same tile, warps and Cout chunks.
constexpr int TF_CIK = 8;            // input channels per K chunk: one k8 step per tap
constexpr int TF_XS = 12;            // halo row stride in floats: 48 bytes
constexpr int TF_MIN_BLOCKS = 2;     // resident blocks per SM the registers must allow
static_assert(MMA_WARPS * MMA_MT * 16 == TILE, "the warps' m16 tiles cover the tile");

// Four 8x8 matrices of 16-bit values from shared memory: lanes 8i..8i+7 give
// the addresses of matrix i's eight rows of 16 bytes; each lane receives, per
// matrix, the two values of row lane / 4 in columns 2 * (lane % 4) and + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// The same, transposed (x4: four matrices, x2: two, addressed by lanes 0-15):
// each lane receives, per matrix, the two values of column lane / 4 in rows
// 2 * (lane % 4) and + 1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight bf16 values from src[0..8), zero from index `count` on, one by one:
// for channel counts that are not a multiple of 8.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src, int count) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < count) w[k >> 1] |= (uint32_t)s[k] << (16 * (k & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes from global to shared memory without passing through registers;
// the bytes past `bytes` (all 16 when it is 0) are zero.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// c += a (16x8, row-major) * b (8x8, column-major), TF32 in, f32 sums.
__device__ __forceinline__ void mma_tf32_1688(float (&c)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32 (10 mantissa bits, to nearest, ties away from zero), as
// the 32-bit pattern with its low 13 bits zero.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 2^-22 of v: hi = v in TF32, lo = v - hi (exact in
// f32) rounded to TF32 too, not passed raw for the tensor core to truncate.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// Four floats from src[0..4), zero from index `count` on (all four when it
// is 0 or less), one by one: for channel counts that are not a multiple of 4.
__device__ __forceinline__ float4 load4(const float* src, int count) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < count) v[k] = src[k];
  return make_float4(v[0], v[1], v[2], v[3]);
}

// grid.x: n * tiles_w * tiles_h * tiles_d; grid.y: the Cout chunks, NT n8
// tiles each (the last block's may run past Cout); blockDim.x = MMA_THREADS.
// x_vec / k_vec: Cin / Cout is a multiple of 8 and the tensor 16-byte
// aligned, so rows of 8 channels are staged by cp.async.
template <int NT>
__global__ void __launch_bounds__(MMA_THREADS, MMA_MIN_BLOCKS)
conv3x3_s1p1_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ k,
                        __nv_bfloat16* __restrict__ out, int W, int H, int D, int Cin, int Cout,
                        int tiles_w, int tiles_h, int tiles_d, int x_vec, int k_vec) {
  constexpr int KS = (NT | 1) * 8;  // weight row stride: an odd number of 16 bytes
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_bytes);  // [HALO][MMA_XS]
  __nv_bfloat16* ks = xs + HALO * MMA_XS;                            // [TAPS][MMA_CIK][KS]

  int r = blockIdx.x;
  const int d0 = (r % tiles_d) * TD;
  r /= tiles_d;
  const int h0 = (r % tiles_h) * TH;
  r /= tiles_h;
  const int w0 = (r % tiles_w) * TW;
  const int n = r / tiles_w;
  const int co0 = blockIdx.y * NT * 8;
  const int ncout = min(NT * 8, Cout - co0);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mat = lane >> 3;  // the ldmatrix matrix this lane addresses
  const int mrow = lane & 7;  // and its row there

  // A (16 voxels x 16 channels) of m16 tile j = 2 * warp + mt: matrices
  // 0..3 are (D-run 2j, channels 0-7), (2j + 1, 0-7), (2j, 8-15),
  // (2j + 1, 8-15); a lane's row is voxel mrow of its run, D-run r at
  // (vw, vh) = (r / TH, r % TH). The tap adds its offset in the halo.
  const uint32_t xs_addr = (uint32_t)__cvta_generic_to_shared(xs);
  const uint32_t ks_addr = (uint32_t)__cvta_generic_to_shared(ks);
  uint32_t a_addr[MMA_MT];
#pragma unroll
  for (int mt = 0; mt < MMA_MT; ++mt) {
    const int run = 2 * (2 * warp + mt) + (mat & 1);
    const int pos = ((run / TH) * HH + run % TH) * HD + mrow;
    a_addr[mt] = xs_addr + 2 * (pos * MMA_XS + (mat >> 1) * 8);
  }
  // B (16 channels x 8 Cout) of n8 tiles t, t + 1: matrices (t, channels
  // 0-7), (t, 8-15), (t + 1, 0-7), (t + 1, 8-15); a lane's row is channel
  // mrow of its half.
  const uint32_t b_addr = ks_addr + 2 * (((mat & 1) * 8 + mrow) * KS + (mat >> 1) * 8);

  float acc[MMA_MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MMA_MT; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += MMA_CIK) {
    const int ncin = min(MMA_CIK, Cin - c0);
    // Input halo for channels c0..c0+16, 8 at a time, zero outside the
    // volume and past Cin.
    for (int i = tid; i < HALO * 2; i += MMA_THREADS) {
      const int c = (i & 1) * 8;
      const int v = i >> 1;
      const int gd = d0 + v % HD - 1;
      const int gh = h0 + (v / HD) % HH - 1;
      const int gw = w0 + v / (HD * HH) - 1;
      const bool in = c < ncin && gw >= 0 && gw < W && gh >= 0 && gh < H && gd >= 0 && gd < D;
      const __nv_bfloat16* src =
          in ? x + ((((size_t)n * W + gw) * H + gh) * D + gd) * Cin + c0 + c : x;
      __nv_bfloat16* dst = xs + v * MMA_XS + c;
      if (x_vec)
        cp_async16((uint32_t)__cvta_generic_to_shared(dst), src, in ? 16 : 0);
      else
        *reinterpret_cast<uint4*>(dst) = in ? load8(src, ncin - c) : make_uint4(0, 0, 0, 0);
    }
    // Weights of the same channels and this block's outputs, zero past Cin
    // and Cout: row tap * 16 + ci.
    for (int i = tid; i < TAPS * MMA_CIK * NT; i += MMA_THREADS) {
      const int c = (i % NT) * 8;
      const int row = i / NT;
      const int ci = row % MMA_CIK;
      const bool in = ci < ncin && c < ncout;
      const __nv_bfloat16* src =
          in ? k + ((size_t)(row / MMA_CIK) * Cin + c0 + ci) * Cout + co0 + c : k;
      __nv_bfloat16* dst = ks + row * KS + c;
      if (k_vec)
        cp_async16((uint32_t)__cvta_generic_to_shared(dst), src, in ? 16 : 0);
      else
        *reinterpret_cast<uint4*>(dst) = in ? load8(src, ncout - c) : make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int off = ((tap / 9) * HH + (tap / 3) % 3) * HD + tap % 3;
      uint32_t b[NT][2];
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        const uint32_t addr = b_addr + 2 * (tap * MMA_CIK * KS + t * 8);
        if (t + 1 < NT)
          ldmatrix_x4_trans(addr, b[t][0], b[t][1], b[t + 1][0], b[t + 1][1]);
        else
          ldmatrix_x2_trans(addr, b[t][0], b[t][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MMA_MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a_addr[mt] + 2 * off * MMA_XS, a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int t = 0; t < NT; ++t) mma_bf16_16816(acc[mt][t], a, b[t][0], b[t][1]);
      }
    }
    __syncthreads();
  }

  // Accumulator e of n8 tile t: row (e / 2) * 8 + lane / 4 of the m16 tile,
  // that is voxel lane / 4 of D-run 2j + e / 2, and column t * 8 +
  // 2 * (lane % 4) + e % 2. Neighbouring Cout go out as one bfloat162.
  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MMA_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int run = 2 * (2 * warp + mt) + h;
      const int ow = w0 + run / TH;
      const int oh = h0 + run % TH;
      const int od = d0 + (lane >> 2);
      if (ow >= W || oh >= H || od >= D) continue;
      __nv_bfloat16* o = out + ((((size_t)n * W + ow) * H + oh) * D + od) * Cout + co0;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int co = t * 8 + 2 * (lane & 3);
        const float v0 = acc[mt][t][2 * h], v1 = acc[mt][t][2 * h + 1];
        if (pairs && co + 1 < ncout) {
          *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < ncout) o[co] = __float2bfloat16(v0);
          if (co + 1 < ncout) o[co + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// grid.x: n * tiles_w * tiles_h * tiles_d; grid.y: the Cout chunks, NT n8
// tiles each (the last block's may run past Cout); blockDim.x = MMA_THREADS.
// x_vec / k_vec: Cin / Cout is a multiple of 4 and the tensor 16-byte
// aligned, so groups of 4 channels are staged by cp.async.
template <int NT>
__global__ void __launch_bounds__(MMA_THREADS, TF_MIN_BLOCKS)
conv3x3_s1p1_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ k,
                           float* __restrict__ out, int W, int H, int D, int Cin, int Cout,
                           int tiles_w, int tiles_h, int tiles_d, int x_vec, int k_vec) {
  constexpr int KS = (NT | 1) * 8;  // weight row stride: 8 or 24 banks mod 32
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  float* xs = reinterpret_cast<float*>(smem_bytes);  // [HALO][TF_XS]
  float* ks = xs + HALO * TF_XS;                     // [TAPS][TF_CIK][KS]

  int r = blockIdx.x;
  const int d0 = (r % tiles_d) * TD;
  r /= tiles_d;
  const int h0 = (r % tiles_h) * TH;
  r /= tiles_h;
  const int w0 = (r % tiles_w) * TW;
  const int n = r / tiles_w;
  const int co0 = blockIdx.y * NT * 8;
  const int ncout = min(NT * 8, Cout - co0);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mat = lane >> 3;  // the ldmatrix matrix this lane addresses
  const int mrow = lane & 7;  // and its row there

  // A (16 voxels x 8 channels) of m16 tile j = 2 * warp + mt: matrices
  // 0..3 are (D-run 2j, channels 0-3), (2j + 1, 0-3), (2j, 4-7), (2j + 1,
  // 4-7), rows of 4 floats, so each lane receives a0..a3 of m16n8k8's row-
  // major A: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) with g = lane / 4,
  // t = lane % 4. A lane's row is voxel mrow of its run, D-run r at (vw, vh)
  // = (r / TH, r % TH). The tap adds its offset in the halo.
  const uint32_t xs_addr = (uint32_t)__cvta_generic_to_shared(xs);
  uint32_t a_addr[MMA_MT];
#pragma unroll
  for (int mt = 0; mt < MMA_MT; ++mt) {
    const int run = 2 * (2 * warp + mt) + (mat & 1);
    const int pos = ((run / TH) * HH + run % TH) * HD + mrow;
    a_addr[mt] = xs_addr + 4 * (pos * TF_XS + (mat >> 1) * 4);
  }
  // B (8 channels x 8 Cout, column-major): b0 = (channel t, Cout g), b1 =
  // (t + 4, g) of each n8 tile, 32-bit loads.
  const float* kb = ks + (lane & 3) * KS + (lane >> 2);

  float acc[MMA_MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MMA_MT; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += TF_CIK) {
    const int ncin = min(TF_CIK, Cin - c0);
    // Input halo for channels c0..c0+8, 4 at a time, zero outside the volume
    // and past Cin.
    for (int i = tid; i < HALO * 2; i += MMA_THREADS) {
      const int c = (i & 1) * 4;
      const int v = i >> 1;
      const int gd = d0 + v % HD - 1;
      const int gh = h0 + (v / HD) % HH - 1;
      const int gw = w0 + v / (HD * HH) - 1;
      const bool in = c < ncin && gw >= 0 && gw < W && gh >= 0 && gh < H && gd >= 0 && gd < D;
      const float* src = in ? x + ((((size_t)n * W + gw) * H + gh) * D + gd) * Cin + c0 + c : x;
      float* dst = xs + v * TF_XS + c;
      if (x_vec)
        cp_async16((uint32_t)__cvta_generic_to_shared(dst), src, in ? 16 : 0);
      else
        *reinterpret_cast<float4*>(dst) = load4(src, in ? ncin - c : 0);
    }
    // Weights of the same channels and this block's outputs, zero past Cin
    // and Cout: row tap * 8 + ci.
    for (int i = tid; i < TAPS * TF_CIK * NT * 2; i += MMA_THREADS) {
      const int c = (i % (NT * 2)) * 4;
      const int row = i / (NT * 2);
      const int ci = row % TF_CIK;
      const bool in = ci < ncin && c < ncout;
      const float* src = in ? k + ((size_t)(row / TF_CIK) * Cin + c0 + ci) * Cout + co0 + c : k;
      float* dst = ks + row * KS + c;
      if (k_vec)
        cp_async16((uint32_t)__cvta_generic_to_shared(dst), src, in ? 16 : 0);
      else
        *reinterpret_cast<float4*>(dst) = load4(src, in ? ncout - c : 0);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // rolled on purpose: unrolled, ptxas hoists later taps' loads and spills at NT 4-5
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
      const int off = ((tap / 9) * HH + (tap / 3) % 3) * HD + tap % 3;
      uint32_t a_hi[MMA_MT][4], a_lo[MMA_MT][4];
#pragma unroll
      for (int mt = 0; mt < MMA_MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a_addr[mt] + 4 * off * TF_XS, a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), a_hi[mt][e], a_lo[mt][e]);
      }
      const float* kt = kb + tap * TF_CIK * KS;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t b_hi[2], b_lo[2];
        split_tf32(kt[t * 8], b_hi[0], b_lo[0]);
        split_tf32(kt[t * 8 + 4 * KS], b_hi[1], b_lo[1]);
#pragma unroll
        for (int mt = 0; mt < MMA_MT; ++mt) {
          float step[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32_1688(step, a_lo[mt], b_hi[0], b_hi[1]);
          mma_tf32_1688(step, a_hi[mt], b_lo[0], b_lo[1]);
          mma_tf32_1688(step, a_hi[mt], b_hi[0], b_hi[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][t][e] += step[e];
        }
      }
    }
    __syncthreads();
  }

  // Accumulator e of n8 tile t: row (e / 2) * 8 + lane / 4 of the m16 tile,
  // that is voxel lane / 4 of D-run 2j + e / 2, and column t * 8 +
  // 2 * (lane % 4) + e % 2. Neighbouring Cout go out as one float2.
  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MMA_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int run = 2 * (2 * warp + mt) + h;
      const int ow = w0 + run / TH;
      const int oh = h0 + run % TH;
      const int od = d0 + (lane >> 2);
      if (ow >= W || oh >= H || od >= D) continue;
      float* o = out + ((((size_t)n * W + ow) * H + oh) * D + od) * Cout + co0;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int co = t * 8 + 2 * (lane & 3);
        const float v0 = acc[mt][t][2 * h], v1 = acc[mt][t][2 * h + 1];
        if (pairs && co + 1 < ncout) {
          *reinterpret_cast<float2*>(o + co) = make_float2(v0, v1);
        } else {
          if (co < ncout) o[co] = v0;
          if (co + 1 < ncout) o[co + 1] = v1;
        }
      }
    }
}

template <int NT>
int launch_mma(const void* x, const void* k, void* out, int N, int W, int H, int D, int Cin,
               int Cout, int chunks, void* stream) {
  const int smem = (HALO * MMA_XS + TAPS * MMA_CIK * (NT | 1) * 8) * (int)sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_s1p1_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_d = (D + TD - 1) / TD;
  const int x_vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int k_vec = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const dim3 grid(N * tiles_w * tiles_h * tiles_d, chunks);
  conv3x3_s1p1_mma_kernel<NT><<<grid, MMA_THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)k, (__nv_bfloat16*)out, W, H, D, Cin,
      Cout, tiles_w, tiles_h, tiles_d, x_vec, k_vec);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_tf32x3(const void* x, const void* k, void* out, int N, int W, int H, int D,
                  int Cin, int Cout, int chunks, void* stream) {
  constexpr int smem = (HALO * TF_XS + TAPS * TF_CIK * (NT | 1) * 8) * (int)sizeof(float);
  // Above 48 KB a block's shared memory must be allowed per function and
  // device: once per instantiation and device, not on every launch.
  static std::atomic<uint64_t> allowed{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = uint64_t(1) << (device & 63);
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(conv3x3_s1p1_tf32x3_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed |= bit;
  }
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_d = (D + TD - 1) / TD;
  const int x_vec = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int k_vec = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const dim3 grid(N * tiles_w * tiles_h * tiles_d, chunks);
  conv3x3_s1p1_tf32x3_kernel<NT><<<grid, MMA_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)k, (float*)out, W, H, D, Cin, Cout, tiles_w, tiles_h,
      tiles_d, x_vec, k_vec);
  return (int)cudaGetLastError();
}

// Cout's n8 tiles shared out evenly over the fewest chunks of at most
// MMA_COUT_BLOCK channels: launch(NT, chunks) with NT the n8 tiles per chunk.
template <typename Launch>
int by_cout_chunks(int Cout, Launch&& launch) {
  const int chunks = (Cout + MMA_COUT_BLOCK - 1) / MMA_COUT_BLOCK;
  switch (((Cout + 7) / 8 + chunks - 1) / chunks) {
    case 1: return launch(std::integral_constant<int, 1>{}, chunks);
    case 2: return launch(std::integral_constant<int, 2>{}, chunks);
    case 3: return launch(std::integral_constant<int, 3>{}, chunks);
    case 4: return launch(std::integral_constant<int, 4>{}, chunks);
    default: return launch(std::integral_constant<int, 5>{}, chunks);
  }
}

}  // namespace

// f32: the 3xTF32 tensor-core kernel.
extern "C" int conv3x3_s1p1_f32(const void* x, const void* k, void* out, int N, int W, int H,
                                int D, int Cin, int Cout, void* stream) {
  return by_cout_chunks(Cout, [&](auto nt, int chunks) {
    return launch_tf32x3<decltype(nt)::value>(x, k, out, N, W, H, D, Cin, Cout, chunks, stream);
  });
}

// bf16: the bf16 tensor-core kernel.
extern "C" int conv3x3_s1p1_bf16(const void* x, const void* k, void* out, int N, int W, int H,
                                 int D, int Cin, int Cout, void* stream) {
  return by_cout_chunks(Cout, [&](auto nt, int chunks) {
    return launch_mma<decltype(nt)::value>(x, k, out, N, W, H, D, Cin, Cout, chunks, stream);
  });
}
