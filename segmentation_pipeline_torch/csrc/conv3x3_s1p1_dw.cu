// Weight gradient of the 3x3x3 convolution, stride 1, zero padding 1,
// channels-last.
//
// Replaces the dW half of the custom VJP of the Pallas TPU kernel,
// segmentation_pipeline_tpu/ops/pallas_conv.py::_bwd (27 tap-window products
// in a lax.scan, pallas_conv.py:128-142). Computed from the definition:
//
//   dk[dw,dh,dd,ci,co] = sum_{n,w,h,d} x[n, w+dw-1, h+dh-1, d+dd-1, ci]
//                                      * g[n,w,h,d,co]
//
// with x read as zero outside the volume. x is (N, W, H, D, Cin), g is
// (N, W, H, D, Cout), dk is (3, 3, 3, Cin, Cout), all contiguous and of one
// type T (float or bfloat16). Sums are kept in f32; dk has the inputs' type.
//
// What bounds it on an H100: the same 2*N*W*H*D*27*Cin*Cout operations as
// the forward against (N*W*H*D*(Cin+Cout) + 27*Cin*Cout) * sizeof(T) bytes,
// so the arithmetic is the limit. Both types run on the tensor cores: bf16
// at 989 TFLOP/s; f32 as three TF32 products per multiply-add, so its bound
// is max(3 * ops / 495 TFLOP/s, bytes / 3.35 TB/s). Unlike the forward, the
// reduction runs over the M = N*W*H*D voxels (811,008 at the dmri_hippo
// training batch) into a small output (27*Cin*Cout, at most 129,600 values
// at 120->40): a split-K problem.
//
// What this design does about it. Both types cut the voxels into 4x8x8
// tiles, as the forward does, give each block a contiguous run of tiles (one
// of `splits` runs), stage the zero-masked 6x10x10 x halo of the block's Cin
// chunk and the g tile of its Cout chunk in shared memory, keep the sums in
// registers across the run, and write them to an f32 workspace row of the
// split; a second launch adds the rows in split order. No atomics: the
// result is the same bit for bit from run to run. Per block the work is a
// GEMM with a long K: (27 taps * Cin chunk) x voxels times voxels x Cout
// chunk. M rows go in groups of 8 channels of one tap, two groups per m16
// tile (the two may be of different taps); Cout goes on the n8 side, its n8
// tiles shared out evenly over chunks of at most five (NT, a template
// parameter: five tiles for Cout 40, none padded; one padded tile for Cout
// 2); K walks the tile's voxels in D-runs of 8. Grid.x is the Cin chunk, so
// the blocks that read one g tile run side by side and share it in L2;
// grid.y is the split, grid.z the Cout chunk.
//
// bf16 (dw_partial_mma_kernel): mma.sync m16n8k16 (bf16 x bf16, f32 sums),
// Cin chunks of 16 channels (54 groups, 27 m16 tiles, none padded), K steps
// of two D-runs. Staging keeps bf16 (48-byte x rows, g rows an odd number of
// 16 bytes, so ldmatrix reads are free of bank conflicts) and goes by
// cp.async into the other of two buffers while the current tile is
// multiplied. Fragments come from ldmatrix.x4.trans, each lane giving its
// own row address, so the tap's shift of the halo is only another address.
// Nine warps take three m16 tiles each across all of the chunk's n8 tiles:
// 60 f32 sums a thread at NT 5, within the 96 registers that two resident
// blocks per SM leave.
//
// f32 (dw_partial_tf32x3_kernel): mma.sync m16n8k8 in TF32 (f32 sums), as
// the forward's f32 kernel computes it: each operand is split into hi = v
// rounded to TF32 (cvt.rna) and lo = v - hi (exact in f32) rounded to TF32
// too; a step sums lo*hi + hi*lo + hi*hi, small terms first, and drops
// lo*lo, so each product is within about 2^-21 of the f32 one. The three
// products of a K step (one D-run of 8 voxels) are summed from zero and
// added to the running f32 sum with an FADD (rounded to nearest): the
// tensor core's own f32 accumulation truncates, and a running sum fed by
// every MMA of a split (up to 32 steps per tile times thousands of tiles)
// would drift toward zero. K is the slow axis of both staged operands
// ([voxel][channel]), and ldmatrix transposes only 16-bit values, so both
// fragments come from 32-bit shared loads: a0..a3 = x at (voxel t, channel
// g), (t, g) of the second group, (t + 4, g), (t + 4, g) of the second
// group, and b0, b1 = g at (voxel t, Cout g), (t + 4, g), with g = lane /
// 4, t = lane % 4. They are free of bank conflicts because a voxel row is 8
// or 24 banks mod 32: x rows of 8 floats (the Cin chunk is 8 channels: 27
// groups, 14 m16 tiles, the last half padded), g rows of (NT|1)*8 floats.
// cvt.rna.tf32.f32 compiles to four instructions (add, Inf/NaN test,
// select, mask), so a split costs seven; the g tile is therefore split once
// as it is staged, into hi and lo halves, rather than by each of the seven
// warps at every K step (70 of about 214 instructions a warp would run
// per K step at NT 5). The x halo is split in registers after its load,
// once per K step for all NT n8 tiles: staging it split too would leave one
// block per SM. One buffer, 99 KB at NT 5 (x by cp.async where rows of 4
// channels are whole, g through registers for the split, plain loads for
// Cin 3 and Cout 2); two resident blocks per SM, so one stages while the
// other multiplies. Seven warps take two m16 tiles each across all of the
// chunk's n8 tiles. Two blocks of seven warps (eight for register
// allocation) leave a thread 128 registers, which hold its 40 sums and one
// K step's fragments with the D-run loop rolled.
//
// The PTX helpers (ldmatrix, mma, cp.async, load8, load4, the TF32 split)
// are copies of those in conv3x3_s1p1.cu: each source is built and hashed on
// its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int TW = 4, TH = 8, TD = 8;                // voxel tile (W, H, D)
constexpr int HW = TW + 2, HH = TH + 2, HD = TD + 2;  // x halo tile
constexpr int HALO = HW * HH * HD;
constexpr int TILE = TW * TH * TD;
constexpr int TAPS = 27;
constexpr int COUT_BLOCK = 40;       // at most this many output channels per block (grid.z)
constexpr int REDUCE_THREADS = 256;

// The bf16 tensor-core kernel.
constexpr int MMA_CIK = 16;          // input channels per block (grid.x): two groups of 8
constexpr int MMA_XS = 24;           // x halo row stride in elements: 48 bytes
constexpr int MMA_WARPS = 9;
constexpr int MMA_MT = 3;            // m16 tiles per warp: 9 * 3 = 27 * 16 / 16
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_TARGET_BLOCKS = 4 * 132;  // two waves of two resident blocks per SM
constexpr int MMA_BUF = HALO * MMA_XS + TILE * COUT_BLOCK;  // one tile's staging, bf16
constexpr size_t MMA_SMEM = 2 * MMA_BUF * sizeof(__nv_bfloat16);  // double-buffered

// The f32 3xTF32 tensor-core kernel.
constexpr int TF_CIK = 8;            // input channels per block (grid.x): one group of 8
constexpr int TF_XS = 8;             // x halo row stride in floats: 8 banks
constexpr int TF_WARPS = 7;
constexpr int TF_MT = 2;             // m16 tiles per warp: 7 * 2 = 14 = ceil(27 groups / 2)
constexpr int TF_THREADS = TF_WARPS * 32;
constexpr int TF_MIN_BLOCKS = 2;     // resident blocks per SM the registers must allow
constexpr int TF_TARGET_BLOCKS = 2 * TF_MIN_BLOCKS * 132;  // two waves
static_assert(2 * TF_WARPS * TF_MT >= TAPS, "the warps' m16 tiles cover the 27 groups");

// One tile's f32 staging at NT n8 tiles: the x halo, then the g tile's hi
// and lo halves.
constexpr int tf_smem(int nt) {
  return (HALO * TF_XS + 2 * TILE * (nt | 1) * 8) * (int)sizeof(float);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Geometry {
  int tiles_w, tiles_h, tiles_d, n_tiles;
  Geometry(int N, int W, int H, int D)
      : tiles_w((W + TW - 1) / TW), tiles_h((H + TH - 1) / TH), tiles_d((D + TD - 1) / TD),
        n_tiles(N * tiles_w * tiles_h * tiles_d) {}
  static int chunks_out(int Cout) { return (Cout + COUT_BLOCK - 1) / COUT_BLOCK; }
  // At most `target` blocks of `cik` input channels each, so the last wave
  // is not a sliver.
  int splits(int Cin, int Cout, int cik, int target) const {
    const int per_split = (Cin + cik - 1) / cik * chunks_out(Cout);
    return std::max(1, std::min(n_tiles, target / per_split));
  }
};

// Four (x4) or two (x2) 8x8 matrices of 16-bit values from shared memory,
// transposed: lanes 8i..8i+7 give the addresses of matrix i's eight rows of
// 16 bytes; each lane receives, per matrix, the two values of column
// lane / 4 in rows 2 * (lane % 4) and + 1.
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

// Wait until at most the latest committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_all_but_latest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// grid: (ceil(Cin / MMA_CIK), splits, ceil(Cout / COUT_BLOCK)); each
// block takes NT n8 tiles of Cout (the last block's may run past Cout);
// blockDim.x = MMA_THREADS. work[s][tap][ci][co] receives split s's sums.
// x_vec / g_vec: Cin / Cout is a multiple of 8 and the tensor 16-byte
// aligned, so rows of 8 channels are staged by cp.async.
template <int NT>
__global__ void __launch_bounds__(MMA_THREADS, 2)
dw_partial_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                      float* __restrict__ work, int W, int H, int D, int Cin, int Cout,
                      int tiles_w, int tiles_h, int tiles_d, int n_tiles, int splits,
                      int x_vec, int g_vec) {
  // Two buffers, each the x halo [HALO][MMA_XS] then the g tile [TILE][gstride].
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_bytes);

  const int c0 = blockIdx.x * MMA_CIK;
  const int s = blockIdx.y;
  const int co0 = blockIdx.z * NT * 8;
  const int ncin = min(MMA_CIK, Cin - c0);
  const int ncout = min(NT * 8, Cout - co0);
  const int ng = (ncin + 7) / 8;          // channel groups of 8 in this chunk: 1 or 2
  constexpr int gstride = (NT | 1) * 8;   // g row stride, an odd number of 16 bytes
  const int n_groups = TAPS * ng;         // group q: tap q / ng, channels (q % ng) * 8 + 0..7
  const int n_m16 = (n_groups + 1) / 2;   // m16 tile j: groups 2j (rows 0-7), 2j + 1 (rows 8-15)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mat = lane >> 3;              // the ldmatrix matrix this lane addresses
  const int mrow = lane & 7;              // and its row there: voxel d = mrow of a D-run

  // A (16 rows (tap, ci) x 16 voxels): matrices 0..3 are (group 2j, k 0-7),
  // (2j + 1, k 0-7), (2j, k 8-15), (2j + 1, k 8-15); a lane's row address is
  // its voxel's halo position shifted by its group's tap, at its group's
  // channels. Warp w takes m16 tiles w, w + 9, w + 18.
  int a_off[MMA_MT];
#pragma unroll
  for (int mt = 0; mt < MMA_MT; ++mt) {
    int q = 2 * (warp + MMA_WARPS * mt) + (mat & 1);
    if (q >= n_groups) q = 0;  // the padded half of the last m16 tile: never stored
    const int tap = q / ng;
    a_off[mt] = (((tap / 9) * HH + (tap / 3) % 3) * HD + tap % 3) * MMA_XS + (q % ng) * 8;
  }
  const int a_run = mat >> 1;  // D-run 2 * kstep + a_run
  // B (16 voxels x 8 Cout) for n8 tiles t, t + 1: matrices (t, k 0-7),
  // (t, k 8-15), (t + 1, k 0-7), (t + 1, k 8-15).
  const int b_run = mat & 1;
  const int b_tile = mat >> 1;

  float acc[MMA_MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MMA_MT; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;

  // Stage a tile into buffer `buf`: x halo and g tile 8 channels at a time,
  // zero outside the volume and past Cin and Cout. Whole rows of 8 go by
  // cp.async (a zero fill where there is no data); ragged channel counts
  // take the plain loads.
  auto stage = [&](int tile, int buf) {
    __nv_bfloat16* xb = smem + buf * MMA_BUF;
    __nv_bfloat16* gb = xb + HALO * MMA_XS;
    int r = tile;
    const int d0 = (r % tiles_d) * TD;
    r /= tiles_d;
    const int h0 = (r % tiles_h) * TH;
    r /= tiles_h;
    const int w0 = (r % tiles_w) * TW;
    const int n = r / tiles_w;
    for (int i = tid; i < HALO * 2; i += MMA_THREADS) {
      const int c = (i & 1) * 8;
      const int v = i >> 1;
      const int gd = d0 + v % HD - 1;
      const int gh = h0 + (v / HD) % HH - 1;
      const int gw = w0 + v / (HD * HH) - 1;
      const bool in = c < ncin && gw >= 0 && gw < W && gh >= 0 && gh < H && gd >= 0 && gd < D;
      const __nv_bfloat16* src =
          in ? x + ((((size_t)n * W + gw) * H + gh) * D + gd) * Cin + c0 + c : x;
      __nv_bfloat16* dst = xb + v * MMA_XS + c;
      if (x_vec)
        cp_async16((uint32_t)__cvta_generic_to_shared(dst), src, in ? 16 : 0);
      else
        *reinterpret_cast<uint4*>(dst) = in ? load8(src, ncin - c) : make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < TILE * NT; i += MMA_THREADS) {
      const int c = (i % NT) * 8;
      const int v = i / NT;
      const int od = d0 + v % TD;
      const int oh = h0 + (v / TD) % TH;
      const int ow = w0 + v / (TD * TH);
      const bool in = c < ncout && ow < W && oh < H && od < D;
      const __nv_bfloat16* src =
          in ? g + ((((size_t)n * W + ow) * H + oh) * D + od) * Cout + co0 + c : g;
      __nv_bfloat16* dst = gb + v * gstride + c;
      if (g_vec)
        cp_async16((uint32_t)__cvta_generic_to_shared(dst), src, in ? 16 : 0);
      else
        *reinterpret_cast<uint4*>(dst) = in ? load8(src, ncout - c) : make_uint4(0, 0, 0, 0);
    }
  };

  // Tile t + 1 is staged into the other buffer while tile t is multiplied.
  const int t_begin = (int)((long long)n_tiles * s / splits);
  const int t_end = (int)((long long)n_tiles * (s + 1) / splits);
  if (t_begin < t_end) stage(t_begin, 0);
  cp_async_commit();
  int buf = 0;
  for (int tile = t_begin; tile < t_end; ++tile, buf ^= 1) {
    if (tile + 1 < t_end) stage(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_latest();
    __syncthreads();
    const uint32_t xs_addr = (uint32_t)__cvta_generic_to_shared(smem + buf * MMA_BUF);
    const uint32_t gs_addr = xs_addr + 2 * HALO * MMA_XS;

    // K steps of 16 voxels: D-runs 2k and 2k + 1, run r at (vw, vh) =
    // (r / TH, r % TH), voxel (r * TD + d) of the tile.
#pragma unroll 1
    for (int k = 0; k < TILE / 16; ++k) {
      uint32_t b[NT][2];
      const int gv = (2 * k + b_run) * TD + mrow;
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        if (t + 1 < NT)
          ldmatrix_x4_trans(gs_addr + 2 * (gv * gstride + (t + b_tile) * 8), b[t][0], b[t][1],
                            b[t + 1][0], b[t + 1][1]);
        else
          ldmatrix_x2_trans(gs_addr + 2 * (gv * gstride + t * 8), b[t][0], b[t][1]);
      }
      const int run = 2 * k + a_run;
      const int xv = ((run / TH) * HH + run % TH) * HD + mrow;
#pragma unroll
      for (int mt = 0; mt < MMA_MT; ++mt) {
        if (warp + MMA_WARPS * mt >= n_m16) continue;
        uint32_t a[4];
        ldmatrix_x4_trans(xs_addr + 2 * (a_off[mt] + xv * MMA_XS), a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int t = 0; t < NT; ++t) mma_bf16_16816(acc[mt][t], a, b[t][0], b[t][1]);
      }
    }
    __syncthreads();
  }

  // Accumulator e of n8 tile t: row (e / 2) * 8 + lane / 4 of the m16 tile,
  // column t * 8 + 2 * (lane % 4) + e % 2.
  float* row = work + (size_t)s * TAPS * Cin * Cout;
#pragma unroll
  for (int mt = 0; mt < MMA_MT; ++mt) {
    const int j = warp + MMA_WARPS * mt;
    if (j >= n_m16) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * j + h;
      const int ci = (q % ng) * 8 + (lane >> 2);
      if (q >= n_groups || ci >= ncin) continue;
      float* out = row + ((size_t)(q / ng) * Cin + c0 + ci) * Cout + co0;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = t * 8 + 2 * (lane & 3) + e;
          if (co < ncout) out[co] = acc[mt][t][2 * h + e];
        }
    }
  }
}

// grid: (ceil(Cin / TF_CIK), splits, ceil(Cout / COUT_BLOCK)); each block
// takes NT n8 tiles of Cout (the last block's may run past Cout);
// blockDim.x = TF_THREADS. work[s][tap][ci][co] receives split s's sums.
// x_vec / g_vec: Cin / Cout is a multiple of 4 and the tensor 16-byte
// aligned, so groups of 4 channels are staged by cp.async (x) or one 16-byte
// load (g).
template <int NT>
__global__ void __launch_bounds__(TF_THREADS, TF_MIN_BLOCKS)
dw_partial_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         float* __restrict__ work, int W, int H, int D, int Cin, int Cout,
                         int tiles_w, int tiles_h, int tiles_d, int n_tiles, int splits,
                         int x_vec, int g_vec) {
  constexpr int GS = (NT | 1) * 8;  // g row stride in floats: 8 or 24 banks mod 32
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  float* xs = reinterpret_cast<float*>(smem_bytes);  // [HALO][TF_XS]
  uint32_t* gs = reinterpret_cast<uint32_t*>(xs + HALO * TF_XS);  // [2][TILE][GS]: hi, lo

  const int c0 = blockIdx.x * TF_CIK;
  const int s = blockIdx.y;
  const int co0 = blockIdx.z * NT * 8;
  const int ncin = min(TF_CIK, Cin - c0);
  const int ncout = min(NT * 8, Cout - co0);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // A (16 rows (tap, ci) x 8 voxels) of m16 tile j = warp + TF_WARPS * mt:
  // rows 0-7 are the channels of tap 2j, rows 8-15 those of tap 2j + 1 (tap
  // 27, the padded half of tile 13, reads tap 0 and is never stored). A
  // lane's loads are voxels t and t + 4 of the D-run at channel g; the tap
  // adds its offset in the halo.
  int a_off[TF_MT][2];
#pragma unroll
  for (int mt = 0; mt < TF_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int tap = 2 * (warp + TF_WARPS * mt) + h;
      if (tap >= TAPS) tap = 0;
      a_off[mt][h] = (((tap / 9) * HH + (tap / 3) % 3) * HD + tap % 3) * TF_XS;
    }
  const float* xa = xs + (lane & 3) * TF_XS + (lane >> 2);
  // B (8 voxels x 8 Cout, column-major): b0 = (voxel t, Cout g), b1 =
  // (t + 4, g) of each n8 tile, hi and lo.
  const uint32_t* gb = gs + (lane & 3) * GS + (lane >> 2);

  float acc[TF_MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < TF_MT; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;

  const int t_begin = (int)((long long)n_tiles * s / splits);
  const int t_end = (int)((long long)n_tiles * (s + 1) / splits);
  for (int tile = t_begin; tile < t_end; ++tile) {
    int r = tile;
    const int d0 = (r % tiles_d) * TD;
    r /= tiles_d;
    const int h0 = (r % tiles_h) * TH;
    r /= tiles_h;
    const int w0 = (r % tiles_w) * TW;
    const int n = r / tiles_w;
    // x halo for channels c0..c0+8, 4 at a time, zero outside the volume and
    // past Cin.
    for (int i = tid; i < HALO * 2; i += TF_THREADS) {
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
    // g tile for this block's outputs, 4 at a time, zero outside the volume
    // and past Cout, split into hi and lo once here rather than by every
    // warp at every K step.
    for (int i = tid; i < TILE * NT * 2; i += TF_THREADS) {
      const int c = (i % (NT * 2)) * 4;
      const int v = i / (NT * 2);
      const int od = d0 + v % TD;
      const int oh = h0 + (v / TD) % TH;
      const int ow = w0 + v / (TD * TH);
      const bool in = c < ncout && ow < W && oh < H && od < D;
      const float* src = in ? g + ((((size_t)n * W + ow) * H + oh) * D + od) * Cout + co0 + c : g;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g_vec) {
        if (in) val = *reinterpret_cast<const float4*>(src);
      } else {
        val = load4(src, in ? ncout - c : 0);
      }
      uint4 hi, lo;
      split_tf32(val.x, hi.x, lo.x);
      split_tf32(val.y, hi.y, lo.y);
      split_tf32(val.z, hi.z, lo.z);
      split_tf32(val.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(gs + v * GS + c) = hi;
      *reinterpret_cast<uint4*>(gs + (TILE + v) * GS + c) = lo;
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // K steps of one D-run of 8 voxels, run r at (vw, vh) = (r / TH, r % TH):
    // halo voxel ((vw * HH + vh) * HD + d), tile voxel (r * TD + d). Rolled,
    // as the forward's f32 tap loop, to keep one step's fragments live.
#pragma unroll 1
    for (int run = 0; run < TILE / TD; ++run) {
      const float* xr = xa + ((run / TH) * HH + run % TH) * HD * TF_XS;
      uint32_t a_hi[TF_MT][4], a_lo[TF_MT][4];
#pragma unroll
      for (int mt = 0; mt < TF_MT; ++mt) {
        const float a[4] = {xr[a_off[mt][0]], xr[a_off[mt][1]], xr[4 * TF_XS + a_off[mt][0]],
                            xr[4 * TF_XS + a_off[mt][1]]};
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], a_hi[mt][e], a_lo[mt][e]);
      }
      const uint32_t* gr = gb + run * TD * GS;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint32_t b_hi[2] = {gr[t * 8], gr[t * 8 + 4 * GS]};
        const uint32_t b_lo[2] = {gr[TILE * GS + t * 8], gr[TILE * GS + t * 8 + 4 * GS]};
#pragma unroll
        for (int mt = 0; mt < TF_MT; ++mt) {
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
  // that is channel lane / 4 of tap 2j + e / 2, and column t * 8 +
  // 2 * (lane % 4) + e % 2.
  float* row = work + (size_t)s * TAPS * Cin * Cout;
  const int ci = lane >> 2;
  if (ci >= ncin) return;
#pragma unroll
  for (int mt = 0; mt < TF_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tap = 2 * (warp + TF_WARPS * mt) + h;
      if (tap >= TAPS) continue;
      float* out = row + ((size_t)tap * Cin + c0 + ci) * Cout + co0;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = t * 8 + 2 * (lane & 3) + e;
          if (co < ncout) out[co] = acc[mt][t][2 * h + e];
        }
    }
}

// out[k] = sum over s in order of work[s][k], k < 27 * Cin * Cout.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
dw_reduce_kernel(const float* __restrict__ work, T* __restrict__ out, int K, int splits) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += work[(size_t)s * K + k];
  out[k] = from_float<T>(sum);
}

// Above 48 KB a block's shared memory must be allowed per kernel and
// device: once per kernel (one `allowed` for each) and device, not on every
// launch.
cudaError_t allow_smem(const void* kernel, int bytes, std::atomic<uint64_t>& allowed) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (device & 63);
  if (allowed.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed |= bit;
  return err;
}

template <int NT>
cudaError_t launch_partials(const float* x, const float* g, float* work, int W, int H, int D,
                            int Cin, int Cout, int splits, const Geometry& geo,
                            cudaStream_t st) {
  static std::atomic<uint64_t> allowed{0};
  constexpr int smem = tf_smem(NT);
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(dw_partial_tf32x3_kernel<NT>), smem, allowed);
  if (err != cudaSuccess) return err;
  const int x_vec = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int g_vec = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const dim3 grid((Cin + TF_CIK - 1) / TF_CIK, splits, Geometry::chunks_out(Cout));
  dw_partial_tf32x3_kernel<NT><<<grid, TF_THREADS, smem, st>>>(
      x, g, work, W, H, D, Cin, Cout, geo.tiles_w, geo.tiles_h, geo.tiles_d, geo.n_tiles,
      splits, x_vec, g_vec);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_partials(const __nv_bfloat16* x, const __nv_bfloat16* g, float* work, int W,
                            int H, int D, int Cin, int Cout, int splits, const Geometry& geo,
                            cudaStream_t st) {
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(dw_partial_mma_kernel<NT>),
                                     (int)MMA_SMEM, allowed);
  if (err != cudaSuccess) return err;
  const int x_vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int g_vec = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const dim3 grid((Cin + MMA_CIK - 1) / MMA_CIK, splits, Geometry::chunks_out(Cout));
  dw_partial_mma_kernel<NT><<<grid, MMA_THREADS, MMA_SMEM, st>>>(
      x, g, work, W, H, D, Cin, Cout, geo.tiles_w, geo.tiles_h, geo.tiles_d, geo.n_tiles,
      splits, x_vec, g_vec);
  return cudaGetLastError();
}

// Cout's n8 tiles shared out evenly over the fewest chunks of at most
// COUT_BLOCK channels: launch(NT) with NT the n8 tiles per chunk (5 for
// Cout 40, 1 for Cout 2).
template <typename Launch>
cudaError_t by_cout_chunks(int Cout, Launch&& launch) {
  const int chunks = Geometry::chunks_out(Cout);
  switch (((Cout + 7) / 8 + chunks - 1) / chunks) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, 2>{});
    case 3: return launch(std::integral_constant<int, 3>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    default: return launch(std::integral_constant<int, 5>{});
  }
}

template <typename T> int splits_for(const Geometry& geo, int Cin, int Cout);
template <> int splits_for<float>(const Geometry& geo, int Cin, int Cout) {
  return geo.splits(Cin, Cout, TF_CIK, TF_TARGET_BLOCKS);
}
template <> int splits_for<__nv_bfloat16>(const Geometry& geo, int Cin, int Cout) {
  return geo.splits(Cin, Cout, MMA_CIK, MMA_TARGET_BLOCKS);
}

template <typename T>
int launch(const void* x, const void* g, void* work, void* out, int N, int W, int H, int D,
           int Cin, int Cout, int splits, void* stream) {
  const Geometry geo(N, W, H, D);
  if (splits != splits_for<T>(geo, Cin, Cout)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = by_cout_chunks(Cout, [&](auto nt) {
    return launch_partials<decltype(nt)::value>((const T*)x, (const T*)g, (float*)work, W, H,
                                                D, Cin, Cout, splits, geo, st);
  });
  if (err != cudaSuccess) return (int)err;
  const int K = TAPS * Cin * Cout;
  dw_reduce_kernel<T><<<(K + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, st>>>(
      (const float*)work, (T*)out, K, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of splits (workspace rows of 27 * Cin * Cout floats) that the
// launch for this shape and type takes.
extern "C" int conv3x3_s1p1_dw_splits_f32(int N, int W, int H, int D, int Cin, int Cout) {
  return splits_for<float>(Geometry(N, W, H, D), Cin, Cout);
}

extern "C" int conv3x3_s1p1_dw_splits_bf16(int N, int W, int H, int D, int Cin, int Cout) {
  return splits_for<__nv_bfloat16>(Geometry(N, W, H, D), Cin, Cout);
}

extern "C" int conv3x3_s1p1_dw_f32(const void* x, const void* g, void* work, void* out, int N,
                                   int W, int H, int D, int Cin, int Cout, int splits,
                                   void* stream) {
  return launch<float>(x, g, work, out, N, W, H, D, Cin, Cout, splits, stream);
}

extern "C" int conv3x3_s1p1_dw_bf16(const void* x, const void* g, void* work, void* out,
                                    int N, int W, int H, int D, int Cin, int Cout, int splits,
                                    void* stream) {
  return launch<__nv_bfloat16>(x, g, work, out, N, W, H, D, Cin, Cout, splits, stream);
}
