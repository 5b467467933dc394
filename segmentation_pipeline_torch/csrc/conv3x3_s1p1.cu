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
// all contiguous and of one type T (float or bfloat16). Sums are kept in f32;
// the output has the input's type.
//
// What bounds it on an H100: 2*N*W*H*D*27*Cin*Cout operations against
// (N*W*H*D*(Cin+Cout) + 27*Cin*Cout) * sizeof(T) bytes. At the NestedResUNet
// widths (Cin 3..120, Cout 2..40) that is 100-1000 operations per byte, so the
// arithmetic, not the memory, is the limit: 67 TFLOP/s in f32 on the CUDA
// cores, 989 TFLOP/s in bf16 on the tensor cores.
//
// What the design does about it. Both types give each block a 4x8x8 tile of
// output voxels (grid.x) and a chunk of output channels (grid.y), and walk
// Cin in chunks: for each chunk they stage the zero-masked 6x10x10 input halo
// and the chunk's weights in shared memory (the TPU kernel keeps all
// 27*Cin*Cout weights resident, 518 KB at 120->40 in f32, which no block can
// hold). The halo is masked at load; no padded copy is made.
//
// f32 (conv3x3_s1p1_kernel): on the CUDA cores in f32 FMAs, bounded by
// their FMA rate. Up to 64 output channels per block, Cin in chunks of 8,
// staged as floats. Each thread keeps 4 voxels x 8 output channels in
// registers, so every weight read from shared memory feeds 4 FMAs and every
// input read feeds 8.
//
// bf16 (conv3x3_s1p1_mma_kernel): on the tensor cores with warp-level
// mma.sync m16n8k16 (bf16 x bf16, f32 sums, the output rounded once to
// bf16). Per block the work is a GEMM: M = the tile's 256 voxels, 16 m16
// tiles of two D-runs of 8; K = 27 taps x Cin, in steps of 16 channels of one
// tap; N = the block's Cout chunk, NT n8 tiles (a template parameter, 1-5),
// Cout's n8 tiles shared out evenly over the chunks (5 for Cout 40, 5+5 for
// 80, 5+5+5 for 120, one padded tile for Cout 2), so no block computes a
// padded 64-channel block. Staging keeps bf16: the halo as [600][24] (48-byte
// rows) and the weights as [27][16][(NT|1)*8] (rows an odd number of 16
// bytes), so ldmatrix reads are free of bank conflicts; 63 KB at NT 5, one
// buffer, so three blocks are resident per SM (80 registers a thread) and
// one computes while another stages. Whole rows of 8 channels go by cp.async
// with zero fill; ragged channel counts (Cin 3, Cin 2) take plain loads. A
// fragments (16 voxels x 16 channels) come from ldmatrix.x4, each lane
// giving its own voxel's halo row shifted by the tap, so a tap is only
// another address; B fragments (16 channels x 8 Cout) from
// ldmatrix.x4.trans. Eight warps take two m16 tiles each across all NT n8
// tiles and share a tap's B fragments between them: 40 f32 sums a thread at
// NT 5.
//
// The PTX helpers (ldmatrix, mma, cp.async, load8) are copies of those in
// conv3x3_s1p1_dw.cu: each source is built and hashed on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int TW = 4, TH = 8, TD = 8;                // output tile (W, H, D)
constexpr int HW = TW + 2, HH = TH + 2, HD = TD + 2;  // input halo tile
constexpr int HALO = HW * HH * HD;
constexpr int TILE = TW * TH * TD;
constexpr int VPT = 4;               // output voxels per thread
constexpr int VT = TILE / VPT;       // threads per output-channel group
constexpr int CG = 8;                // output channels per thread
constexpr int CK = 8;                // input channels staged per step
constexpr int COUT_BLOCK = 64;       // output channels per block (grid.y)
constexpr int TAPS = 27;
constexpr int MAX_THREADS = VT * (COUT_BLOCK / CG);
constexpr int MAX_SMEM = (CK * HALO + CK * TAPS * COUT_BLOCK) * 4;

// The bf16 tensor-core kernel.
constexpr int MMA_CIK = 16;          // input channels per K chunk: two groups of 8
constexpr int MMA_XS = 24;           // halo row stride in elements: 48 bytes
constexpr int MMA_COUT_BLOCK = 40;   // at most this many output channels per block (grid.y)
constexpr int MMA_WARPS = 8;
constexpr int MMA_MT = 2;            // m16 tiles per warp: 8 * 2 * 16 = TILE voxels
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_MIN_BLOCKS = 3;    // resident blocks per SM the registers must allow

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }

// grid.x: n * tiles_w * tiles_h * tiles_d; grid.y: ceil(Cout / COUT_BLOCK).
// blockDim.x = VT * cout_pad / CG, cout_pad = min(Cout, 64) rounded up to 8.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
conv3x3_s1p1_kernel(const T* __restrict__ x, const T* __restrict__ k, T* __restrict__ out,
                    int W, int H, int D, int Cin, int Cout,
                    int tiles_w, int tiles_h, int tiles_d, int cout_pad) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [CK][HALO]
  float* ks = smem + CK * HALO;     // [CK][TAPS][cout_pad]

  int t = blockIdx.x;
  const int d0 = (t % tiles_d) * TD;
  t /= tiles_d;
  const int h0 = (t % tiles_h) * TH;
  t /= tiles_h;
  const int w0 = (t % tiles_w) * TW;
  const int n = t / tiles_w;
  const int co0 = blockIdx.y * COUT_BLOCK;
  const int ncout = min(COUT_BLOCK, Cout - co0);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int g = tid / VT;   // this thread's output-channel group
  const int vt = tid % VT;  // voxels vt, vt + VT, ... of the tile

  int base[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int p = vt + j * VT;
    base[j] = ((p / (TD * TH)) * HH + (p / TD) % TH) * HD + p % TD;
  }

  float acc[VPT][CG];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[j][c] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    // Input halo for channels c0..c0+CK, zero outside the volume and past Cin.
    for (int i = tid; i < CK * HALO; i += nthreads) {
      const int ci = i % CK;
      const int v = i / CK;
      const int gd = d0 + v % HD - 1;
      const int gh = h0 + (v / HD) % HH - 1;
      const int gw = w0 + v / (HD * HH) - 1;
      const int gc = c0 + ci;
      float val = 0.f;
      if (gc < Cin && gw >= 0 && gw < W && gh >= 0 && gh < H && gd >= 0 && gd < D)
        val = to_float(x[((((size_t)n * W + gw) * H + gh) * D + gd) * Cin + gc]);
      xs[ci * HALO + v] = val;
    }
    // Weights for the same channels and this block's outputs, zero past Cout.
    for (int i = tid; i < CK * TAPS * cout_pad; i += nthreads) {
      const int co = i % cout_pad;
      const int tap = (i / cout_pad) % TAPS;
      const int gc = c0 + i / (cout_pad * TAPS);
      float val = 0.f;
      if (gc < Cin && co < ncout) val = to_float(k[((size_t)tap * Cin + gc) * Cout + co0 + co]);
      ks[i] = val;
    }
    __syncthreads();

    const int cn = min(CK, Cin - c0);
    for (int ci = 0; ci < cn; ++ci) {
      const float* xc = xs + ci * HALO;
      const float* kc = ks + ci * TAPS * cout_pad + g * CG;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw)
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int dd = 0; dd < 3; ++dd) {
            const int tap = (dw * 3 + dh) * 3 + dd;
            const int off = (dw * HH + dh) * HD + dd;
            const float4 ka = *reinterpret_cast<const float4*>(kc + tap * cout_pad);
            const float4 kb = *reinterpret_cast<const float4*>(kc + tap * cout_pad + 4);
            const float kv[CG] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
            for (int j = 0; j < VPT; ++j) {
              const float xv = xc[base[j] + off];
#pragma unroll
              for (int c = 0; c < CG; ++c) acc[j][c] = fmaf(xv, kv[c], acc[j][c]);
            }
          }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int p = vt + j * VT;
    const int od = d0 + p % TD;
    const int oh = h0 + (p / TD) % TH;
    const int ow = w0 + p / (TD * TH);
    if (ow >= W || oh >= H || od >= D) continue;
    T* o = out + ((((size_t)n * W + ow) * H + oh) * D + od) * Cout + co0 + g * CG;
#pragma unroll
    for (int c = 0; c < CG; ++c)
      if (g * CG + c < ncout) o[c] = from_float<T>(acc[j][c]);
  }
}


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

template <typename T>
int launch(const void* x, const void* k, void* out, int N, int W, int H, int D, int Cin,
           int Cout, void* stream) {
  // Above 48 KB a block's shared memory must be allowed per function and device.
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_s1p1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_d = (D + TD - 1) / TD;
  const int cout_pad = (std::min(Cout, COUT_BLOCK) + CG - 1) / CG * CG;
  const dim3 grid(N * tiles_w * tiles_h * tiles_d, (Cout + COUT_BLOCK - 1) / COUT_BLOCK);
  const dim3 block(VT * cout_pad / CG);
  const size_t smem = (size_t)(CK * HALO + CK * TAPS * cout_pad) * sizeof(float);
  conv3x3_s1p1_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)k, (T*)out, W, H, D, Cin, Cout, tiles_w, tiles_h, tiles_d,
      cout_pad);
  return (int)cudaGetLastError();
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

// bf16: the tensor-core kernel, with Cout's n8 tiles shared out evenly over
// the Cout chunks.
int launch_bf16(const void* x, const void* k, void* out, int N, int W, int H, int D, int Cin,
                int Cout, void* stream) {
  const int chunks = (Cout + MMA_COUT_BLOCK - 1) / MMA_COUT_BLOCK;
  switch (((Cout + 7) / 8 + chunks - 1) / chunks) {
    case 1: return launch_mma<1>(x, k, out, N, W, H, D, Cin, Cout, chunks, stream);
    case 2: return launch_mma<2>(x, k, out, N, W, H, D, Cin, Cout, chunks, stream);
    case 3: return launch_mma<3>(x, k, out, N, W, H, D, Cin, Cout, chunks, stream);
    case 4: return launch_mma<4>(x, k, out, N, W, H, D, Cin, Cout, chunks, stream);
    default: return launch_mma<5>(x, k, out, N, W, H, D, Cin, Cout, chunks, stream);
  }
}

}  // namespace

extern "C" int conv3x3_s1p1_f32(const void* x, const void* k, void* out, int N, int W, int H,
                                int D, int Cin, int Cout, void* stream) {
  return launch<float>(x, k, out, N, W, H, D, Cin, Cout, stream);
}

extern "C" int conv3x3_s1p1_bf16(const void* x, const void* k, void* out, int N, int W, int H,
                                 int D, int Cin, int Cout, void* stream) {
  return launch_bf16(x, k, out, N, W, H, D, Cin, Cout, stream);
}
