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
// What this design does about it: it is the simple, correct first version and
// runs every type on the CUDA cores in f32 FMAs (no wgmma, no TMA; a later
// change can move bf16 onto the tensor cores). Each block owns a 4x8x8 tile of
// output voxels and up to 64 output channels. It walks Cin in chunks of 8: for
// each chunk it stages the zero-masked 6x10x10 input halo and the chunk's
// 27 x 8 x Cout weights in shared memory (the TPU kernel keeps all
// 27*Cin*Cout weights resident, 518 KB at 120->40 in f32, which no block can
// hold). Each thread then keeps 4 voxels x 8 output channels in registers,
// so every weight read from shared memory feeds 4 FMAs and every input read
// feeds 8. The halo is masked at load; no padded copy is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

}  // namespace

extern "C" int conv3x3_s1p1_f32(const void* x, const void* k, void* out, int N, int W, int H,
                                int D, int Cin, int Cout, void* stream) {
  return launch<float>(x, k, out, N, W, H, D, Cin, Cout, stream);
}

extern "C" int conv3x3_s1p1_bf16(const void* x, const void* k, void* out, int N, int W, int H,
                                 int D, int Cin, int Cout, void* stream) {
  return launch<__nv_bfloat16>(x, k, out, N, W, H, D, Cin, Cout, stream);
}
