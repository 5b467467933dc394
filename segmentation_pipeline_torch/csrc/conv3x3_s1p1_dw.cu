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
// so the arithmetic is the limit (67 TFLOP/s f32 on the CUDA cores). Unlike
// the forward, the reduction runs over the M = N*W*H*D voxels (811,008 at
// the dmri_hippo training batch) into a small output (27*Cin*Cout, at most
// 129,600 values at 120->40): a split-K problem.
//
// What this design does about it: the simple, correct first version, on the
// CUDA cores in f32 FMAs for both types (no wgmma, no TMA). The voxels are
// cut into 4x8x8 tiles, as the forward's. Grid.x splits the tiles into
// `splits` contiguous runs; grid.y takes Cin in chunks of 4 or 8, grid.z Cout
// in chunks of up to 64, so no block holds all 27*Cin*Cout sums. A block
// walks its run of tiles: it stages the zero-masked 6x10x10 x halo of its
// Cin chunk and the g tile of its Cout chunk in shared memory, then each
// thread adds, for one tap, a 4 (Cin) x 8 (Cout) block of products over the
// tile's 256 voxels, kept in registers (32 FMAs per three 16-byte
// shared-memory reads). Each block writes its sums to an f32 workspace row
// of its split; a second launch adds the rows in split order. No atomics:
// the result is the same bit for bit from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int TW = 4, TH = 8, TD = 8;                // voxel tile (W, H, D)
constexpr int HW = TW + 2, HH = TH + 2, HD = TD + 2;  // x halo tile
constexpr int HALO = HW * HH * HD;
constexpr int TILE = TW * TH * TD;
constexpr int TAPS = 27;
constexpr int CI_T = 4;              // input channels per thread
constexpr int CO_T = 8;              // output channels per thread
constexpr int COUT_BLOCK = 64;       // output channels per block (grid.z)
constexpr int MAX_THREADS = TAPS * (8 / CI_T) * (COUT_BLOCK / CO_T);
constexpr int TARGET_BLOCKS = 4 * 132;  // four blocks for each of the H100's SMs
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Geometry {
  int tiles_w, tiles_h, tiles_d, n_tiles, cik, cout_pad;
  Geometry(int N, int W, int H, int D, int Cin, int Cout)
      : tiles_w((W + TW - 1) / TW), tiles_h((H + TH - 1) / TH), tiles_d((D + TD - 1) / TD),
        n_tiles(N * tiles_w * tiles_h * tiles_d), cik(Cin <= 4 ? 4 : 8),
        cout_pad((std::min(Cout, COUT_BLOCK) + CO_T - 1) / CO_T * CO_T) {}
  int chunks_in(int Cin) const { return (Cin + cik - 1) / cik; }
  static int chunks_out(int Cout) { return (Cout + COUT_BLOCK - 1) / COUT_BLOCK; }
  int splits(int Cin, int Cout) const {
    const int per_split = chunks_in(Cin) * chunks_out(Cout);
    return std::max(1, std::min(n_tiles, (TARGET_BLOCKS + per_split - 1) / per_split));
  }
};

// grid: (splits, ceil(Cin / CIK), ceil(Cout / COUT_BLOCK));
// blockDim.x = TAPS * (CIK / CI_T) * (cout_pad / CO_T).
// work[s][tap][ci][co] receives split s's sums.
template <typename T, int CIK>
__global__ void __launch_bounds__(MAX_THREADS)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ work,
                  int W, int H, int D, int Cin, int Cout, int tiles_w, int tiles_h,
                  int tiles_d, int n_tiles, int splits, int cout_pad) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // [HALO][CIK]
  float* gs = smem + HALO * CIK;   // [TILE][cout_pad]

  const int s = blockIdx.x;
  const int c0 = blockIdx.y * CIK;
  const int co0 = blockIdx.z * COUT_BLOCK;
  const int ncin = min(CIK, Cin - c0);
  const int ncout = min(cout_pad, Cout - co0);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int ncog = cout_pad / CO_T;
  const int cog = tid % ncog;               // this thread's Cout group
  const int cig = (tid / ncog) % (CIK / CI_T);  // its Cin group
  const int tap = tid / (ncog * (CIK / CI_T));
  const int off = ((tap / 9) * HH + (tap / 3) % 3) * HD + tap % 3;

  float acc[CI_T][CO_T];
#pragma unroll
  for (int i = 0; i < CI_T; ++i)
#pragma unroll
    for (int j = 0; j < CO_T; ++j) acc[i][j] = 0.f;

  const int t_begin = (int)((long long)n_tiles * s / splits);
  const int t_end = (int)((long long)n_tiles * (s + 1) / splits);
  for (int t = t_begin; t < t_end; ++t) {
    int r = t;
    const int d0 = (r % tiles_d) * TD;
    r /= tiles_d;
    const int h0 = (r % tiles_h) * TH;
    r /= tiles_h;
    const int w0 = (r % tiles_w) * TW;
    const int n = r / tiles_w;

    // x halo for channels c0..c0+CIK, zero outside the volume and past Cin.
    for (int i = tid; i < HALO * CIK; i += nthreads) {
      const int ci = i % CIK;
      const int v = i / CIK;
      const int gd = d0 + v % HD - 1;
      const int gh = h0 + (v / HD) % HH - 1;
      const int gw = w0 + v / (HD * HH) - 1;
      float val = 0.f;
      if (ci < ncin && gw >= 0 && gw < W && gh >= 0 && gh < H && gd >= 0 && gd < D)
        val = to_float(x[((((size_t)n * W + gw) * H + gh) * D + gd) * Cin + c0 + ci]);
      xs[i] = val;
    }
    // g tile for this block's outputs, zero outside the volume and past Cout.
    for (int i = tid; i < TILE * cout_pad; i += nthreads) {
      const int co = i % cout_pad;
      const int v = i / cout_pad;
      const int od = d0 + v % TD;
      const int oh = h0 + (v / TD) % TH;
      const int ow = w0 + v / (TD * TH);
      float val = 0.f;
      if (co < ncout && ow < W && oh < H && od < D)
        val = to_float(g[((((size_t)n * W + ow) * H + oh) * D + od) * Cout + co0 + co]);
      gs[i] = val;
    }
    __syncthreads();

    const float* xp = xs + off * CIK + cig * CI_T;
    const float* gp = gs + cog * CO_T;
    for (int vw = 0; vw < TW; ++vw)
      for (int vh = 0; vh < TH; ++vh) {
        const float* xr = xp + (vw * HH + vh) * HD * CIK;
        const float* gr = gp + (vw * TH + vh) * TD * cout_pad;
#pragma unroll
        for (int vd = 0; vd < TD; ++vd) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + vd * CIK);
          const float4 ga = *reinterpret_cast<const float4*>(gr + vd * cout_pad);
          const float4 gb = *reinterpret_cast<const float4*>(gr + vd * cout_pad + 4);
          const float xa[CI_T] = {xv.x, xv.y, xv.z, xv.w};
          const float gv[CO_T] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
          for (int i = 0; i < CI_T; ++i)
#pragma unroll
            for (int j = 0; j < CO_T; ++j) acc[i][j] = fmaf(xa[i], gv[j], acc[i][j]);
        }
      }
    __syncthreads();
  }

  float* row = work + (size_t)s * TAPS * Cin * Cout;
#pragma unroll
  for (int i = 0; i < CI_T; ++i) {
    const int ci = cig * CI_T + i;
    if (ci >= ncin) continue;
#pragma unroll
    for (int j = 0; j < CO_T; ++j) {
      const int co = cog * CO_T + j;
      if (co < ncout) row[((size_t)tap * Cin + c0 + ci) * Cout + co0 + co] = acc[i][j];
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

template <typename T, int CIK>
cudaError_t launch_partial(const T* x, const T* g, float* work, int N, int W, int H, int D,
                           int Cin, int Cout, int splits, const Geometry& geo,
                           cudaStream_t stream) {
  const size_t smem = (size_t)(HALO * CIK + TILE * geo.cout_pad) * sizeof(float);
  // Above 48 KB a block's shared memory must be allowed per function and device.
  const cudaError_t err = cudaFuncSetAttribute(
      dw_partial_kernel<T, CIK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, geo.chunks_in(Cin), Geometry::chunks_out(Cout));
  const dim3 block(TAPS * (CIK / CI_T) * (geo.cout_pad / CO_T));
  dw_partial_kernel<T, CIK><<<grid, block, smem, stream>>>(
      x, g, work, W, H, D, Cin, Cout, geo.tiles_w, geo.tiles_h, geo.tiles_d, geo.n_tiles,
      splits, geo.cout_pad);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* g, void* work, void* out, int N, int W, int H, int D,
           int Cin, int Cout, int splits, void* stream) {
  const Geometry geo(N, W, H, D, Cin, Cout);
  if (splits != geo.splits(Cin, Cout)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      geo.cik == 4
          ? launch_partial<T, 4>((const T*)x, (const T*)g, (float*)work, N, W, H, D, Cin,
                                 Cout, splits, geo, st)
          : launch_partial<T, 8>((const T*)x, (const T*)g, (float*)work, N, W, H, D, Cin,
                                 Cout, splits, geo, st);
  if (err != cudaSuccess) return (int)err;
  const int K = TAPS * Cin * Cout;
  dw_reduce_kernel<T><<<(K + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, st>>>(
      (const float*)work, (T*)out, K, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of splits (workspace rows of 27 * Cin * Cout floats) that the
// launch for this shape takes.
extern "C" int conv3x3_s1p1_dw_splits(int N, int W, int H, int D, int Cin, int Cout) {
  return Geometry(N, W, H, D, Cin, Cout).splits(Cin, Cout);
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
