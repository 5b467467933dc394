// Trilinear 2x upsampling with align_corners=True, channels-last, and its
// input gradient.
//
// Replaces no Pallas kernel: the JAX package leaves the upsample
// (segmentation_pipeline_tpu/ops/convolution.py::upsample_trilinear2x) to
// XLA. It was added because the library path on the card (permute to NCDHW,
// F.interpolate, permute back) ran ATen's generic upsample_trilinear3d
// frame kernel, which spreads threads over output voxels and loops each
// over N*C channel-strided values: in the NestedResUNet's TTA serving at
// N=32 in bf16 it took 16.3 ms a request against a memory bound of 0.57 ms.
//
// Computed as PyTorch computes it (ATen's UpSampleTrilinear3d.cu), per axis
// of input size `in` and output size 2*in:
//
//   scale = float(in - 1) / float(2*in - 1)
//   src = scale * o, lo = (int)src, hi = lo + (lo < in - 1), lam = src - lo
//
//   out[n,ow,oh,od,c] = (1-lw) * ((1-lh) * ((1-ld) x[w0,h0,d0] + ld x[w0,h0,d1])
//                               +    lh  * ((1-ld) x[w0,h1,d0] + ld x[w0,h1,d1]))
//                     +    lw  * ((1-lh) * (...w1,h0...) + lh * (...w1,h1...))
//
// in f32, rounded once to the output type. An axis of size 1 repeats its
// value (scale 0, lo = hi = 0). x is (N, W, H, D, C) and out
// (N, 2W, 2H, 2D, C), both contiguous, float or bfloat16.
//
// The input gradient is the adjoint: dx[i] = sum over the outputs o that
// read i of weight(o, i) * g[o], with weight the product of the per-axis
// weights of the forward (1 - lam where lo == i, lam where hi == i, both
// where lo == hi == i), from the same lo, hi and lam. On an axis the
// outputs that read input i form a contiguous run inside [2i-2, 2i+3]
// (scale < 1/2, so src(o) lies in [o/2 - 1/2, o/2]); at most 5 of the 6.
//
// What bounds it on an H100: memory. The forward reads the input once and
// writes 8 times as much, with no arithmetic to speak of: bytes =
// 9 * N*W*H*D*C * sizeof(T) against 3.35 TB/s. At the TTA's N=32 bf16
// forward (40 channels; 3 upsamples to 48x88x24, 2 to 24x44x12, 1 to
// 12x22x6) that is 953 MB a forward, 0.28 ms. The gradient reads the
// 8-times-larger cotangent and writes the input's size: the same bytes.
//
// What the design does about it. A thread owns one output column (n, ow,
// od) times one 16-byte vector of channels (8 bf16 or 4 f32) and walks
// ROWS output rows along H; consecutive threads take consecutive vectors,
// then od, so each row a warp writes is contiguous, in 16-byte stores.
// Along the walk it keeps in registers the D-blends of the two input rows
// the current output row reads (at W's lo and hi), and loads and blends an
// input row only when the source index moves to it: about 2.5 vector loads
// and 8 flops a channel per output vector. One thread an output voxel
// takes 8 loads and 14 flops, and on an H100 that left it bound by
// instruction issue at 27% of the bandwidth. The blend is ATen's, in its
// order: W of H of D, in f32, one rounding to the output type.
// Channel counts or addresses that 16 bytes does not divide (C = 2, 3)
// take a scalar path: one channel a thread, the same steps. The gradient
// kernel gathers, one input voxel times one vector a thread: the three
// per-axis runs of outputs (weights in registers), a 3D loop over at most
// 5x5x5 cotangent vectors summed in f32 in a fixed order (W, then H, then
// D), one rounding to the output type. No atomics: the result is the same
// bits on every call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS = 256;

struct Src {
  int lo, hi;
  float lam;
};

// PyTorch's align-corners source index of output o on an axis of input
// size n.
__device__ __forceinline__ Src source(int o, int n, float scale) {
  const float src = scale * static_cast<float>(o);
  Src s;
  s.lo = static_cast<int>(src);
  s.hi = s.lo + (s.lo < n - 1 ? 1 : 0);
  s.lam = src - static_cast<float>(s.lo);
  return s;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC channels of type T at p, as floats; 16-byte loads and stores where
// VEC * sizeof(T) == 16.
template <typename T, int VEC> struct Vec {
  static __device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = to_float(p[k]);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = from_float<T>(v[k]);
  }
};

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 pair;
      memcpy(&pair, &words[k], 4);
      const float2 f = __bfloat1622float2(pair);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint32_t words[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      memcpy(&words[k], &pair, 4);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
  }
};

// r's remainder by m; r becomes the quotient.
__device__ __forceinline__ int take(uint32_t& r, int m) {
  const uint32_t q = r / static_cast<uint32_t>(m);
  const int rem = static_cast<int>(r - q * static_cast<uint32_t>(m));
  r = q;
  return rem;
}

// The element offset of channel vector v at voxel (n, w, h, d) of an
// (N, W, H, D, C) tensor.
__device__ __forceinline__ int64_t offset(uint32_t n, int w, int h, int d, int W, int H, int D,
                                          int C, int c0) {
  return ((static_cast<int64_t>(n) * W + w) * H + h) * static_cast<int64_t>(D) * C +
         static_cast<int64_t>(d) * C + c0;
}

// Output rows along H that one forward thread walks.
constexpr int ROWS = 8;

// q = d0 * lo + d1 * hi on VEC channels.
template <typename T, int VEC>
__device__ __forceinline__ void blend_d(const T* lo, const T* hi, float d0, float d1,
                                        float (&q)[VEC]) {
  float a[VEC], b[VEC];
  Vec<T, VEC>::load(lo, a);
  Vec<T, VEC>::load(hi, b);
#pragma unroll
  for (int k = 0; k < VEC; ++k) q[k] = d0 * a[k] + d1 * b[k];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    upsample_trilinear2x_kernel(const T* __restrict__ x, T* __restrict__ out, uint32_t columns,
                                int W, int H, int D, int C, float sw, float sh, float sd) {
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= columns) return;
  uint32_t n = i;
  const int v = take(n, C / VEC);
  const int od = take(n, 2 * D);
  const int ow = take(n, 2 * W);
  const Src a = source(ow, W, sw), c = source(od, D, sd);
  const float w0 = 1.f - a.lam, w1 = a.lam, d0 = 1.f - c.lam, d1 = c.lam;
  const int64_t row = static_cast<int64_t>(D) * C;  // elements from one h to the next
  const int c0 = v * VEC, dlo = c.lo * C + c0, dhi = c.hi * C + c0;
  const T* at_wlo = x + (static_cast<int64_t>(n) * W + a.lo) * H * row;
  const T* at_whi = x + (static_cast<int64_t>(n) * W + a.hi) * H * row;
  const int oh0 = blockIdx.y * ROWS, oh1 = min(oh0 + ROWS, 2 * H);
  T* o = out + ((static_cast<int64_t>(n) * 2 * W + ow) * 2 * H + oh0) * 2 * row +
         static_cast<int64_t>(od) * C + c0;
  // the D-blends of input rows ia and ib at W's lo ([0]) and hi ([1])
  int ia = -1, ib = -1;
  float qa[2][VEC], qb[2][VEC];
  for (int oh = oh0; oh < oh1; ++oh, o += 2 * row) {
    const Src b = source(oh, H, sh);
    if (b.lo != ia) {
      if (b.lo == ib) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) qa[0][k] = qb[0][k], qa[1][k] = qb[1][k];
      } else {
        blend_d<T, VEC>(at_wlo + b.lo * row + dlo, at_wlo + b.lo * row + dhi, d0, d1, qa[0]);
        blend_d<T, VEC>(at_whi + b.lo * row + dlo, at_whi + b.lo * row + dhi, d0, d1, qa[1]);
      }
      ia = b.lo;
    }
    if (b.hi != ib) {
      if (b.hi == ia) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) qb[0][k] = qa[0][k], qb[1][k] = qa[1][k];
      } else {
        blend_d<T, VEC>(at_wlo + b.hi * row + dlo, at_wlo + b.hi * row + dhi, d0, d1, qb[0]);
        blend_d<T, VEC>(at_whi + b.hi * row + dlo, at_whi + b.hi * row + dhi, d0, d1, qb[1]);
      }
      ib = b.hi;
    }
    const float h0 = 1.f - b.lam, h1 = b.lam;
    float y[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      y[k] = w0 * (h0 * qa[0][k] + h1 * qb[0][k]) + w1 * (h0 * qa[1][k] + h1 * qb[1][k]);
    Vec<T, VEC>::store(o, y);
  }
}

// The forward's weights of the outputs 2i-2 .. 2i+3 on input index i of an
// axis of input size n: hit[k] where output 2i-2+k reads i.
struct Taps {
  int first;
  bool hit[6];
  float weight[6];
};

__device__ __forceinline__ Taps taps(int i, int n, float scale) {
  Taps t;
  t.first = 2 * i - 2;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int o = t.first + k;
    const Src s = source(o, n, scale);
    const bool lo = s.lo == i, hi = s.hi == i;
    t.hit[k] = o >= 0 && o < 2 * n && (lo || hi);
    t.weight[k] = (lo ? 1.f - s.lam : 0.f) + (hi ? s.lam : 0.f);
  }
  return t;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    upsample_trilinear2x_dx_kernel(const T* __restrict__ g, T* __restrict__ dx, uint32_t total,
                                   int W, int H, int D, int C, float sw, float sh, float sd) {
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  uint32_t n = i;
  const int v = take(n, C / VEC);
  const int d = take(n, D);
  const int h = take(n, H);
  const int w = take(n, W);
  const Taps tw = taps(w, W, sw), th = taps(h, H, sh), td = taps(d, D, sd);
  const int c0 = v * VEC;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    if (!tw.hit[a]) continue;
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      if (!th.hit[b]) continue;
      const float wab = tw.weight[a] * th.weight[b];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        if (!td.hit[c]) continue;
        const float wt = wab * td.weight[c];
        float q[VEC];
        Vec<T, VEC>::load(g + offset(n, tw.first + a, th.first + b, td.first + c, 2 * W,
                                     2 * H, 2 * D, C, c0), q);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += wt * q[k];
      }
    }
  }
  Vec<T, VEC>::store(dx + offset(n, w, h, d, W, H, D, C, c0), acc);
}

// PyTorch's align-corners scale of an axis of input size n to 2n, on the
// host as ATen computes it (n >= 1: 0 for an axis of size 1).
float scale_of(int n) { return static_cast<float>(n - 1) / static_cast<float>(2 * n - 1); }

// One launch: the forward's threads are output columns (n, ow, od) times
// vectors, the gradient's input voxels times vectors. Thread indices are
// 32-bit: a launch of 2^32 threads or more (an input of at least 2^32
// channel vectors, 8.6 GB, beside 8 times as much output) is refused.
template <typename T, int VEC>
int launch_vec(bool grad, const void* src, void* dst, int N, int W, int H, int D, int C,
               cudaStream_t stream) {
  const int64_t voxels = grad ? static_cast<int64_t>(W) * H * D : static_cast<int64_t>(4) * W * D;
  const int64_t items = N * voxels * (C / VEC);
  if (items > static_cast<int64_t>(UINT32_MAX) - THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const float sw = scale_of(W), sh = scale_of(H), sd = scale_of(D);
  const unsigned blocks = static_cast<unsigned>((items + THREADS - 1) / THREADS);
  const T* in = static_cast<const T*>(src);
  T* out = static_cast<T*>(dst);
  if (grad) {
    upsample_trilinear2x_dx_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(
        in, out, static_cast<uint32_t>(items), W, H, D, C, sw, sh, sd);
  } else {
    const dim3 grid(blocks, (2 * H + ROWS - 1) / ROWS);
    upsample_trilinear2x_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
        in, out, static_cast<uint32_t>(items), W, H, D, C, sw, sh, sd);
  }
  return static_cast<int>(cudaGetLastError());
}

// 16-byte vectors where C and both addresses allow them, else one channel
// a thread. W, H, D are the input's grid in both directions.
template <typename T>
int launch(bool grad, const void* src, void* dst, int N, int W, int H, int D, int C,
           void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = C % VEC == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_vec<T, VEC>(grad, src, dst, N, W, H, D, C, s)
             : launch_vec<T, 1>(grad, src, dst, N, W, H, D, C, s);
}

}  // namespace

// x (N, W, H, D, C) -> out (N, 2W, 2H, 2D, C).
extern "C" int upsample_trilinear2x_f32(const void* x, void* out, int N, int W, int H, int D,
                                        int C, void* stream) {
  return launch<float>(false, x, out, N, W, H, D, C, stream);
}

extern "C" int upsample_trilinear2x_bf16(const void* x, void* out, int N, int W, int H, int D,
                                         int C, void* stream) {
  return launch<__nv_bfloat16>(false, x, out, N, W, H, D, C, stream);
}

// g (N, 2W, 2H, 2D, C) -> dx (N, W, H, D, C).
extern "C" int upsample_trilinear2x_dx_f32(const void* g, void* dx, int N, int W, int H, int D,
                                           int C, void* stream) {
  return launch<float>(true, g, dx, N, W, H, D, C, stream);
}

extern "C" int upsample_trilinear2x_dx_bf16(const void* g, void* dx, int N, int W, int H,
                                            int D, int C, void* stream) {
  return launch<__nv_bfloat16>(true, g, dx, N, W, H, D, C, stream);
}
