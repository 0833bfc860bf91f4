// The decoders' fixed 2x bilinear upsample (half-pixel centres, edge clamp)
// for Hopper (sm_90a), one kernel in each direction.
//
// Replaces no TPU kernel: the JAX package resizes with jax.image.resize, a
// library call. The design note (what bounds it, why it exists) is in
// aide_tpu_torch/ops/cuda_upsample.py; upsample2x_plain and
// upsample2x_grad_plain there are the same functions in plain PyTorch, with
// the same index math and operation order.
//
// Layout: NHWC, contiguous (the memory of a channels_last NCHW tensor). in
// (N, H, W, C), out (N, 2H, 2W, C). Each element type is float, half or
// bfloat16 (dtype codes 0, 1, 2), input and output apart; every sum is taken
// in float and rounded once, to nearest even, to the output's type.
//
// Along one axis of length L, output o takes the taps (i0, i1) with the
// weights (l0, l1):
//   o = 2k + 1 (odd):       (k, min(k + 1, L - 1)),  (0.75, 0.25)
//   o = 2k (even), k >= 1:  (k - 1, k),              (0.25, 0.75)
//   o = 0:                  (0, 0),                  (1, 0)
// which is ATen's upsample_bilinear2d (align_corners=False, scale 2) with
// the zero-weight tap of row 0 and the edge's repeated tap read at the
// clamped index. out = lh0 * (lw0 * v[i0][j0] + lw1 * v[i0][j1])
//                    + lh1 * (lw0 * v[i1][j0] + lw1 * v[i1][j1]),
// ATen's order. Built with -fmad=false, so each product and sum rounds as
// the plain version's separate multiplies and adds do.
//
// Forward: one thread per input 2x2 block (i, j) in [0, H] x [0, W] and a
// vector of V channels. Rows {2i - 1, 2i} and columns {2j - 1, 2j} of the
// output (those inside it) take their taps from input rows {max(i - 1, 0),
// min(i, H - 1)} and columns {max(j - 1, 0), min(j, W - 1)} alone, so a
// thread loads 4 vectors and stores up to 4. The 4 threads that share an
// input pixel read it through L1/L2; each element leaves device memory once
// and each output is written once.
//
// Backward: a gather. One thread per input pixel (i, j) and V channels sums
// its output-gradient taps, rows {2i - 1 .. 2i + 2} and columns {2j - 1 ..
// 2j + 2} clamped into the output, with the transposed weights
//   2i - 1: i >= 1 ? 0.25 : 0      2i:     i == 0 ? 1 : 0.75
//   2i + 1: i == L - 1 ? 1 : 0.75  2i + 2: i <= L - 2 ? 0.25 : 0
// first along W (each tap row: ((wa*ga + wb*gb) + wc*gc) + wd*gd), then
// along H in the same order. No atomics, no zero-fill: each gradient is
// written once, and the result does not depend on the schedule.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// one vector's bits: 2, 4, 8 or 16 bytes in one load or store
template <int kBytes>
struct Raw;
template <>
struct Raw<2> { using type = unsigned short; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

// V elements of type T at p (aligned to their size) as floats
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float* v) {
  using R = typename Raw<sizeof(T) * V>::type;
  const R r = __ldg(reinterpret_cast<const R*>(p));
  T e[V];
  memcpy(e, &r, sizeof(r));
#pragma unroll
  for (int q = 0; q < V; ++q) v[q] = to_f32(e[q]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* v) {
  T e[V];
#pragma unroll
  for (int q = 0; q < V; ++q) e[q] = from_f32<T>(v[q]);
  using R = typename Raw<sizeof(T) * V>::type;
  R r;
  memcpy(&r, e, sizeof(r));
  *reinterpret_cast<R*>(p) = r;
}

// a = l0 * x + l1 * y, elementwise
template <int V>
__device__ __forceinline__ void lerp(float* a, float l0, const float* x, float l1, const float* y) {
#pragma unroll
  for (int q = 0; q < V; ++q) a[q] = l0 * x[q] + l1 * y[q];
}

template <typename T, typename O, int V>
__global__ void __launch_bounds__(kThreads)
    upsample2x_fwd_kernel(const T* __restrict__ in, O* __restrict__ out, int h, int w, int c) {
  const int cv = c / V;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= (w + 1) * cv) return;
  const int j = t / cv;
  const int k = (t - j * cv) * V;
  const int i = blockIdx.y;
  const int64_t n = blockIdx.z;
  const int r0 = max(i - 1, 0), r1 = min(i, h - 1);
  const int c0 = max(j - 1, 0), c1 = min(j, w - 1);
  const T* img = in + n * h * w * c + k;
  float v00[V], v01[V], v10[V], v11[V];
  load<T, V>(img + ((int64_t)r0 * w + c0) * c, v00);
  load<T, V>(img + ((int64_t)r0 * w + c1) * c, v01);
  load<T, V>(img + ((int64_t)r1 * w + c0) * c, v10);
  load<T, V>(img + ((int64_t)r1 * w + c1) * c, v11);
  // the even output (2i or 2j) takes (1, 0) at the first index
  const float ew0 = j == 0 ? 1.0f : 0.25f, ew1 = j == 0 ? 0.0f : 0.75f;
  const float eh0 = i == 0 ? 1.0f : 0.25f, eh1 = i == 0 ? 0.0f : 0.75f;
  // along W first: columns 2j - 1 (odd) and 2j (even) of rows r0 and r1
  float a0o[V], a0e[V], a1o[V], a1e[V];
  lerp<V>(a0o, 0.75f, v00, 0.25f, v01);
  lerp<V>(a0e, ew0, v00, ew1, v01);
  lerp<V>(a1o, 0.75f, v10, 0.25f, v11);
  lerp<V>(a1e, ew0, v10, ew1, v11);
  const int ow = 2 * w;
  O* img_out = out + n * (2 * h) * ow * c + k;
  float o[V];
  if (i > 0) {  // output row 2i - 1
    O* row = img_out + (int64_t)(2 * i - 1) * ow * c;
    if (j > 0) {
      lerp<V>(o, 0.75f, a0o, 0.25f, a1o);
      store<O, V>(row + (int64_t)(2 * j - 1) * c, o);
    }
    if (j < w) {
      lerp<V>(o, 0.75f, a0e, 0.25f, a1e);
      store<O, V>(row + (int64_t)(2 * j) * c, o);
    }
  }
  if (i < h) {  // output row 2i
    O* row = img_out + (int64_t)(2 * i) * ow * c;
    if (j > 0) {
      lerp<V>(o, eh0, a0o, eh1, a1o);
      store<O, V>(row + (int64_t)(2 * j - 1) * c, o);
    }
    if (j < w) {
      lerp<V>(o, eh0, a0e, eh1, a1e);
      store<O, V>(row + (int64_t)(2 * j) * c, o);
    }
  }
}

// the four taps of input index i along an axis of length l (output 2l) and
// their transposed weights, an absent tap clamped in with weight 0
__device__ __forceinline__ void grad_taps(int i, int l, int* tap, float* wt) {
  tap[0] = max(2 * i - 1, 0);
  tap[1] = 2 * i;
  tap[2] = 2 * i + 1;
  tap[3] = min(2 * i + 2, 2 * l - 1);
  wt[0] = i >= 1 ? 0.25f : 0.0f;
  wt[1] = i == 0 ? 1.0f : 0.75f;
  wt[2] = i == l - 1 ? 1.0f : 0.75f;
  wt[3] = i <= l - 2 ? 0.25f : 0.0f;
}

template <typename G, typename T, int V>
__global__ void __launch_bounds__(kThreads)
    upsample2x_bwd_kernel(const G* __restrict__ gout, T* __restrict__ gin, int h, int w, int c) {
  const int cv = c / V;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= w * cv) return;
  const int j = t / cv;
  const int k = (t - j * cv) * V;
  const int i = blockIdx.y;
  const int64_t n = blockIdx.z;
  const int ow = 2 * w;
  int ty[4], tx[4];
  float wy[4], wx[4];
  grad_taps(i, h, ty, wy);
  grad_taps(j, w, tx, wx);
  const G* img = gout + n * (2 * h) * ow * c + k;
  float acc[V];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const G* row = img + (int64_t)ty[a] * ow * c;
    float s[V], g[V];
    load<G, V>(row + (int64_t)tx[0] * c, g);
#pragma unroll
    for (int q = 0; q < V; ++q) s[q] = wx[0] * g[q];
#pragma unroll
    for (int b = 1; b < 4; ++b) {
      load<G, V>(row + (int64_t)tx[b] * c, g);
#pragma unroll
      for (int q = 0; q < V; ++q) s[q] = s[q] + wx[b] * g[q];
    }
    if (a == 0) {
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = wy[0] * s[q];
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = acc[q] + wy[a] * s[q];
    }
  }
  store<T, V>(gin + ((n * h + i) * w + j) * c + k, acc);
}

// the launch of one direction at element types (A, B) and V channels a
// thread; V * sizeof must be a vector of at most 16 bytes on both sides
template <typename A, typename B, int V>
int launch(bool forward, const void* src, void* dst, int n, int h, int w, int c,
           cudaStream_t stream) {
  if constexpr (V * sizeof(A) > 16 || V * sizeof(B) > 16) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int cols = (forward ? w + 1 : w) * (c / V);
    const dim3 grid((cols + kThreads - 1) / kThreads, forward ? h + 1 : h, n);
    if (forward) {
      upsample2x_fwd_kernel<A, B, V><<<grid, kThreads, 0, stream>>>(
          (const A*)src, (B*)dst, h, w, c);
    } else {
      upsample2x_bwd_kernel<A, B, V><<<grid, kThreads, 0, stream>>>(
          (const A*)src, (B*)dst, h, w, c);
    }
    return (int)cudaGetLastError();
  }
}

template <typename A, typename B>
int by_vec(bool forward, const void* src, void* dst, int n, int h, int w, int c, int vec,
           cudaStream_t stream) {
  switch (vec) {
    case 1: return launch<A, B, 1>(forward, src, dst, n, h, w, c, stream);
    case 2: return launch<A, B, 2>(forward, src, dst, n, h, w, c, stream);
    case 4: return launch<A, B, 4>(forward, src, dst, n, h, w, c, stream);
    case 8: return launch<A, B, 8>(forward, src, dst, n, h, w, c, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename A>
int by_dst(bool forward, const void* src, void* dst, int dst_dtype, int n, int h, int w, int c,
           int vec, cudaStream_t stream) {
  switch (dst_dtype) {
    case 0: return by_vec<A, float>(forward, src, dst, n, h, w, c, vec, stream);
    case 1: return by_vec<A, __half>(forward, src, dst, n, h, w, c, vec, stream);
    case 2: return by_vec<A, __nv_bfloat16>(forward, src, dst, n, h, w, c, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(bool forward, const void* src, void* dst, int src_dtype, int dst_dtype, int n,
             int h, int w, int c, int vec, void* stream) {
  if (c % vec != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (src_dtype) {
    case 0: return by_dst<float>(forward, src, dst, dst_dtype, n, h, w, c, vec, s);
    case 1: return by_dst<__half>(forward, src, dst, dst_dtype, n, h, w, c, vec, s);
    case 2: return by_dst<__nv_bfloat16>(forward, src, dst, dst_dtype, n, h, w, c, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Both launch on `stream`, do not
// synchronise and allocate nothing; each returns cudaGetLastError() of its
// launch (cudaErrorInvalidValue, unlaunched, for a dtype code or vector
// width it does not take). H, W and C are the input's.
//
// in (N, H, W, C) of in_dtype -> out (N, 2H, 2W, C) of out_dtype.
extern "C" int upsample2x_forward(const void* in, void* out, int in_dtype, int out_dtype, int n,
                                  int h, int w, int c, int vec, void* stream) {
  return dispatch(true, in, out, in_dtype, out_dtype, n, h, w, c, vec, stream);
}

// grad_out (N, 2H, 2W, C) of grad_out_dtype -> grad_in (N, H, W, C) of
// grad_in_dtype.
extern "C" int upsample2x_backward(const void* grad_out, void* grad_in, int grad_out_dtype,
                                   int grad_in_dtype, int n, int h, int w, int c, int vec,
                                   void* stream) {
  return dispatch(false, grad_out, grad_in, grad_out_dtype, grad_in_dtype, n, h, w, c, vec,
                  stream);
}
