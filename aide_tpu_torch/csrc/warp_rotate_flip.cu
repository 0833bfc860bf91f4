// Fused TTA rotate/flip warp for Hopper (sm_90a).
//
// Replaces the TPU kernel aide_tpu/ops/pallas_warp.py::_warp_kernel. The
// design note (what bounds it, why one thread per output pixel) is in
// aide_tpu_torch/ops/cuda_warp.py; warp_plain there is the same function in
// plain PyTorch, with the same index math and operation order.
//
// Layout: in/out (N, S, S, C) float32, NHWC, contiguous. table (N, 4) f32:
// [lam_x = -tan(theta/2), lam_y = sin(theta), n90 in {-1, 0, 1}, flip in
// {0, 1}] of the residual angle; fill (N, C) f32.
//
// out(y, x) = shear(u)(y, x') with x' = flip ? S-1-x : x on the forward pass
// (x' = x on the inverse), u = rot90(v, n90), v = img on the forward pass and
// hflip(img) on the inverse. shear is three 1-D lerps: stage 1 along x by
// lam_x*(row - c), stage 2 along y by lam_y*(col - c), stage 3 along x by
// lam_x*(row - c). A tap outside [0, S-1] at any stage IS the fill value;
// it is never computed from the stage before.
//
// Build with -fmad=false so that d = lam*(j - c) and the lerps round as the
// plain version's separate multiplies and adds do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Split {
  int k;     // floor(d)
  float f;   // d - floor(d)
};

__device__ __forceinline__ Split split(float lam, int j, float cen) {
  const float d = lam * ((float)j - cen);
  const float k = floorf(d);
  Split s;
  s.k = (int)k;
  s.f = d - k;
  return s;
}

__device__ __forceinline__ bool inside(int i, int s) { return i >= 0 && i <= s - 1; }

__device__ __forceinline__ float lerp(float f, float a, float b) {
  return (1.0f - f) * a + f * b;
}

__global__ void warp_rotate_flip_kernel(const float* __restrict__ in,
                                        float* __restrict__ out,
                                        const float* __restrict__ table,
                                        const float* __restrict__ fill,
                                        int n_img, int s, int c, int inverse) {
  const int64_t plane = (int64_t)s * s;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n_img * plane) return;
  const int n = (int)(idx / plane);
  const int y = (int)((idx / s) % s);
  const int x = (int)(idx % s);

  const float lam_x = table[4 * n + 0];
  const float lam_y = table[4 * n + 1];
  const int n90 = (int)table[4 * n + 2];
  const bool flip = table[4 * n + 3] > 0.5f;
  const float cen = (float)(s - 1) * 0.5f;

  const int xo = (!inverse && flip) ? s - 1 - x : x;

  // Stage 3 taps x3[t3] on row y; stage 2 taps y2[t3][t2] on column x3;
  // stage 1 taps x1[t3][t2][t1] on row y2. Offsets of the 8 source pixels
  // (in units of pixels) and every stage's validity, shared by all channels.
  const Split s3 = split(lam_x, y, cen);
  bool v3[2], v2[2][2], v1[2][2][2];
  float f2[2], f1[2][2];
  int64_t off[2][2][2];
  for (int t3 = 0; t3 < 2; ++t3) {
    const int x3 = xo + s3.k + t3;
    v3[t3] = inside(x3, s);
    const Split s2 = split(lam_y, x3, cen);
    f2[t3] = s2.f;
    for (int t2 = 0; t2 < 2; ++t2) {
      const int y2 = y + s2.k + t2;
      v2[t3][t2] = inside(y2, s);
      const Split s1 = split(lam_x, y2, cen);
      f1[t3][t2] = s1.f;
      for (int t1 = 0; t1 < 2; ++t1) {
        const int x1 = x3 + s1.k + t1;
        v1[t3][t2][t1] = inside(x1, s);
        // u(i, j) = v(r, col): rot90 folded into the index
        int r, col;
        if (n90 == 1) {
          r = x1; col = s - 1 - y2;
        } else if (n90 == -1) {
          r = s - 1 - x1; col = y2;
        } else {
          r = y2; col = x1;
        }
        if (inverse && flip) col = s - 1 - col;
        r = min(max(r, 0), s - 1);
        col = min(max(col, 0), s - 1);
        off[t3][t2][t1] = ((int64_t)n * s + r) * s + col;
      }
    }
  }

  float* dst = out + idx * c;
  for (int ch = 0; ch < c; ++ch) {
    const float fl = fill[(int64_t)n * c + ch];
    float s2v[2];
    for (int t3 = 0; t3 < 2; ++t3) {
      if (!v3[t3]) {
        s2v[t3] = fl;
        continue;
      }
      float s1v[2];
      for (int t2 = 0; t2 < 2; ++t2) {
        if (!v2[t3][t2]) {
          s1v[t2] = fl;
          continue;
        }
        const float a = v1[t3][t2][0] ? __ldg(in + off[t3][t2][0] * c + ch) : fl;
        const float b = v1[t3][t2][1] ? __ldg(in + off[t3][t2][1] * c + ch) : fl;
        s1v[t2] = lerp(f1[t3][t2], a, b);
      }
      s2v[t3] = lerp(f2[t3], s1v[0], s1v[1]);
    }
    dst[ch] = lerp(s3.f, s2v[0], s2v[1]);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int warp_rotate_flip_f32(const void* in, void* out, const void* table,
                                    const void* fill, int n_img, int s, int c,
                                    int inverse, void* stream) {
  const int64_t total = (int64_t)n_img * s * s;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  warp_rotate_flip_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (const float*)table, (const float*)fill, n_img,
      s, c, inverse);
  return (int)cudaGetLastError();
}
