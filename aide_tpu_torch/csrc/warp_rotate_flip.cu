// Fused TTA rotate/flip warp for Hopper (sm_90a), tiled through shared memory.
//
// Replaces the TPU kernel aide_tpu/ops/pallas_warp.py::_warp_kernel. The
// design note (what bounds it, why the source box of each output tile is
// staged in shared memory) is in aide_tpu_torch/ops/cuda_warp.py; warp_plain
// there is the same function in plain PyTorch, with the same index math and
// operation order, and source_boxes the per-tile box this kernel stages.
//
// Layout: in (N, S, S, C) float32, NHWC, contiguous; out (N, rows, S, C), the
// output rows [row0, row0 + rows) of the warp (the whole image at row0 = 0,
// rows = S; a space shard's rows on a space axis). table (N, 4) f32:
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
// One block per kTile x kTile output tile of one image, kTile x kRows
// threads; a warp is one output row of the tile, each thread kTile / kRows
// rows of one column. The tiles cover the output window: tile row t starts
// at global output row row0 + t * kTile, and everything below (the index
// math, the source box) reads global rows, so a window is exactly a slice
// of the whole warp.
//   A. Every thread runs the 8-tap index math of its pixels and keeps the
//      min/max source row and column over the taps it will read; warp
//      shuffles and shared memory reduce them to the tile's exact source box.
//   B. The block copies the box into shared memory in the source's own NHWC
//      layout with cp.async: a box row is one contiguous run of box_w*C
//      floats in device memory whatever n90 and the flip are, so the copy is
//      coalesced, and all of a thread's copies are in flight at once.
//   C. Each thread recomputes its taps, reads them from shared memory at
//      y2*sy + x1*sx + base (the rot90 and flip folded into per-block
//      strides) and runs the three lerps in the same order as before.
//   C'. A tile whose box passes kBoxSide on a side takes the global-tap
//      path instead of B and C: each thread reads its taps straight from
//      device memory (__ldg) at y2*gy + x1*gx + gbase, the image's own
//      strides, with the same index math and operation order. The box is
//      reduced block-wide before the test, so the choice is one for the
//      whole block and no warp diverges.
// Every tile fits kBoxSide for residual angles |theta| <= 90 degrees, that
// is |degrees| <= 180 (cuda_warp.box_side derives the bound; the CPU tests
// check it against every tile's exact box). Past that the residual angle
// passes 90 degrees and a tile's box can grow to the whole image (near
// +-270 degrees, where lam_x = -tan(theta/2) passes 1e7): such tiles take
// C'; cuda_warp.global_tiles counts them.
//
// Build with -fmad=false so that d = lam*(j - c) and the lerps round as the
// plain version's separate multiplies and adds do.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;     // output tile side; cuda_warp.TILE
constexpr int kRows = 8;      // threads along y; each thread does kTile / kRows rows
constexpr int kBoxSide = 50;  // largest box side the staged path takes; cuda_warp.BOX_SIDE

// Row pitch of the staged box in floats: odd, so that neighbouring box rows
// start in different banks.
__host__ __device__ __forceinline__ int box_pitch(int c) { return (kBoxSide * c) | 1; }

// Bound on a shift's integer part. Near +-270 degrees |lam_x*(j - c)|
// passes 2^31, where a float-to-int conversion saturates and the index
// sums below would overflow. A shift past kFar puts every tap it moves
// outside the image, as the plain version's int64 shift does, and the sums
// of two clamped shifts and a pixel index stay below 2^31.
constexpr float kFar = 536870912.0f;  // 2^29

struct Split {
  int k;     // floor(d), clamped to +-kFar
  float f;   // d - floor(d)
};

__device__ __forceinline__ Split split(float lam, int j, float cen) {
  const float d = lam * ((float)j - cen);
  const float k = floorf(d);
  Split s;
  s.k = (int)fminf(fmaxf(k, -kFar), kFar);
  s.f = d - k;
  return s;
}

__device__ __forceinline__ bool inside(int i, int s) { return (unsigned)i < (unsigned)s; }

__device__ __forceinline__ float lerp(float f, float a, float b) {
  return (1.0f - f) * a + f * b;
}

// The 8 taps of output pixel (y, xo): stage 3 taps x3[t3] on row y; stage 2
// taps y2[t3][t2] on column x3; stage 1 taps x1[t3][t2][t1] on row y2. A
// tap is read only when rd[t3][t2][t1]: it and the stages above it are
// inside the image.
struct Taps {
  Split s3;
  bool v3[2], v2[2][2], rd[2][2][2];
  float f2[2], f1[2][2];
  int y2[2][2], x1[2][2][2];
};

__device__ __forceinline__ void taps(Taps& t, int y, int xo, float lam_x, float lam_y,
                                     float cen, int s) {
  t.s3 = split(lam_x, y, cen);
#pragma unroll
  for (int t3 = 0; t3 < 2; ++t3) {
    const int x3 = xo + t.s3.k + t3;
    t.v3[t3] = inside(x3, s);
    const Split s2 = split(lam_y, x3, cen);
    t.f2[t3] = s2.f;
#pragma unroll
    for (int t2 = 0; t2 < 2; ++t2) {
      const int y2 = y + s2.k + t2;
      t.y2[t3][t2] = y2;
      t.v2[t3][t2] = inside(y2, s);
      const Split s1 = split(lam_x, y2, cen);
      t.f1[t3][t2] = s1.f;
#pragma unroll
      for (int t1 = 0; t1 < 2; ++t1) {
        const int x1 = x3 + s1.k + t1;
        t.x1[t3][t2][t1] = x1;
        t.rd[t3][t2][t1] = t.v3[t3] && t.v2[t3][t2] && inside(x1, s);
      }
    }
  }
}

// Phase C for one thread's pixels: the taps of each read from src at
// y2*sy + x1*sx + base (the staged box in shared memory, or the image in
// device memory through the read-only cache) and lerped in the plain
// version's order. Only a read tap's offset is formed: an unread tap's
// index can lie far outside the image.
template <bool kStaged>
__device__ __forceinline__ void gather(const float* __restrict__ src,
                                       const float* __restrict__ fills,
                                       float* __restrict__ out, int sy, int sx, int base,
                                       int ty0, int y_end, int row0, int rows, int x, int xo,
                                       float lam_x, float lam_y, float cen, int s, int c,
                                       int n) {
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int y = ty0 + i;
    if (y >= y_end || x >= s) break;
    Taps t;
    taps(t, y, xo, lam_x, lam_y, cen, s);
    int off[2][2][2];
#pragma unroll
    for (int t3 = 0; t3 < 2; ++t3)
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
        for (int t1 = 0; t1 < 2; ++t1)
          off[t3][t2][t1] =
              t.rd[t3][t2][t1] ? t.y2[t3][t2] * sy + t.x1[t3][t2][t1] * sx + base : 0;

    float* dst = out + (((int64_t)n * rows + (y - row0)) * s + x) * c;
    for (int ch = 0; ch < c; ++ch) {
      const float fl = fills[ch];
      float s2v[2];
#pragma unroll
      for (int t3 = 0; t3 < 2; ++t3) {
        if (!t.v3[t3]) {
          s2v[t3] = fl;
          continue;
        }
        float s1v[2];
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2) {
          if (!t.v2[t3][t2]) {
            s1v[t2] = fl;
            continue;
          }
          float ab[2];
#pragma unroll
          for (int t1 = 0; t1 < 2; ++t1) {
            const int o = off[t3][t2][t1] + ch;
            ab[t1] = !t.rd[t3][t2][t1] ? fl : kStaged ? src[o] : __ldg(src + o);
          }
          s1v[t2] = lerp(t.f1[t3][t2], ab[0], ab[1]);
        }
        s2v[t3] = lerp(t.f2[t3], s1v[0], s1v[1]);
      }
      dst[ch] = lerp(t.s3.f, s2v[0], s2v[1]);
    }
  }
}

__global__ void __launch_bounds__(kTile * kRows)
warp_rotate_flip_kernel(const float* __restrict__ in, float* __restrict__ out,
                        const float* __restrict__ table, const float* __restrict__ fill,
                        int s, int c, int inverse, int row0, int rows) {
  extern __shared__ float box[];
  __shared__ int partial[4][kRows];

  const int n = blockIdx.z;
  const int ty0 = row0 + blockIdx.y * kTile;
  const int y_end = row0 + rows;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const float lam_x = table[4 * n + 0];
  const float lam_y = table[4 * n + 1];
  const int n90 = (int)table[4 * n + 2];
  const bool flip = table[4 * n + 3] > 0.5f;
  const float cen = (float)(s - 1) * 0.5f;
  const int xo = (!inverse && flip) ? s - 1 - x : x;
  const int pitch = box_pitch(c);
  float* fills = box + kBoxSide * pitch;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int ch = tid; ch < c; ch += kTile * kRows) fills[ch] = fill[n * c + ch];

  // A. bounds of the read taps in u's coordinates (row y2, column x1)
  int lo_y = INT_MAX, hi_y = INT_MIN, lo_x = INT_MAX, hi_x = INT_MIN;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int y = ty0 + i;
    if (y >= y_end || x >= s) break;
    Taps t;
    taps(t, y, xo, lam_x, lam_y, cen, s);
#pragma unroll
    for (int t3 = 0; t3 < 2; ++t3)
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
        for (int t1 = 0; t1 < 2; ++t1) {
          if (!t.rd[t3][t2][t1]) continue;
          lo_y = min(lo_y, t.y2[t3][t2]);
          hi_y = max(hi_y, t.y2[t3][t2]);
          lo_x = min(lo_x, t.x1[t3][t2][t1]);
          hi_x = max(hi_x, t.x1[t3][t2][t1]);
        }
  }
  lo_y = __reduce_min_sync(0xffffffffu, lo_y);
  hi_y = __reduce_max_sync(0xffffffffu, hi_y);
  lo_x = __reduce_min_sync(0xffffffffu, lo_x);
  hi_x = __reduce_max_sync(0xffffffffu, hi_x);
  if (threadIdx.x == 0) {
    partial[0][threadIdx.y] = lo_y;
    partial[1][threadIdx.y] = hi_y;
    partial[2][threadIdx.y] = lo_x;
    partial[3][threadIdx.y] = hi_x;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kRows; ++w) {
    lo_y = min(lo_y, partial[0][w]);
    hi_y = max(hi_y, partial[1][w]);
    lo_x = min(lo_x, partial[2][w]);
    hi_x = max(hi_x, partial[3][w]);
  }
  // u(i, j) = v(r, col): rot90 and the inverse's hflip make r and col
  // each one of y2, x1 or their reflections, r = ry*y2 + rx*x1 + rb and
  // col = cy*y2 + cx*x1 + cb with coefficients in {-1, 0, 1}
  int ry = 1, rx = 0, rb = 0, cy = 0, cx = 1, cb = 0;
  if (n90 == 1) {
    ry = 0; rx = 1; cy = -1; cx = 0; cb = s - 1;
  } else if (n90 == -1) {
    ry = 0; rx = -1; rb = s - 1; cy = 1; cx = 0;
  }
  if (inverse && flip) {
    cy = -cy; cx = -cx; cb = s - 1 - cb;
  }
  // so a tap's offset in the box is y2*sy + x1*sx + base, and in the image
  // y2*gy + x1*gx + gbase
  const int sy = ry * pitch + cy * c, sx = rx * pitch + cx * c;
  const int gy = (ry * s + cy) * c, gx = (rx * s + cx) * c, gbase = (rb * s + cb) * c;
  // the box in v's coordinates: rows [r0, r1], columns [c0, c1]; every
  // read tap lies in the image, so no side passes s. A tile that reads no
  // tap lies wholly in the fill: its box is empty and it stages nothing.
  int r0 = 0, r1 = -1, c0 = 0, c1 = -1;
  if (lo_x <= hi_x) {
    r0 = rb + min(ry * lo_y, ry * hi_y) + min(rx * lo_x, rx * hi_x);
    r1 = rb + max(ry * lo_y, ry * hi_y) + max(rx * lo_x, rx * hi_x);
    c0 = cb + min(cy * lo_y, cy * hi_y) + min(cx * lo_x, cx * hi_x);
    c1 = cb + max(cy * lo_y, cy * hi_y) + max(cx * lo_x, cx * hi_x);
  }
  // the same values in every thread, so the whole block takes one path
  const bool staged = r1 - r0 + 1 <= kBoxSide && c1 - c0 + 1 <= kBoxSide;
  const int base = (rb - r0) * pitch + (cb - c0) * c;
  if (staged) {
    // B. stage the box: warp w copies box rows w, w + kRows, ..., with
    // cp.async so that all of a thread's copies are in flight at once
    const int row_len = (c1 - c0 + 1) * c;
    const float* src = in + (((int64_t)n * s + r0) * s + c0) * c;
    for (int row = threadIdx.y; row <= r1 - r0; row += kRows) {
      const float* g = src + (int64_t)row * s * c;
      float* d = box + row * pitch;
      for (int k = threadIdx.x; k < row_len; k += kTile) {
        const unsigned sa = (unsigned)__cvta_generic_to_shared(d + k);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(g + k)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  // C. gather the taps from the box (or C'. from device memory) and lerp
  if (staged) {
    gather<true>(box, fills, out, sy, sx, base, ty0, y_end, row0, rows, x, xo, lam_x, lam_y,
                 cen, s, c, n);
  } else {
    const float* img = in + (int64_t)n * s * s * c;
    gather<false>(img, fills, out, gy, gx, gbase, ty0, y_end, row0, rows, x, xo, lam_x, lam_y,
                  cen, s, c, n);
  }
}

}  // namespace

// Dynamic shared memory of one block for C channels, in bytes: the box,
// then the image's C fill values. The wrapper checks it against its own.
extern "C" int warp_rotate_flip_smem_bytes(int c) {
  return (kBoxSide * box_pitch(c) + c) * (int)sizeof(float);
}

// Plain C entry point (loaded with ctypes): output rows [row0, row0 + rows)
// into an (n_img, rows, s, c) out. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int warp_rotate_flip_f32(const void* in, void* out, const void* table,
                                    const void* fill, int n_img, int s, int c,
                                    int inverse, int row0, int rows, void* stream) {
  const int smem = warp_rotate_flip_smem_bytes(c);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        warp_rotate_flip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((s + kTile - 1) / kTile, (rows + kTile - 1) / kTile, n_img);
  const dim3 block(kTile, kRows);
  warp_rotate_flip_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (const float*)table, (const float*)fill, s, c, inverse,
      row0, rows);
  return (int)cudaGetLastError();
}
