// Fused clamp + metric-cube crop + normalize over batched raw depth frames,
// with the per-sample crop geometry computed inside the kernel.
//
// Replaces the TPU kernel deepprior_tpu/ops/pallas_crop.py::
// pallas_normalized_crop / _crop_kernel / _sample_crop in both of its
// resize modes: K1, nearest (normalized_crop_kernel<false>), and K2, the
// cv2-linear crop (use_bilinear=True, normalized_crop_kernel<true>).  The
// Pallas kernel streams a banded VMEM window per sample and selects pixels
// with one-hot (K1) or weighted two-tap (K2) matmuls, because the TPU has
// no vector gather, and its wrapper computes the per-sample geometry
// outside the kernel, where XLA fuses it into a few ops.  On Hopper a
// gather is one load, exact by construction, and eager PyTorch would run
// that geometry as ~120 launches on (B,) tensors, so the kernel takes the
// raw inputs (com, cube, fx, fy and, with the fused clamp, the per-image
// depth limits) and computes everything itself.
//
// Design.  One block per (sample, tile of kTileRows output rows), 256
// threads as 8 rows x 32 four-pixel quads.
//   1. Prologue: thread 0 computes the sample's geometry into shared
//      memory (geometry.cuh::sample_geometry: ops/crop.py::com_to_bounds,
//      _embed_geometry, the normalization constants) and the first block of the sample writes
//      M (_transform_matrix).
//   2. The index map is separable: the source column depends on the output
//      column only, the source row on the output row only.  The block
//      computes the column map once for all dw columns and the row map for
//      its rows into shared memory: K1 the source column / row (-1 outside
//      the embedded region or the frame), K2 the two taps and the blend
//      fraction.  No division is left per pixel except the normalization's.
//   3. Body: each thread gathers the source pixels of 4 consecutive output
//      pixels (K1: of 4 rows at once, 16 independent loads in flight; K2:
//      the 16 taps of one quad-row), runs the epilogue and writes the quad
//      with one 16-byte store.
// What bounds it: bytes.  K1 needs the distinct source pixels of a sample
// (about 64 KB of a 1.2 MB NYU frame) plus its 64 KB of output; K2 the
// distinct taps of its two-tap windows, about twice K1's source pixels.  A
// warp's 32 quads read one source row over about 1.6x the crop's width, so
// the gathers fetch whole 32-byte sectors; the design keeps 2048 blocks in
// flight at B = 512 so that enough loads are outstanding to hide their
// latency, and each output byte is written once, coalesced.  On an H100 at
// B = 512 NYU frames K1 runs at about 54% of that byte bound and K2 at 67%
// (PERF.md); the sectors a downsampling gather fetches beyond the pixels
// it needs are the likely rest, not measured.
//
// Exactness: the geometry, the index map, the taps, the blend and the
// epilogue follow deepprior_tpu_torch/ops/crop.py op for op, in IEEE
// float32 with the _rn intrinsics so that nvcc never contracts a multiply
// and an add into an FMA or rewrites a division.  PyTorch computes
// `tensor * python_float` with the float cast to float32 and `t / 2.0` as
// an exact halving, so fx and fy arrive as float32.  K2's blend is the
// plain version's left-to-right d00*(1-fy)*(1-fx) + d01*(1-fy)*fx +
// d10*fy*(1-fx) + d11*fy*fx.  Crops and M are bit-identical to the plain
// PyTorch version.  Build without --use_fast_math and without
// -prec-div=false.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcrop.so crop.cu   (ops/_build.py does this)

#include <cuda_runtime.h>
#include <stdint.h>

#include "geometry.cuh"

namespace {

constexpr int kQuadThreads = 32;  // threadIdx.x: 4-pixel quads of a row
constexpr int kRowThreads = 8;    // threadIdx.y: rows worked on at once
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kRowThreads * kRowsPerThread;  // rows per block
constexpr int kThreads = kQuadThreads * kRowThreads;
constexpr int kMaxSmem = 48 * 1024;  // dynamic shared memory without opt-in

using dp::exact_floor_div;
using dp::Geometry;
using dp::sample_geometry;

// K2's two taps along one axis: source indices (columns, or row offsets
// row * w), -1 for a tap outside the frame and both -1 outside the embedded
// region; the blend fraction f and 1 - f
struct __align__(16) Taps {
  int t0, t1;
  float f, g;
};

// ops/crop.py::normalize_crop of a depth value that is not 0
__device__ __forceinline__ float scale_depth(float d, const Geometry& g,
                                             bool zero_one) {
  return zero_one ? __fdiv_rn(__fsub_rn(d, g.lo), g.cube_z)
                  : __fdiv_rn(__fsub_rn(d, g.com_z), g.cube_half);
}

// ops/crop.py::normalize_crop of one depth value: 0, the background, is
// the far cube face, whose value the prologue computed once (g.bg)
__device__ __forceinline__ float normalize(float d, const Geometry& g,
                                           bool zero_one) {
  return d == 0.0f ? g.bg : scale_depth(d, g, zero_one);
}

// K1's source index along one axis for output coordinate o: the nearest
// map start + floor((o - off) * extent / sz) (cv2.INTER_NEAREST), times
// `stride`; -1 outside the embedded region [off, off + sz) or the frame
__device__ __forceinline__ int nearest_index(int o, float off, float sz,
                                             float extent, float start,
                                             int limit, int stride) {
  const float of = static_cast<float>(o);
  if (!(of >= off && of < __fadd_rn(off, sz))) return -1;
  const float p = __fadd_rn(
      start, exact_floor_div(__fmul_rn(__fsub_rn(of, off), extent), sz));
  if (!(p >= 0.0f && p < static_cast<float>(limit))) return -1;
  return static_cast<int>(p) * stride;
}

// K2's taps along one axis (ops/resize.py::halfpixel_taps): the source
// coordinate, taps clamped to the patch [0, extent - 1] and shifted by
// start, the fraction clamped to [0, 1]; ratio = extent / sz
__device__ __forceinline__ Taps linear_taps(int o, float off, float sz,
                                            float extent, float ratio,
                                            float start, int limit,
                                            int stride) {
  const float of = static_cast<float>(o);
  Taps t;
  t.t0 = t.t1 = -1;
  t.f = 0.0f;
  t.g = 1.0f;
  if (!(of >= off && of < __fadd_rn(off, sz))) return t;
  const float sp = __fsub_rn(
      __fmul_rn(__fadd_rn(__fsub_rn(of, off), 0.5f), ratio), 0.5f);
  const float last = __fsub_rn(extent, 1.0f);
  const float a = fminf(fmaxf(floorf(sp), 0.0f), last);
  t.f = fminf(fmaxf(__fsub_rn(sp, a), 0.0f), 1.0f);
  t.g = __fsub_rn(1.0f, t.f);
  const float p0 = __fadd_rn(a, start);
  const float p1 = __fadd_rn(fminf(__fadd_rn(a, 1.0f), last), start);
  const float lim = static_cast<float>(limit);
  if (p0 >= 0.0f && p0 < lim) t.t0 = static_cast<int>(p0) * stride;
  if (p1 >= 0.0f && p1 < lim) t.t1 = static_cast<int>(p1) * stride;
  return t;
}

// the fused clamp (pixels outside the image's [min_d, max_d] -> 0), then
// the z-threshold (handdetector.py:291-295): near -> zstart, far -> 0
__device__ __forceinline__ float clean(float d, const Geometry& g,
                                       bool clamp) {
  if (clamp && !(d >= g.min_d && d <= g.max_d)) d = 0.0f;
  if (d < g.zstart && d != 0.0f) d = g.zstart;
  return d > g.zend ? 0.0f : d;
}

__device__ __forceinline__ float gather(const float* __restrict__ img,
                                        int row, int col) {
  return row >= 0 && col >= 0 ? __ldg(img + row + col) : 0.0f;
}

__device__ __forceinline__ void store4(float* __restrict__ dst, int u0,
                                       int dw, const float r[4]) {
  if ((dw & 3) == 0) {
    *reinterpret_cast<float4*>(dst + u0) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (u0 + j < dw) dst[u0 + j] = r[j];
    }
  }
}

// grid (ceil(dh / kTileRows), b), block (kQuadThreads, kRowThreads).
// cube: 3 floats per sample at stride cube_stride (0: one cube for all).
// min_d/max_d: (b,) limits, read only with fuse_clamp.
template <bool kLinear>
__global__ void __launch_bounds__(kThreads)
normalized_crop_kernel(const float* __restrict__ dpt,
                       const float* __restrict__ com,
                       const float* __restrict__ cube, int cube_stride,
                       float fx, float fy,
                       const float* __restrict__ min_d,
                       const float* __restrict__ max_d,
                       float* __restrict__ out, float* __restrict__ m_out,
                       int h, int w, int dh, int dw, int fuse_clamp,
                       int norm_zero_one) {
  // the index map: (dw + rows) ints (K1) or Taps (K2)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Geometry g;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int tid = threadIdx.y * kQuadThreads + threadIdx.x;
  const bool clamp = fuse_clamp != 0, zero_one = norm_zero_one != 0;

  // 1. the sample's geometry; the sample's first block writes M
  if (tid == 0) {
    float m[9];
    Geometry s = sample_geometry(com + 3 * b, cube + cube_stride * b, fx, fy,
                                 h, w, dh, dw, m);
    s.bg = scale_depth(__fadd_rn(s.com_z, s.cube_half), s, zero_one);
    s.min_d = clamp ? min_d[b] : 0.0f;
    s.max_d = clamp ? max_d[b] : 0.0f;
    g = s;
    if (blockIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) m_out[9 * b + i] = m[i];
    }
  }
  __syncthreads();

  // 2. the separable index map: dw columns, then this tile's rows
  const int n_rows = min(kTileRows, dh - row0);
  for (int i = tid; i < dw + n_rows; i += kThreads) {
    if (kLinear) {
      Taps* taps = reinterpret_cast<Taps*>(smem);
      taps[i] = i < dw
          ? linear_taps(i, g.off_x, g.sz_w, g.wb, __fdiv_rn(g.wb, g.sz_w),
                        g.xstart, w, 1)
          : linear_taps(row0 + i - dw, g.off_y, g.sz_h, g.hb,
                        __fdiv_rn(g.hb, g.sz_h), g.ystart, h, w);
    } else {
      int* idx = reinterpret_cast<int*>(smem);
      idx[i] = i < dw
          ? nearest_index(i, g.off_x, g.sz_w, g.wb, g.xstart, w, 1)
          : nearest_index(row0 + i - dw, g.off_y, g.sz_h, g.hb, g.ystart, h, w);
    }
  }
  __syncthreads();

  // 3. gather, epilogue, one 16-byte store per quad
  const float* __restrict__ img = dpt + static_cast<int64_t>(b) * h * w;
  float* __restrict__ dst = out + static_cast<int64_t>(b) * dh * dw;
  for (int u0 = 4 * threadIdx.x; u0 < dw; u0 += 4 * kQuadThreads) {
    if (kLinear) {
      const Taps* taps = reinterpret_cast<const Taps*>(smem);
      Taps cx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cx[j] = u0 + j < dw ? taps[u0 + j] : Taps{-1, -1, 0.0f, 1.0f};
      }
      for (int r = threadIdx.y; r < n_rows; r += kRowThreads) {
        const Taps ry = taps[dw + r];
        float d[4][4];  // [pixel][tap 00, 01, 10, 11]
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[j][0] = gather(img, ry.t0, cx[j].t0);
          d[j][1] = gather(img, ry.t0, cx[j].t1);
          d[j][2] = gather(img, ry.t1, cx[j].t0);
          d[j][3] = gather(img, ry.t1, cx[j].t1);
        }
        float res[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // each tap cleaned before the blend (crop -> threshold -> resize);
          // no post-blend threshold.  Taps outside the embedded region are
          // all -1, so the blend is 0 there: the background.
          const float a00 = clean(d[j][0], g, clamp);
          const float a01 = clean(d[j][1], g, clamp);
          const float a10 = clean(d[j][2], g, clamp);
          const float a11 = clean(d[j][3], g, clamp);
          float s = __fmul_rn(__fmul_rn(a00, ry.g), cx[j].g);
          s = __fadd_rn(s, __fmul_rn(__fmul_rn(a01, ry.g), cx[j].f));
          s = __fadd_rn(s, __fmul_rn(__fmul_rn(a10, ry.f), cx[j].g));
          s = __fadd_rn(s, __fmul_rn(__fmul_rn(a11, ry.f), cx[j].f));
          res[j] = normalize(s, g, zero_one);
        }
        store4(dst + static_cast<int64_t>(row0 + r) * dw, u0, dw, res);
      }
    } else {
      const int* idx = reinterpret_cast<const int*>(smem);
      int cx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) cx[j] = u0 + j < dw ? idx[u0 + j] : -1;
      float d[kRowsPerThread][4];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int r = threadIdx.y + k * kRowThreads;
        const int ry = r < n_rows ? idx[dw + r] : -1;
#pragma unroll
        for (int j = 0; j < 4; ++j) d[k][j] = gather(img, ry, cx[j]);
      }
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int r = threadIdx.y + k * kRowThreads;
        if (r >= n_rows) break;
        float res[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // outside the embedded region or the frame the gather gives 0:
          // the background
          res[j] = normalize(clean(d[k][j], g, clamp), g, zero_one);
        }
        store4(dst + static_cast<int64_t>(row0 + r) * dw, u0, dw, res);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the crop on `stream`: the cv2-linear K2 when `linear`, else the
// nearest K1.  Returns the cudaError_t of the launch.  dpt (b, h, w), com
// (b, 3), cube (3 floats at stride cube_stride per sample), min_d and max_d
// (b,) (read only with fuse_clamp), out (b, dh, dw) and m (b, 3, 3) are
// contiguous float32 device buffers.  Requires b <= 65535 (the grid's y
// extent), dh, dw >= 1 and the index map of dw + kTileRows entries within
// kMaxSmem bytes.
int dp_normalized_crop(const float* dpt, const float* com, const float* cube,
                       int cube_stride, float fx, float fy, const float* min_d,
                       const float* max_d, float* out, float* m, int b, int h,
                       int w, int dh, int dw, int fuse_clamp,
                       int norm_zero_one, int linear, void* stream) {
  if (b == 0) return static_cast<int>(cudaSuccess);
  const size_t smem_bytes = static_cast<size_t>(dw + kTileRows) *
                            (linear ? sizeof(Taps) : sizeof(int));
  if (dh < 1 || dw < 1 || smem_bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((dh + kTileRows - 1) / kTileRows, b);
  const dim3 block(kQuadThreads, kRowThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (linear) {
    normalized_crop_kernel<true><<<grid, block, smem_bytes, s>>>(
        dpt, com, cube, cube_stride, fx, fy, min_d, max_d, out, m, h, w, dh,
        dw, fuse_clamp, norm_zero_one);
  } else {
    normalized_crop_kernel<false><<<grid, block, smem_bytes, s>>>(
        dpt, com, cube, cube_stride, fx, fy, min_d, max_d, out, m, h, w, dh,
        dw, fuse_clamp, norm_zero_one);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
