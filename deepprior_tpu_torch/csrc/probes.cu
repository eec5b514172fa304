// Measurement probes of the crop's and the warp's parts: the band read
// (K6a-c) and the general nearest warp without shared-memory staging (K7).
//
// K6 replaces the TPU probes in prof_bench.py: run_trivial (:28), run_mm
// (:56) and run_mm_def (:79).  Each DMAs a (band_h, band_w) band of a
// sample's frame at scalar-prefetched offsets into VMEM, then copies the
// band's (128, 128) corner out (K6a), or selects band[64, 32] with two
// one-hot matmuls at HIGHEST (K6b, exact) or DEFAULT precision (K6c, one
// bf16 pass on a TPU) into every output pixel.  On the TPU the band DMA is
// how K1's banded-window design feeds its one-hot selection, and the probes
// time it.  On Hopper a gather is a direct load and needs no band, so these
// kernels compute the probes' function and read nothing more: one block of
// 256 threads per (sample, quarter of the 128x128 output).  K6a copies the
// corner with 16-byte loads and stores, 4 vectors a thread, neighbouring
// threads on neighbouring vectors of a row (the offsets' columns are
// multiples of 128 and W of 4, so every access is aligned); no shared
// memory and no staging.  K6b and K6c load the one selected pixel once per
// block (K6c rounds it with __float2bfloat16_rn), then write the sample's
// quarter as 16-byte stores.  The selection is a direct load, exact by
// construction: no matmul.
// What bounds them: bytes.  K6a reads and writes 64 KB a sample (67 MB at
// B = 512); K6b and K6c only write, 64 KB a sample.  On an H100 they run
// at about 80% (K6a) and 99% (K6b, K6c) of that bound (PERF.md).  The
// whole 304x512 band, 622 KB a sample, is what the TPU probe moves; an
// earlier version of this kernel staged it, at 0.117 ms for B = 512.
//
// K7 replaces the TPU probe prof_warp_bf16.py::make(variant).warp (:63): a
// general nearest warp whose selection the TPU writes as one-hot matmuls in
// float32 at HIGHEST ('f32') or as three manual bf16 passes ('split').  Here
// each block takes a 32x32 tile of one sample's output, and each thread 4
// consecutive pixels of one row: the source coordinate ((i00*u) + (i01*v)) +
// i02 in _rn intrinsics (no FMA contraction), floor(x + 0.5), the bounds
// test and one load straight from global memory, 0 outside, then one
// 16-byte store.  A warp covers 16x8 output pixels and the block 32x32, so
// under any rotation a warp's loads fall on a few source rows and the
// block's on a footprint of about 46x46 pixels that stays in L1; the
// indices come from bit operations, with no division per pixel.  'split'
// rebuilds the value from its three bf16 parts a1 = bf16(v), a2 = bf16(v -
// a1), a3 = bf16(v - a1 - a2) as (a1 + a2) + a3, the sum of the three
// passes; on values whose mantissa fits 24 bits in three bf16 parts that is
// the value itself.
// What bounds it: bytes, the sampled source pixels and the output, and the
// latency of the scattered loads.  K4 (csrc/warp.cu) computes the same map
// but stages the whole patch in shared memory first; K7 stays the arm that
// stages nothing, so K7 beside K4 says what staging buys on this card.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobes.so probes.cu   (ops/_build.py does this)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBandThreads = 256;
constexpr int kCorner = 128;     // the (kCorner, kCorner) output per sample
constexpr int kSelRow = 64;      // K6b/K6c select band[kSelRow, kSelCol]
constexpr int kSelCol = 32;
constexpr int kRowVecs = kCorner / 4;   // 16-byte vectors per output row
constexpr int kVecsPerThread = 4;
constexpr int kBlockVecs = kBandThreads * kVecsPerThread;
constexpr int kBlocksPerSample = kCorner * kRowVecs / kBlockVecs;
constexpr int kTile = 32;  // K7: a block's (kTile, kTile) output pixels
constexpr int kWarpThreads = kTile / 4 * kTile;  // one thread a 4-pixel quad

enum Body { kTrivial = 0, kSelect = 1, kSelectBf16 = 2 };
enum Constant { kConstCorner, kConstSelRow, kConstSelCol };

// grid (kBlocksPerSample, b).  offsets (b, 2) int32: the band's first row
// and column, with the band inside the frame (the wrapper checks it).
template <int kBody>
__global__ void __launch_bounds__(kBandThreads)
band_kernel(const float* __restrict__ dpt, const int* __restrict__ offsets,
            float* __restrict__ out, int h, int w) {
  const int b = blockIdx.y;
  const int r_off = offsets[2 * b], c_off = offsets[2 * b + 1];
  const float* img = dpt + static_cast<int64_t>(b) * h * w;
  float4* dst = reinterpret_cast<float4*>(out + static_cast<int64_t>(b) *
                                                    kCorner * kCorner);
  const int first = blockIdx.x * kBlockVecs + threadIdx.x;
  if (kBody == kTrivial) {
    // all loads first, so that each thread has kVecsPerThread in flight
    float4 v[kVecsPerThread];
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const int i = first + k * kBandThreads;
      const int r = i / kRowVecs, c = i - r * kRowVecs;
      v[k] = __ldg(reinterpret_cast<const float4*>(
                       img + static_cast<int64_t>(r_off + r) * w + c_off) + c);
    }
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) dst[first + k * kBandThreads] = v[k];
  } else {
    __shared__ float sel;
    if (threadIdx.x == 0) {
      float v = __ldg(img + static_cast<int64_t>(r_off + kSelRow) * w + c_off +
                      kSelCol);
      if (kBody == kSelectBf16) v = __bfloat162float(__float2bfloat16_rn(v));
      sel = v;
    }
    __syncthreads();
    const float4 v4 = make_float4(sel, sel, sel, sel);
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) dst[first + k * kBandThreads] = v4;
  }
}

__device__ __forceinline__ float bf16_part(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// grid (ceil(w / kTile), ceil(h / kTile), b).  params (b, 6): the inverse
// transform's top two rows (ops/hopper_warp.py PATCH_PARAMS order).
template <bool kSplit>
__global__ void __launch_bounds__(kWarpThreads)
warp_general_kernel(const float* __restrict__ src,
                    const float* __restrict__ params,
                    float* __restrict__ out, int h, int w) {
  // lane -> 4 quads x 8 rows of a warp, warp -> 2 x 4 warps of the tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int u0 = blockIdx.x * kTile + 4 * (((warp & 1) << 2) | (lane & 3));
  const int v = blockIdx.y * kTile + (((warp >> 1) << 3) | (lane >> 2));
  if (u0 >= w || v >= h) return;
  const int b = blockIdx.z;
  const float* prm = params + static_cast<int64_t>(b) * 6;
  const float* img = src + static_cast<int64_t>(b) * h * w;
  const float fv = static_cast<float>(v);
  const float x0 = __fmul_rn(prm[1], fv), y0 = __fmul_rn(prm[4], fv);
  float res[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    res[j] = 0.0f;
    if (u0 + j >= w) continue;
    const float u = static_cast<float>(u0 + j);
    const float x = __fadd_rn(__fadd_rn(__fmul_rn(prm[0], u), x0), prm[2]);
    const float y = __fadd_rn(__fadd_rn(__fmul_rn(prm[3], u), y0), prm[5]);
    const float p = floorf(__fadd_rn(x, 0.5f));
    const float q = floorf(__fadd_rn(y, 0.5f));
    if (p >= 0.0f && p < static_cast<float>(w) && q >= 0.0f &&
        q < static_cast<float>(h)) {
      float val = __ldg(img + static_cast<int>(q) * w + static_cast<int>(p));
      if (kSplit) {
        const float a1 = bf16_part(val);
        const float r1 = __fsub_rn(val, a1);
        const float a2 = bf16_part(r1);
        const float a3 = bf16_part(__fsub_rn(r1, a2));
        val = __fadd_rn(__fadd_rn(a1, a2), a3);
      }
      res[j] = val;
    }
  }
  float* row = out + static_cast<int64_t>(b) * h * w + static_cast<int64_t>(v) * w;
  if ((w & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    *reinterpret_cast<float4*>(row + u0) = make_float4(res[0], res[1], res[2], res[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (u0 + j < w) row[u0 + j] = res[j];
    }
  }
}

}  // namespace

extern "C" {

// K6a (body 0), K6b (1) or K6c (2) on `stream`; returns the cudaError_t of
// the launch.  dpt (b, h, w) float32, offsets (b, 2) int32, out (b,
// kCorner, kCorner) float32, all contiguous device buffers, dpt 16-byte
// aligned.  The band (band_h, band_w) at each sample's offsets lies inside
// the frame; the function is defined on it, so it must hold the corner:
// band_h >= kCorner and band_w >= kCorner.  Requires w % 4 == 0, offsets'
// columns multiples of 4 and b <= 65535.
int dp_band_probe(const float* dpt, const int* offsets, float* out, int b,
                  int h, int w, int band_h, int band_w, int body,
                  void* stream) {
  if (b == 0) return static_cast<int>(cudaSuccess);
  if (band_h < kCorner || band_w < kCorner || band_h > h || band_w > w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(kBlocksPerSample, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kTrivial:
      band_kernel<kTrivial><<<grid, kBandThreads, 0, s>>>(dpt, offsets, out, h, w);
      break;
    case kSelect:
      band_kernel<kSelect><<<grid, kBandThreads, 0, s>>>(dpt, offsets, out, h, w);
      break;
    case kSelectBf16:
      band_kernel<kSelectBf16><<<grid, kBandThreads, 0, s>>>(dpt, offsets, out, h, w);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7 on `stream`, 'split' when `split`; returns the cudaError_t of the
// launch.  src and out (b, h, w) float32, params (b, 6) float32, all
// contiguous device buffers; b <= 65535.
int dp_warp_general(const float* src, const float* params, float* out, int b,
                    int h, int w, int split, void* stream) {
  if (b == 0 || h * w == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split) {
    warp_general_kernel<true><<<grid, kWarpThreads, 0, s>>>(src, params, out, h, w);
  } else {
    warp_general_kernel<false><<<grid, kWarpThreads, 0, s>>>(src, params, out, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

// the compile-time constants the wrapper checks its own against
int dp_constant(int which) {
  switch (which) {
    case kConstCorner: return kCorner;
    case kConstSelRow: return kSelRow;
    case kConstSelCol: return kSelCol;
    default: return -1;
  }
}

const char* dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
