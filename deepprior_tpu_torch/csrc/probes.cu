// Measurement probes of the crop's and the warp's parts: the band read
// (K6a-c) and the general nearest warp without shared-memory staging (K7).
//
// K6 replaces the TPU probes in prof_bench.py: run_trivial (:28), run_mm
// (:56) and run_mm_def (:79).  Each DMAs a (band_h, band_w) band of a
// sample's frame at scalar-prefetched offsets into VMEM, then copies the
// band's (128, 128) corner out (K6a), or selects band[64, 32] with two
// one-hot matmuls at HIGHEST (K6b, exact) or DEFAULT precision (K6c, one
// bf16 pass on a TPU) into every output pixel.  On the TPU they measure what
// K1's banded-window design pays for its DMA.  Here one block per (sample,
// 16-row band tile) stages its tile into shared memory with 16-byte
// cp.async copies, coalesced along the row; the copies are asm volatile, so
// the compiler cannot drop the read whatever the body uses.  The blocks
// whose tile holds the corner's rows write them (K6a); the block whose tile
// holds row 64 writes the selected value into all of the sample's output
// (K6b; K6c rounds it with __float2bfloat16_rn first).  The selection is a
// direct load, exact by construction: no matmul.
// What bounds them: bytes.  The band is 622 KB a sample (319 MB at B = 512),
// against 64 KB a sample that the function needs; the probe is the measured
// floor of a crop that reads whole bands, beside K1, which reads only its
// taps.
//
// K7 replaces the TPU probe prof_warp_bf16.py::make(variant).warp (:63): a
// general nearest warp whose selection the TPU writes as one-hot matmuls in
// float32 at HIGHEST ('f32') or as three manual bf16 passes ('split').  Here
// it is one thread per output pixel: the source coordinate
// ((i00*u) + (i01*v)) + i02 in _rn intrinsics (no FMA contraction), then
// floor(x + 0.5), the bounds test and one load straight from global memory,
// 0 outside.  'split' rebuilds the value from its three bf16 parts
// a1 = bf16(v), a2 = bf16(v - a1), a3 = bf16(v - a1 - a2) as
// (a1 + a2) + a3, the sum of the three passes; on values whose mantissa
// fits 24 bits in three bf16 parts that is the value itself.
// What bounds it: bytes, the sampled source pixels and the output, and
// the latency of the scattered loads.  K4 (csrc/warp.cu) computes the same
// map but stages the whole patch in shared memory first; K7 beside K4 says
// what staging buys on this card.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobes.so probes.cu   (ops/_build.py does this)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBandThreads = 256;
constexpr int kTileRows = 16;    // band rows staged per block
constexpr int kCorner = 128;     // the (kCorner, kCorner) output per sample
constexpr int kSelRow = 64;      // K6b/K6c select band[kSelRow, kSelCol]
constexpr int kSelCol = 32;
constexpr int kWarpThreads = 256;

enum Body { kTrivial = 0, kSelect = 1, kSelectBf16 = 2 };
enum Constant { kConstCorner, kConstSelRow, kConstSelCol, kConstTileRows };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// grid (ceil(band_h / kTileRows), b); dynamic shared memory kTileRows *
// band_w floats.  offsets (b, 2) int32: the band's first row and column.
template <int kBody>
__global__ void __launch_bounds__(kBandThreads)
band_kernel(const float* __restrict__ dpt, const int* __restrict__ offsets,
            float* __restrict__ out, int h, int w, int band_h, int band_w) {
  extern __shared__ __align__(16) float tile[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, band_h - row0);
  const int r_off = offsets[2 * b], c_off = offsets[2 * b + 1];
  const float* img = dpt + static_cast<int64_t>(b) * h * w;
  const int vecs = band_w / 4;  // 16-byte vectors per band row

  // stage this tile of the band; parts outside the frame read as 0, so a
  // band that leaves the frame reads nothing out of bounds
  for (int i = threadIdx.x; i < rows * vecs; i += kBandThreads) {
    const int r = i / vecs, c = 4 * (i - r * vecs);
    const int fr = r_off + row0 + r, fc = c_off + c;
    float* dst = tile + r * band_w + c;
    if (fr >= 0 && fr < h && fc >= 0 && fc + 4 <= w) {
      cp_async16(dst, img + static_cast<int64_t>(fr) * w + fc);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  float4* dst = reinterpret_cast<float4*>(out + static_cast<int64_t>(b) *
                                                    kCorner * kCorner);
  constexpr int kRowVecs = kCorner / 4;
  if (kBody == kTrivial) {
    // the corner's rows that this tile holds
    const int last = min(rows, kCorner - row0);
    for (int i = threadIdx.x; i < last * kRowVecs; i += kBandThreads) {
      const int r = i / kRowVecs, c = i - r * kRowVecs;
      dst[(row0 + r) * kRowVecs + c] =
          reinterpret_cast<const float4*>(tile + r * band_w)[c];
    }
  } else {
    if (kSelRow < row0 || kSelRow >= row0 + rows) return;
    float v = tile[(kSelRow - row0) * band_w + kSelCol];
    if (kBody == kSelectBf16) v = __bfloat162float(__float2bfloat16_rn(v));
    const float4 v4 = make_float4(v, v, v, v);
    for (int i = threadIdx.x; i < kCorner * kRowVecs; i += kBandThreads) {
      dst[i] = v4;
    }
  }
}

__device__ __forceinline__ float bf16_part(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// grid (ceil(h * w / kWarpThreads), b).  params (b, 6): the inverse
// transform's top two rows (ops/hopper_warp.py PATCH_PARAMS order).
template <bool kSplit>
__global__ void __launch_bounds__(kWarpThreads)
warp_general_kernel(const float* __restrict__ src,
                    const float* __restrict__ params,
                    float* __restrict__ out, int h, int w) {
  const int b = blockIdx.y;
  const int n = h * w;
  const int pix = blockIdx.x * kWarpThreads + threadIdx.x;
  if (pix >= n) return;
  const float* prm = params + static_cast<int64_t>(b) * 6;
  const int iv = pix / w;
  const float u = static_cast<float>(pix - iv * w);
  const float v = static_cast<float>(iv);
  const float x = __fadd_rn(__fadd_rn(__fmul_rn(prm[0], u), __fmul_rn(prm[1], v)), prm[2]);
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(prm[3], u), __fmul_rn(prm[4], v)), prm[5]);
  const float p = floorf(__fadd_rn(x, 0.5f));
  const float q = floorf(__fadd_rn(y, 0.5f));
  float val = 0.0f;
  if (p >= 0.0f && p < static_cast<float>(w) && q >= 0.0f &&
      q < static_cast<float>(h)) {
    val = __ldg(src + static_cast<int64_t>(b) * n +
                static_cast<int64_t>(q) * w + static_cast<int64_t>(p));
    if (kSplit) {
      const float a1 = bf16_part(val);
      const float r1 = __fsub_rn(val, a1);
      const float a2 = bf16_part(r1);
      const float a3 = bf16_part(__fsub_rn(r1, a2));
      val = __fadd_rn(__fadd_rn(a1, a2), a3);
    }
  }
  out[static_cast<int64_t>(b) * n + pix] = val;
}

}  // namespace

extern "C" {

// K6a (body 0), K6b (1) or K6c (2) on `stream`; returns the cudaError_t of
// the launch.  dpt (b, h, w) float32, offsets (b, 2) int32, out (b,
// kCorner, kCorner) float32, all contiguous device buffers, dpt 16-byte
// aligned.  Requires w % 4 == 0, band_w % 4 == 0, band_h >= kCorner,
// band_w >= kCorner, kTileRows * band_w * 4 <= 48 KB and b <= 65535.
int dp_band_probe(const float* dpt, const int* offsets, float* out, int b,
                  int h, int w, int band_h, int band_w, int body,
                  void* stream) {
  if (b == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((band_h + kTileRows - 1) / kTileRows, b);
  const size_t smem = static_cast<size_t>(kTileRows) * band_w * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kTrivial:
      band_kernel<kTrivial><<<grid, kBandThreads, smem, s>>>(
          dpt, offsets, out, h, w, band_h, band_w);
      break;
    case kSelect:
      band_kernel<kSelect><<<grid, kBandThreads, smem, s>>>(
          dpt, offsets, out, h, w, band_h, band_w);
      break;
    case kSelectBf16:
      band_kernel<kSelectBf16><<<grid, kBandThreads, smem, s>>>(
          dpt, offsets, out, h, w, band_h, band_w);
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
  const dim3 grid((h * w + kWarpThreads - 1) / kWarpThreads, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split) {
    warp_general_kernel<true><<<grid, kWarpThreads, 0, s>>>(src, params, out, h, w);
  } else {
    warp_general_kernel<false><<<grid, kWarpThreads, 0, s>>>(src, params, out, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

// the compile-time constants the wrapper checks its own against
int dp_probe_constant(int which) {
  switch (which) {
    case kConstCorner: return kCorner;
    case kConstSelRow: return kSelRow;
    case kConstSelCol: return kSelCol;
    case kConstTileRows: return kTileRows;
    default: return -1;
  }
}

const char* dp_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
