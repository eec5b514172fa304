// The weight gradient of a dense, stride-1, 'same'-padded Conv3d with few
// channels (K10): V2V-PoseNet's fourteen convolutions at 44^3.
//
// For x (n, cin, d, h, w), dy (n, cout, d, h, w) and k^3 taps (k = 1 or 3,
// padding (k - 1) / 2) the weight gradient is
//   dW[o, i, t] = sum over samples and voxels q of dy[o, q] x[i, q + t - pad]
// with x zero outside the grid: an implicit GEMM of M = cout, N = cin k^3
// (at most 864) and K = n d h w (681,472 at V2V's B = 8 and 44^3).  dW has at
// most 27,648 values, so one block keeps all of it in registers and the
// parallelism comes from K.
//
// Replaces no Pallas kernel.  The JAX package has no V2V-PoseNet; this takes
// the place of cuDNN's weight gradients of those layers, which ran at 0.3-6%
// of the card's float32 peak.
//
// Design:
//   1. conv3d_wgrad_partial: a persistent grid of `blocks` blocks of 512
//      threads (3^3) or 256 (1^3).  The volume is cut into columns of 4
//      output rows (h) by up to 48 output columns (w) of one sample, and
//      each column into segments along d (the host picks the segment
//      length that balances the units over the blocks); block b takes
//      units b, b + blocks, ... in order.  A block walks its unit's planes along d: it stages dy's
//      plane (cout x 4 x 48) and x's plane with a one-voxel halo (cin x 6 x
//      50 for 3^3) in shared memory with cp.async, one plane ahead and
//      coalesced along w, in a ring of k + 1 x planes and two dy planes.
//      Each thread owns a fixed tile of dW: 2 output channels x 1 input
//      channel x 27 taps for 3^3 (54 sums), 8 x 4 x 1 for 1^3 (32); the
//      channels of a 32-channel layer fill the block, and a layer with
//      fewer splits the plane's voxels between groups of threads.  A thread
//      takes a chunk of 4 consecutive voxels along w in all 4 rows (3^3; 1
//      row for 1^3) at a time: their dy for its output channels (one
//      16-byte load a channel and row), then for each of the k (k + 3) x
//      rows under the chunk's window the k + 3 values of that row, each row
//      serving every output row it reaches (3^3: 864 fmaf against 108 + 8
//      loads).  A warp shares its output channels (dy loads broadcast) and
//      holds 32 input channels (an odd shared-memory stride per channel, so
//      x loads hit 32 banks).
//      Input channels are padded to 16 or 32 with zeros and output channels
//      to 32 (no 3^3 layer of V2V has fewer), the tile's ragged edges
//      (44 is no multiple of 8) with zeros in dy and x.  At the end the
//      block sums its thread groups in order and writes its own row of
//      `partial`.
//   2. conv3d_wgrad_reduce: sums each weight's rows of `partial` in a
//      fixed order (8 interleaved runs of rows, then the 8 in order) and
//      writes dW in dy's type.
// No atomics, no allocation, no host sync: the result is the same from run
// to run for given shapes and `blocks`.  Every product is a float32 fmaf on
// the CUDA cores: no TF32, no tensor cores, no rounding of float32 inputs.
// bfloat16 inputs are widened to float32 as they are staged (synchronous
// loads: the benchmark's control path only) and summed in float32.
//
// What bounds it: for 3^3, operations (2 x 32 x 864 x 681,472 = 37.7 GFLOP
// for a 32 -> 32 layer, 0.56 ms at 67 TFLOP/s; x and dy are 87 MB each,
// 0.05 ms at 3.35 TB/s); for 1^3, bytes (x and dy read once, 125-174 MB,
// against 0.6-1.4 GFLOP).  Measured on one H100 at V2V's shapes: 50% of the
// float32 peak for a 3^3 32 -> 32 layer, the SM clock at its 1,980 MHz.
// With 4 output channels a thread and 256 threads of 254 registers it ran at
// 44% though its inner loop was 92% fmaf: two warps a scheduler hid too
// little latency.  1^3 runs at 17-24% of its byte bound: the 4-byte staging
// copies' instructions, not the bytes, set its pace.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libconv3d_wgrad.so conv3d_wgrad.cu   (ops/_build.py
//        does this)

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kRows = 4;        // output rows (h) of a column
constexpr int kMaxTileW = 48;   // output columns (w) of a column, at most
constexpr int kChunk = 4;       // voxels along w a thread takes at a time
constexpr int kDyRow = kMaxTileW;            // dy's row stride in shared memory
constexpr int kDyCout = kRows * kDyRow + 4;  // 196: 16-byte aligned, 4 banks apart
constexpr int kMaxChannels = 32;
constexpr int kReduceThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The shapes of one instantiation: k^3 taps, CI input channels (16 or 32)
// and CO = 32 output channels, the layer's padded up with zeros.
template <int K, int CI>
struct Shape {
  static constexpr int CO = kMaxChannels;
  static constexpr int kHalo = (K - 1) / 2;
  static constexpr int kTaps = K * K * K;
  static constexpr int kXRows = kRows + 2 * kHalo;
  static constexpr int kXW = kMaxTileW + 2 * kHalo;   // x's row stride
  static constexpr int kXCin = kXRows * kXW + 1;      // odd: 32 channels, 32 banks
  static constexpr int kXSlots = K + 1;               // planes d - halo .. d + halo, and one ahead
  static constexpr int kTC = K == 3 ? 2 : 8;          // output channels a thread
  static constexpr int kTI = K == 3 ? 1 : 4;          // input channels a thread
  static constexpr int kTR = K == 3 ? kRows : 1;      // output rows a chunk
  static constexpr int kThreads = K == 3 ? 512 : 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kInGroups = CI / kTI;
  static constexpr int kOutGroups = CO / kTC;
  static constexpr int kSplit = kThreads / (kInGroups * kOutGroups);  // groups over voxels
  static constexpr int kWeights = CO * CI * kTaps;    // a partial row
  static constexpr int kXFloats = kXSlots * CI * kXCin;
  static constexpr int kDyFloats = 2 * CO * kDyCout;
  static constexpr int kBufFloats = kXFloats + kDyFloats;
  static constexpr int kSmemFloats =
      kBufFloats > kSplit * kWeights ? kBufFloats : kSplit * kWeights;
  static constexpr int kBlocksPerSM = K == 3 ? 1 : 2;
  static_assert(kSplit >= 1 && kInGroups * kOutGroups * kSplit == kThreads, "tile");
  static_assert(kRows % kTR == 0, "a column's rows in whole chunks");
};

// One block's unit of work: sample, the column's first row and column, its
// width, and the segment's planes [d0, d1).
struct Unit {
  int sample, h0, w0, tw, d0, d1;
};

struct Geometry {
  int n, cin, cout, d, h, w;
  int nh, nw, tw;       // columns: ceil(h / 4) x nw tiles of up to tw voxels along w
  int seg, segs;        // planes a segment, segments a column
  int64_t units;
};

__device__ __forceinline__ Unit unit_of(const Geometry& g, int64_t u) {
  Unit t;
  const int seg = static_cast<int>(u % g.segs);
  int64_t col = u / g.segs;
  const int wi = static_cast<int>(col % g.nw);
  col /= g.nw;
  const int hi = static_cast<int>(col % g.nh);
  t.sample = static_cast<int>(col / g.nh);
  t.h0 = hi * kRows;
  t.w0 = wi * g.tw;
  t.tw = min(g.tw, g.w - t.w0);
  t.d0 = seg * g.seg;
  t.d1 = min(g.d, t.d0 + g.seg);
  return t;
}

// Stage x's plane p of the unit (zeros outside the volume and above the
// layer's channels) into `dst`, one (channel, row) pair a warp at a time.
template <int K, int CI, typename T>
__device__ __forceinline__ void stage_x(float* dst, const T* x, const Geometry& g,
                                        const Unit& t, int p, int rows, int cols) {
  using S = Shape<K, CI>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t hw = static_cast<int64_t>(g.h) * g.w;
  const bool plane = p >= 0 && p < g.d;
  for (int pair = warp; pair < CI * rows; pair += S::kWarps) {
    const int ci = pair / rows, rr = pair % rows;
    const int hh = t.h0 + rr - S::kHalo;
    const bool row = plane && ci < g.cin && hh >= 0 && hh < g.h;
    const T* src = x + ((static_cast<int64_t>(t.sample) * g.cin + ci) * g.d + p) * hw +
                   static_cast<int64_t>(hh) * g.w;
    float* out = dst + ci * S::kXCin + rr * S::kXW;
    for (int cc = lane; cc < cols; cc += 32) {
      const int ww = t.w0 + cc - S::kHalo;
      if (row && ww >= 0 && ww < g.w) {
        if constexpr (sizeof(T) == 4) {
          __pipeline_memcpy_async(out + cc, src + ww, 4);
        } else {
          out[cc] = to_float(src[ww]);
        }
      } else {
        out[cc] = 0.0f;
      }
    }
  }
}

// Stage dy's plane p of the unit (zeros past the column's rows and width and
// above the layer's channels) into `dst`.
template <int K, int CI, typename T>
__device__ __forceinline__ void stage_dy(float* dst, const T* dy, const Geometry& g,
                                         const Unit& t, int p, int rows, int cols) {
  constexpr int CO = kMaxChannels;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t hw = static_cast<int64_t>(g.h) * g.w;
  for (int pair = warp; pair < CO * rows; pair += Shape<K, CI>::kWarps) {
    const int co = pair / rows, r = pair % rows;
    const bool row = co < g.cout && t.h0 + r < g.h;
    const T* src = dy + ((static_cast<int64_t>(t.sample) * g.cout + co) * g.d + p) * hw +
                   static_cast<int64_t>(t.h0 + r) * g.w + t.w0;
    float* out = dst + co * kDyCout + r * kDyRow;
    for (int c = lane; c < cols; c += 32) {
      if (row && c < t.tw) {
        if constexpr (sizeof(T) == 4) {
          __pipeline_memcpy_async(out + c, src + c, 4);
        } else {
          out[c] = to_float(src[c]);
        }
      } else {
        out[c] = 0.0f;
      }
    }
  }
}

template <int K, int CI, typename T>
__global__ void __launch_bounds__((Shape<K, CI>::kThreads), (Shape<K, CI>::kBlocksPerSM))
    conv3d_wgrad_partial(const T* __restrict__ x, const T* __restrict__ dy,
                         float* __restrict__ partial, Geometry g) {
  using S = Shape<K, CI>;
  constexpr int CO = S::CO, TC = S::kTC, TI = S::kTI, TR = S::kTR, H = S::kHalo;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* dys = smem + S::kXFloats;
  const int tid = threadIdx.x;
  const int ig = tid % S::kInGroups;
  const int cg = tid / S::kInGroups % S::kOutGroups;
  const int vg = tid / (S::kInGroups * S::kOutGroups);

  float acc[TC][TI][S::kTaps];
#pragma unroll
  for (int c = 0; c < TC; ++c)
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int k = 0; k < S::kTaps; ++k) acc[c][i][k] = 0.0f;

  for (int64_t u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit t = unit_of(g, u);
    // rows staged: the column's rows inside the volume, rounded up to TR
    // (dy zero past the volume)
    const int rows = (min(kRows, g.h - t.h0) + TR - 1) / TR * TR;
    const int per_row = (t.tw + kChunk - 1) / kChunk;
    const int cols = per_row * kChunk;
    const int chunks = rows / TR * per_row;
    // the first planes: x at d0 - halo .. d0 + halo, dy at d0
    for (int p = t.d0 - H; p <= t.d0 + H; ++p) {
      stage_x<K, CI>(xs + ((p + S::kXSlots) % S::kXSlots) * CI * S::kXCin, x, g, t, p,
                     rows + 2 * H, cols + 2 * H);
    }
    stage_dy<K, CI>(dys + (t.d0 & 1) * CO * kDyCout, dy, g, t, t.d0, rows, cols);
    __pipeline_commit();
    for (int d = t.d0; d < t.d1; ++d) {
      const bool ahead = d + 1 < t.d1;
      if (ahead) {  // the next plane's x (one further for the halo) and dy
        const int p = d + 1 + H;
        stage_x<K, CI>(xs + ((p + S::kXSlots) % S::kXSlots) * CI * S::kXCin, x, g, t, p,
                       rows + 2 * H, cols + 2 * H);
        stage_dy<K, CI>(dys + ((d + 1) & 1) * CO * kDyCout, dy, g, t, d + 1, rows, cols);
        __pipeline_commit();
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const float* xp[K];
#pragma unroll
      for (int kd = 0; kd < K; ++kd) {
        xp[kd] = xs + ((d - H + kd + S::kXSlots) % S::kXSlots) * CI * S::kXCin +
                 ig * TI * S::kXCin;
      }
      const float* dp = dys + (d & 1) * CO * kDyCout + cg * TC * kDyCout;
      // chunk j = vg, vg + kSplit, ...: rows r .. r + TR - 1, first column c0
      int r = vg / per_row * TR, c0 = (vg % per_row) * kChunk;
      for (int j = vg; j < chunks; j += S::kSplit) {
        float dv[TC][TR][kChunk];
#pragma unroll
        for (int c = 0; c < TC; ++c) {
#pragma unroll
          for (int tr = 0; tr < TR; ++tr) {
            const float4 v =
                *reinterpret_cast<const float4*>(dp + c * kDyCout + (r + tr) * kDyRow + c0);
            dv[c][tr][0] = v.x;
            dv[c][tr][1] = v.y;
            dv[c][tr][2] = v.z;
            dv[c][tr][3] = v.w;
          }
        }
#pragma unroll
        for (int i = 0; i < TI; ++i) {
#pragma unroll
          for (int kd = 0; kd < K; ++kd) {
            // x row r + xr serves output row r + tr at kh = xr - tr
#pragma unroll
            for (int xr = 0; xr < K + TR - 1; ++xr) {
              const float* row = xp[kd] + i * S::kXCin + (r + xr) * S::kXW + c0;
              float xv[kChunk + K - 1];
#pragma unroll
              for (int e = 0; e < kChunk + K - 1; ++e) xv[e] = row[e];
#pragma unroll
              for (int tr = 0; tr < TR; ++tr) {
                const int kh = xr - tr;
                if (kh < 0 || kh >= K) continue;
#pragma unroll
                for (int kw = 0; kw < K; ++kw)
#pragma unroll
                  for (int q = 0; q < kChunk; ++q)
#pragma unroll
                    for (int c = 0; c < TC; ++c)
                      acc[c][i][(kd * K + kh) * K + kw] = fmaf(
                          dv[c][tr][q], xv[q + kw], acc[c][i][(kd * K + kh) * K + kw]);
              }
            }
          }
        }
        c0 += S::kSplit * kChunk;
        while (c0 >= cols) {
          c0 -= cols;
          r += TR;
        }
      }
      __syncthreads();  // the next step overwrites the oldest planes
    }
  }

  // the block's row of partial sums: its voxel groups summed in order
  float* out = partial + static_cast<int64_t>(blockIdx.x) * S::kWeights;
  float* red = smem;
  if constexpr (S::kSplit == 1) {
#pragma unroll
    for (int c = 0; c < TC; ++c)
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int k = 0; k < S::kTaps; ++k)
          out[((cg * TC + c) * CI + ig * TI + i) * S::kTaps + k] = acc[c][i][k];
  } else {
#pragma unroll
    for (int c = 0; c < TC; ++c)
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int k = 0; k < S::kTaps; ++k)
          red[vg * S::kWeights + ((cg * TC + c) * CI + ig * TI + i) * S::kTaps + k] =
              acc[c][i][k];
    __syncthreads();
    for (int e = tid; e < S::kWeights; e += S::kThreads) {
      float s = 0.0f;
      for (int v = 0; v < S::kSplit; ++v) s += red[v * S::kWeights + e];
      out[e] = s;
    }
  }
}

// dW (cout, cin, k^3) in T from the rows of `partial` (padded to CI input
// and 32 output channels): a block takes 32 consecutive weights, a lane
// each, and its warp w the rows w, w + 8, ... in order; the 8 warps' sums
// are then added in warp order.
template <int K, int CI, typename T>
__global__ void __launch_bounds__(kReduceThreads)
    conv3d_wgrad_reduce(const float* __restrict__ partial, int blocks, int cin, int cout,
                        T* __restrict__ out) {
  constexpr int kTaps = K * K * K;
  constexpr int kGroups = kReduceThreads / 32;
  __shared__ float sums[kGroups][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  const bool real = e < cout * cin * kTaps;
  float s = 0.0f;
  if (real) {
    const int tap = e % kTaps, i = e / kTaps % cin, o = e / kTaps / cin;
    const float* p = partial + (o * CI + i) * kTaps + tap;
#pragma unroll 4
    for (int b = warp; b < blocks; b += kGroups) {
      s += p[static_cast<int64_t>(b) * Shape<K, CI>::kWeights];
    }
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && real) {
    float t = sums[0][lane];
#pragma unroll
    for (int v = 1; v < kGroups; ++v) t += sums[v][lane];
    out[e] = from_float<T>(t);
  }
}

// Above 48 KB a kernel must opt in to its dynamic shared memory, per device
// (as warp.cu's kernels do); each instantiation opts in once per device (two
// threads racing here at worst both set the attribute).
template <auto kKernel>
cudaError_t opt_in_smem(size_t smem) {
  static std::atomic<bool> granted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && granted[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev].store(true);
  return err;
}

// The segment length along d that finishes the units soonest: rounds of
// `blocks` units, each its planes and about half its first planes' loads.
void plan(Geometry& g, int k, int blocks) {
  const int64_t columns = static_cast<int64_t>(g.n) * g.nh * g.nw;
  int64_t best = -1;
  for (int s = 1; s <= g.d; ++s) {
    const int seg = (g.d + s - 1) / s;
    if ((g.d + seg - 1) / seg != s) continue;  // the same segments as a smaller s
    const int64_t units = columns * s;
    const int64_t cost = (units + blocks - 1) / blocks * (2 * seg + k);
    if (best < 0 || cost < best) {
      best = cost;
      g.seg = seg;
      g.segs = s;
      g.units = units;
    }
  }
}

template <int K, int CI, typename T>
cudaError_t launch(const T* x, const T* dy, float* partial, T* out, int blocks, Geometry g,
                   cudaStream_t s) {
  using S = Shape<K, CI>;
  constexpr auto kPartial = conv3d_wgrad_partial<K, CI, T>;
  const size_t smem = S::kSmemFloats * sizeof(float);
  cudaError_t err = opt_in_smem<kPartial>(smem);
  if (err != cudaSuccess) return err;
  kPartial<<<blocks, S::kThreads, smem, s>>>(x, dy, partial, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int weights = g.cout * g.cin * S::kTaps;
  conv3d_wgrad_reduce<K, CI, T><<<(weights + 31) / 32, kReduceThreads, 0, s>>>(
      partial, blocks, g.cin, g.cout, out);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t dispatch(const void* x, const void* dy, void* partial, void* out, int blocks,
                     const Geometry& g, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dy);
  float* p = static_cast<float*>(partial);
  T* o = static_cast<T*>(out);
  if (g.cin > 16) return launch<K, 32>(xt, dt, p, o, blocks, g, s);
  return launch<K, 16>(xt, dt, p, o, blocks, g, s);
}

}  // namespace

extern "C" {

// The weight gradient on `stream`: out (cout, cin, k, k, k) = the sum over
// samples and voxels q of dy[:, o, q] x[:, i, q + t - (k - 1) / 2], x zero
// outside the volume.  x (n, cin, d, h, w) and dy (n, cout, d, h, w) are
// contiguous device buffers of one type, float32 (elem_bytes 4) or bfloat16
// (2); out has their type.  k is 1 or 3, cin and cout 1 to 32, every size
// at least 1.  partial is a float32 scratch buffer of blocks x row values,
// row = 32 x cin' x k^3, cin' the input channels padded to 16 or 32;
// blocks (at least 1) is the persistent grid and fixes the order of the
// sums.  Returns the cudaError_t of the two launches.
int dp_conv3d_wgrad(const void* x, const void* dy, void* partial, void* out, int elem_bytes,
                    int blocks, int row, int n, int cin, int cout, int k, int d, int h, int w,
                    void* stream) {
  if ((k != 1 && k != 3) || cin < 1 || cin > kMaxChannels || cout < 1 ||
      cout > kMaxChannels || n < 1 || d < 1 || h < 1 || w < 1 || blocks < 1 ||
      row != kMaxChannels * (cin > 16 ? 32 : 16) * k * k * k ||
      static_cast<int64_t>(kMaxChannels) * d * h * w > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g{};
  g.n = n;
  g.cin = cin;
  g.cout = cout;
  g.d = d;
  g.h = h;
  g.w = w;
  g.nh = (h + kRows - 1) / kRows;
  // tiles of equal width along w, a multiple of 4 and at most 48, none empty
  const int tiles = (w + kMaxTileW - 1) / kMaxTileW;
  g.tw = ((w + tiles - 1) / tiles + kChunk - 1) / kChunk * kChunk;
  g.nw = (w + g.tw - 1) / g.tw;
  plan(g, k, blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (elem_bytes == 4) {
    err = k == 3 ? dispatch<3, float>(x, dy, partial, out, blocks, g, s)
                 : dispatch<1, float>(x, dy, partial, out, blocks, g, s);
  } else if (elem_bytes == 2) {
    err = k == 3 ? dispatch<3, __nv_bfloat16>(x, dy, partial, out, blocks, g, s)
                 : dispatch<1, __nv_bfloat16>(x, dy, partial, out, blocks, g, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
