// Per-sample affine patch warp (K4) and the fused augmentation warp (K5).
//
// Replaces the TPU kernels deepprior_tpu/ops/pallas_warp.py::
// pallas_warp_patch (_sep_warp_kernel / _warp_kernel, K4) and
// pallas_warp_norm (K5).  The Pallas kernels select source pixels with
// one-hot bf16x3 matmuls in row chunks, and split separable from general
// transforms, because the TPU has no vector gather.  On Hopper a gather
// from shared memory is one load, exact by construction, and a separable
// sample needs no branch: with i01 = i10 = 0 the general map adds exact
// zeros.
//
// K4 (warp_patch_kernel): one 512-thread block per sample stages the
// sample's patch in shared memory (64 KB at 128x128, so above the 48 KB
// default), then every thread gathers its output pixels from it.
//
// K5 (warp_norm_kernel) is augment_batch's whole image path in one launch:
// from the augmentation draws (mode, offset, angle, scale), the crop's com,
// cube and transform it computes each sample's geometry itself, then
// unnormalizes the patch (img * s_in + t_in), takes its maximum (premax),
// warps it with the NV mask, applies the recrop z-threshold (com/sc samples
// only), premax -> zend, 0 -> zend, the clip to [zstart, zend] and the
// renormalization (val - t_out) / s_out: nettrainer.py:948-997 in one read
// and one write of the patch batch.
//   Design: one block of 512 threads per sample.
//   1. Its threads stage the sample's (h, w) patch in shared memory with
//      asynchronous 16-byte copies (cp.async); while they are in flight,
//      thread 0 computes the sample's warp and normalization constants
//      (sample_params: ops/augment.py::augment_geometry ->
//      hopper_warp.warp_patch_params -> norm_params, op for op, with
//      geometry.cuh) and writes the per-sample fields the labels need.
//   2. The block takes the premax of the whole unnormalized patch.
//   3. It gathers the output from the staged patch in tiles 32 pixels wide
//      and 64 rows high, each thread 4 consecutive pixels with no division
//      per pixel (a warp covers 16x8 pixels), runs the epilogue and writes
//      them with one 16-byte store.
//   Rows whose width is not a multiple of 4, or unaligned buffers, take
//   4-byte copies and stores instead.
//
// What bounds them: bytes, the patch batch read once and written once (128
// KB per 128x128 sample; K4 only the source pixels its map reaches).  K4's
// one 512-thread block per sample leaves the staging latency exposed at a
// few hundred samples.  K5's prologue replaces the ~400 small launches that
// the geometry takes in eager PyTorch; its phases (copy and prologue,
// premax, then about 50 instructions a pixel of gather and epilogue) run
// one after the other in each block, so latency and issue, not bytes, set
// its time at B = 128.  Measured slower on an H100 (PERF.md): a cluster
// of blocks per sample sharing the patch, 256 or 1024 threads, two blocks
// per sample.
//
// Exactness: the source coordinate is ((i00*u) + (i01*v)) + i02 and the
// epilogue follows the plain version (ops/hopper_warp.py) op for op, with
// the _rn intrinsics so that nvcc contracts no multiply-add into an FMA.
// Like the Pallas kernel, and unlike the gather warp ops/crop.py::
// warp_patch, neither divides by the projective sz (an affine transform has
// sz = 1 up to an ulp).  The outputs equal the plain versions bit for bit.
// Build without --use_fast_math and without -prec-div=false.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwarp.so warp.cu   (ops/_build.py does this)

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "geometry.cuh"

namespace {

// NaN-propagating max, as torch.amax / jnp.max reduce
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// NYU's invalid-depth marker -> border
__device__ __forceinline__ float nv_mask(float val, float border, int use_nv,
                                         float nv_val, float nv_thresh) {
  return use_nv && fabsf(__fsub_rn(val, nv_val)) <= nv_thresh ? border : val;
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------
constexpr int kThreads = 512;

// one row of the (B, kNumPatchParams) float32 params per sample: the
// inverse transform's top two rows, in the order of
// deepprior_tpu_torch/ops/hopper_warp.py::PATCH_PARAMS
enum PatchParam { kI00, kI01, kI02, kI10, kI11, kI12, kNumPatchParams };

__global__ void __launch_bounds__(kThreads)
warp_patch_kernel(const float* __restrict__ src,
                  const float* __restrict__ params, float* __restrict__ out,
                  int h, int w, float border, int use_nv, float nv_val,
                  float nv_thresh) {
  extern __shared__ float tile[];  // the sample's (h, w) source patch
  const int b = blockIdx.x;
  const int n = h * w;
  const float* prm = params + static_cast<int64_t>(b) * kNumPatchParams;
  const float* img = src + static_cast<int64_t>(b) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) tile[i] = __ldg(img + i);
  __syncthreads();

  const float i00 = prm[kI00], i01 = prm[kI01], i02 = prm[kI02];
  const float i10 = prm[kI10], i11 = prm[kI11], i12 = prm[kI12];
  float* dst = out + static_cast<int64_t>(b) * n;
  for (int pix = threadIdx.x; pix < n; pix += kThreads) {
    const int iv = pix / w;
    const float u = static_cast<float>(pix - iv * w);
    const float v = static_cast<float>(iv);
    // inverse map to the source; nearest = floor(x + 0.5), cv2's rounding
    const float x = __fadd_rn(__fadd_rn(__fmul_rn(i00, u), __fmul_rn(i01, v)), i02);
    const float y = __fadd_rn(__fadd_rn(__fmul_rn(i10, u), __fmul_rn(i11, v)), i12);
    const float p = floorf(__fadd_rn(x, 0.5f));
    const float q = floorf(__fadd_rn(y, 0.5f));
    float val = border;
    if (p >= 0.0f && p < static_cast<float>(w) &&
        q >= 0.0f && q < static_cast<float>(h)) {
      val = tile[static_cast<int>(q) * w + static_cast<int>(p)];
    }
    dst[pix] = nv_mask(val, border, use_nv, nv_val, nv_thresh);
  }
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------
constexpr int kNormThreads = 512;
constexpr int kNormWarps = kNormThreads / 32;
constexpr int kTile = 32;  // the gather's tiles are kTile pixels wide
constexpr int kTileRows = kNormThreads / 8;  // and this many rows high
constexpr int kNumModes = 4;    // ops/augment.py::VALID_MODES
enum Mode { kNone, kCom, kRot, kSc };

// the augmentation draws (ops/augment.py::sample_augment_params) and the
// crops they act on, per sample: com (b, 3), the cube (3 floats at stride
// cube_stride: 0 for one cube), m (b, 3, 3)
struct Inputs {
  const int64_t* mode_idx;
  const float* off;
  const float* rot;
  const float* sc;
  const float* com;
  const float* cube;
  int cube_stride;
  const float* m;
};

// the camera, the frame's size and the slots of aug_modes that hold each
// of VALID_MODES (bit i of masks[k]: aug_modes[i] is mode k)
struct Frame {
  dp::Camera cam;
  int h, w;
  unsigned int masks[kNumModes];
  int norm_zero_one;
};

// the per-sample fields of augment_geometry that the labels read
struct SideOutputs {
  float* new_com;      // (b, 3)
  float* new_cube;     // (b, 3)
  float* m_out;        // (b, 3, 3)
  float* com3d;        // (b, 3)
  float* new_com3d_c;  // (b, 3)
  float* rot;          // (b,)
  bool* is_mode;       // (b, kNumModes)
};

// a sample's warp (the inverse transform's top two rows) and its
// normalization columns (hopper_warp.norm_params)
struct SampleParams {
  float i00, i01, i02, i10, i11, i12;
  float s_in, t_in, zs_t, ze_t, zstart2, zend2, t_out, s_out;
  int thresh;
};

// the head of a block's dynamic shared memory, then the sample's (h, w)
// patch at offset kHeadBytes
struct Shared {
  float warp_max[kNormWarps];
  SampleParams prm;
};
constexpr int kHeadBytes = (sizeof(Shared) + 15) / 16 * 16;

// The sample's constants from its draws, as ops/augment.py::
// augment_geometry (:201-268), hopper_warp.warp_patch_params and
// norm_params (:86-119) compute them on the card, op for op; it also
// writes the fields the labels need.
__device__ __forceinline__ SampleParams sample_params(int b, const Inputs& in,
                                                     const Frame& fr, int ph,
                                                     int pw,
                                                     const SideOutputs& so) {
  // every input first, unconditionally, so that the loads are in flight
  // together
  const int64_t mi = in.mode_idx[b];
  const float off_in[3] = {in.off[3 * b], in.off[3 * b + 1], in.off[3 * b + 2]};
  const float rot_in = in.rot[b], sc_in = in.sc[b];
  float com[3], cube[3], m[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    com[k] = in.com[3 * b + k];
    cube[k] = in.cube[in.cube_stride * b + k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = in.m[9 * b + k];
  // the mode masks and the draws of the modes not drawn zeroed
  bool is[kNumModes];
#pragma unroll
  for (int k = 0; k < kNumModes; ++k) {
    is[k] = mi >= 0 && mi < 32 && ((fr.masks[k] >> mi) & 1u);
  }
  const bool recrop = is[kCom] || is[kSc];
  float off[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) off[k] = is[kCom] ? off_in[k] : 0.0f;
  // torch.remainder(rot, 360.0) as PyTorch's CUDA kernel computes it
  float rot = fmodf(is[kRot] ? rot_in : 0.0f, 360.0f);
  if (rot != 0.0f && rot < 0.0f) rot = __fadd_rn(rot, 360.0f);
  const float sc = is[kSc] ? sc_in : 1.0f;

  // com shifted in metric space (com mode), cube scaled (sc mode)
  float com3d[3], new_com3d_c[3], new_com_c[3], new_com[3], new_cube[3];
  dp::img_to_3d(fr.cam, com, com3d);
#pragma unroll
  for (int k = 0; k < 3; ++k) new_com3d_c[k] = __fadd_rn(com3d[k], off[k]);
  dp::three_d_to_img(fr.cam, new_com3d_c, new_com_c);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    new_com[k] = is[kCom] ? new_com_c[k] : com[k];
    new_cube[k] = is[kSc] ? __fmul_rn(cube[k], sc) : cube[k];
  }

  // the new crop transform (crop_transform on the new com and cube) and
  // the re-threshold's z-range (com_to_bounds with the original cube)
  float m_new[9], m_unused[9];
  dp::sample_geometry(new_com, new_cube, fr.cam.fx, fr.cam.fy, fr.h, fr.w,
                      ph, pw, m_new);
  const dp::Geometry zg = dp::sample_geometry(
      new_com, cube, fr.cam.fx, fr.cam.fy, fr.h, fr.w, ph, pw, m_unused);

  // the forward patch -> patch warp: com/sc M_new . M^-1, rot R(-rot)
  // about the patch centre, none the identity; then its inverse
  float a_fwd[9], m_inv[9];
  dp::inv3x3(m, m_inv);
  if (recrop) {
    dp::matmul3x3(m_new, m_inv, a_fwd);
  } else if (is[kRot]) {
    dp::rotation_matrix_2d(static_cast<float>(pw / 2),
                           static_cast<float>(ph / 2), rot, a_fwd);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) a_fwd[k] = k % 4 == 0 ? 1.0f : 0.0f;
  }
  float a_inv[9];
  dp::inv3x3(a_fwd, a_inv);

  SampleParams p;
  p.i00 = a_inv[0];
  p.i01 = a_inv[1];
  p.i02 = a_inv[2];
  p.i10 = a_inv[3];
  p.i11 = a_inv[4];
  p.i12 = a_inv[5];
  // norm_params: unnormalize by the crop's com and cube, renormalize by
  // the new ones; the re-threshold only for com/sc samples
  const float com_z = com[2], cube_z = cube[2];
  const float half = __fmul_rn(cube_z, 0.5f);
  p.s_in = fr.norm_zero_one ? cube_z : half;
  p.t_in = fr.norm_zero_one ? __fsub_rn(com_z, half) : com_z;
  const float nz = new_com[2], ncz = new_cube[2];
  const float nhalf = __fmul_rn(ncz, 0.5f);
  p.zend2 = __fadd_rn(nz, nhalf);
  p.zstart2 = __fsub_rn(nz, nhalf);
  p.t_out = fr.norm_zero_one ? p.zstart2 : nz;
  p.s_out = fr.norm_zero_one ? ncz : nhalf;
  p.thresh = recrop;
  p.zs_t = zg.zstart;
  p.ze_t = zg.zend;

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    so.new_com[3 * b + k] = new_com[k];
    so.new_cube[3 * b + k] = new_cube[k];
    so.com3d[3 * b + k] = com3d[k];
    so.new_com3d_c[3 * b + k] = new_com3d_c[k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) so.m_out[9 * b + k] = recrop ? m_new[k] : m[k];
  so.rot[b] = rot;
#pragma unroll
  for (int k = 0; k < kNumModes; ++k) so.is_mode[kNumModes * b + k] = is[k];
  return p;
}

// The source index of 4 consecutive output pixels (u0.., v): the nearest
// source pixel of each (floor(x + 0.5), cv2's rounding) as q * w + p, or
// -1 outside the patch
__device__ __forceinline__ void source4(int* idx, int h, int w, int u0, int v,
                                        const SampleParams& p) {
  const float fv = static_cast<float>(v);
  const float x0 = __fmul_rn(p.i01, fv), y0 = __fmul_rn(p.i11, fv);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float u = static_cast<float>(u0 + j);
    const float x = __fadd_rn(__fadd_rn(__fmul_rn(p.i00, u), x0), p.i02);
    const float y = __fadd_rn(__fadd_rn(__fmul_rn(p.i10, u), y0), p.i12);
    const float sx = floorf(__fadd_rn(x, 0.5f));
    const float sy = floorf(__fadd_rn(y, 0.5f));
    const bool inside = u0 + j < w && sx >= 0.0f &&
                        sx < static_cast<float>(w) && sy >= 0.0f &&
                        sy < static_cast<float>(h);
    idx[j] = inside ? static_cast<int>(sy) * w + static_cast<int>(sx) : -1;
  }
}

// The values at `idx` of the staged patch (normalized, border where -1),
// unnormalized, with the NV mask and the recrop z-threshold (com/sc
// samples only): ops/hopper_warp.py::warp_norm_plain up to the premax
__device__ __forceinline__ void fetch4(float* val, const float* tile,
                                       const int* idx, const SampleParams& p,
                                       float border, int use_nv, float nv_val,
                                       float nv_thresh) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float d = border;
    if (idx[j] >= 0) d = __fadd_rn(__fmul_rn(tile[idx[j]], p.s_in), p.t_in);
    d = nv_mask(d, border, use_nv, nv_val, nv_thresh);
    if (p.thresh) {  // augment.py order
      if (d < p.zs_t && d != 0.0f) d = p.zs_t;
      if (d > p.ze_t) d = 0.0f;
    }
    val[j] = d;
  }
}

// the rest of K5's epilogue on 4 gathered values and their 16-byte store
// (nettrainer.py:985-997): premax/zero -> far face, clip, renormalize
__device__ __forceinline__ void finish4(float* __restrict__ row, int u0, int w,
                                        bool vec, const float* val,
                                        float premax, const SampleParams& p) {
  float res[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float d = val[j];
    if (d == premax) d = p.zend2;
    if (d == 0.0f) d = p.zend2;
    if (d < p.zstart2) d = p.zstart2;
    if (d > p.zend2) d = p.zend2;
    res[j] = __fdiv_rn(__fsub_rn(d, p.t_out), p.s_out);
  }
  if (vec) {
    *reinterpret_cast<float4*>(row + u0) = make_float4(res[0], res[1], res[2], res[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (u0 + j < w) row[u0 + j] = res[j];
    }
  }
}

// one block of kNormThreads threads per sample
__global__ void __launch_bounds__(kNormThreads)
warp_norm_kernel(const float* __restrict__ src, Inputs in, Frame fr, int h,
                 int w, float border, int use_nv, float nv_val,
                 float nv_thresh, float* __restrict__ out, SideOutputs so) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  float* tile = reinterpret_cast<float*>(smem + kHeadBytes);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = h * w;
  const float* img = src + static_cast<int64_t>(b) * n;
  float* dst = out + static_cast<int64_t>(b) * n;
  // 16-byte copies and stores need whole float4s per row, aligned
  const bool vec = (w & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;

  // 1. stage the sample's patch with asynchronous copies; thread 0 computes
  //    the sample's constants while they are in flight
  if (vec) {
    for (int i = tid; i < n >> 2; i += kNormThreads) {
      __pipeline_memcpy_async(tile + 4 * i, img + 4 * i, 16);
    }
  } else {
    for (int i = tid; i < n; i += kNormThreads) {
      __pipeline_memcpy_async(tile + i, img + i, 4);
    }
  }
  __pipeline_commit();
  if (tid == 0) sh.prm = sample_params(b, in, fr, h, w, so);
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. the premax: the maximum of the whole unnormalized patch
  const float s_in = sh.prm.s_in, t_in = sh.prm.t_in;
  float pmax = -CUDART_INF_F;
  if (vec) {
    const float4* tile4 = reinterpret_cast<const float4*>(tile);
    for (int i = tid; i < n >> 2; i += kNormThreads) {
      const float4 v = tile4[i];
      pmax = nan_max(pmax, __fadd_rn(__fmul_rn(v.x, s_in), t_in));
      pmax = nan_max(pmax, __fadd_rn(__fmul_rn(v.y, s_in), t_in));
      pmax = nan_max(pmax, __fadd_rn(__fmul_rn(v.z, s_in), t_in));
      pmax = nan_max(pmax, __fadd_rn(__fmul_rn(v.w, s_in), t_in));
    }
  } else {
    for (int i = tid; i < n; i += kNormThreads) {
      pmax = nan_max(pmax, __fadd_rn(__fmul_rn(tile[i], s_in), t_in));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pmax = nan_max(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
  }
  if (lane == 0) sh.warp_max[warp] = pmax;
  __syncthreads();
  float premax = sh.warp_max[0];
#pragma unroll
  for (int i = 1; i < kNormWarps; ++i) premax = nan_max(premax, sh.warp_max[i]);
  const SampleParams p = sh.prm;

  // 3. the output rows in tiles 32 pixels wide, 4 pixels a thread,
  //    gathered from the staged patch: a warp covers 16x8 pixels, so under
  //    any rotation its loads fall on a few source rows; one 16-byte store
  const int qx = 4 * (((warp & 1) << 2) | (lane & 3));
  const int ry = ((warp >> 1) << 3) | (lane >> 2);
  for (int v = ry; v < h; v += kTileRows) {
    for (int u0 = qx; u0 < w; u0 += kTile) {
      int idx[4];
      float val[4];
      source4(idx, h, w, u0, v, p);
      fetch4(val, tile, idx, p, border, use_nv, nv_val, nv_thresh);
      finish4(dst + static_cast<int64_t>(v) * w, u0, w, vec, val, premax, p);
    }
  }
}

// The kernels stage a patch in dynamic shared memory, and above 48 KB a
// kernel must opt in, per device: each always opts in to the size it
// launches with, so only the device's per-block maximum bounds it.  The
// attribute is set once per device and kernel, and again only for a larger
// size; a refused size fails here, not at launch.
constexpr int kMaxDevices = 64;

template <auto kKernel>
cudaError_t opt_in_smem(size_t smem) {
  // static storage: zero before the first call; two threads racing here at
  // worst both set the attribute
  static std::atomic<size_t> granted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && granted[dev].load() >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev].store(smem);
  return err;
}

}  // namespace

extern "C" {

// K4: patch (b, h, w) -> out (b, h, w) through params (b, kNumPatchParams),
// the inverse transforms' top two rows.  Launches on `stream` and returns
// the cudaError_t of the launch.  All buffers are contiguous float32 device
// memory; h * w * 4 bytes must fit in one block's shared memory.
int dp_warp_patch(const float* patch, const float* params, float* out, int b,
                  int h, int w, float border, int use_nv, float nv_val,
                  float nv_thresh, void* stream) {
  if (b == 0 || h * w == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(h) * w * sizeof(float);
  const cudaError_t err = opt_in_smem<warp_patch_kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  warp_patch_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      patch, params, out, h, w, border, use_nv, nv_val, nv_thresh);
  return static_cast<int>(cudaGetLastError());
}

// K5: normalized patches (b, h, w) -> augmented normalized patches `out`,
// from the draws mode_idx (b,) int64, off (b, 3), rot (b,), sc (b,), the
// crops' com (b, 3), cube (3 floats at stride cube_stride, 0: one cube) and
// m (b, 3, 3), the camera (fx, fy, ux, uy, flip_y) and frame (img_h, img_w),
// and mask_<mode>, the slots of aug_modes that hold that mode (bit i: slot
// i).  Also writes new_com, new_cube, com3d, new_com3d_c (b, 3), m_out
// (b, 3, 3), rot_out (b,) and is_mode (b, 4) bool.  Launches one block per
// sample on `stream` and returns the cudaError_t of the launch.  All
// buffers are contiguous device memory, float32 but for mode_idx and
// is_mode; kHeadBytes + h * w * 4 bytes must fit in one block's shared
// memory.
int dp_warp_norm(const float* patch, const int64_t* mode_idx,
                 const float* off, const float* rot, const float* sc,
                 const float* com, const float* cube, int cube_stride,
                 const float* m, float fx, float fy, float ux, float uy,
                 int flip_y, int img_h, int img_w, int mask_none,
                 int mask_com, int mask_rot, int mask_sc, int norm_zero_one,
                 float border, int use_nv, float nv_val, float nv_thresh,
                 float* out, float* new_com, float* new_cube,
                 float* m_out, float* com3d, float* new_com3d_c,
                 float* rot_out, bool* is_mode, int b, int h, int w,
                 void* stream) {
  if (b == 0 || h * w == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = kHeadBytes + static_cast<size_t>(h) * w * sizeof(float);
  const cudaError_t err = opt_in_smem<warp_norm_kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Inputs in{mode_idx, off, rot, sc, com, cube, cube_stride, m};
  Frame fr;
  fr.cam = dp::Camera{fx, fy, ux, uy, flip_y};
  fr.h = img_h;
  fr.w = img_w;
  const int masks[kNumModes] = {mask_none, mask_com, mask_rot, mask_sc};
  for (int k = 0; k < kNumModes; ++k) fr.masks[k] = static_cast<unsigned int>(masks[k]);
  fr.norm_zero_one = norm_zero_one;
  const SideOutputs so{new_com, new_cube, m_out, com3d, new_com3d_c, rot_out,
                       is_mode};
  warp_norm_kernel<<<b, kNormThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      patch, in, fr, h, w, border, use_nv, nv_val, nv_thresh, out, so);
  return static_cast<int>(cudaGetLastError());
}

// the compile-time layout the wrapper checks its own against: K4's params
// per sample (0) and K5's mode count (1)
int dp_warp_constant(int which) {
  switch (which) {
    case 0: return kNumPatchParams;
    case 1: return kNumModes;
    default: return -1;
  }
}

const char* dp_warp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
