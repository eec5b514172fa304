// Connected-component labels of batched masks by block-based union-find
// (K8): 4-connectivity, pixels joined only where both are in the mask and
// their region ids are equal.
//
// Replaces no Pallas kernel.  The JAX package labels the slice scan's
// components with a lax.while_loop of segmented min-scans, plain XLA
// (deepprior_tpu/ops/com.py:244-275, label_components); the port's plain
// version (ops/com.py::label_scan) runs the same loop eagerly, about 65
// PyTorch launches and one host sync a pass, and a frame takes 10-24 passes
// by the shape of its components.  This kernel gives the same labels in
// three launches with no host sync, whatever the shapes.
//
// Design (Playne & Hawick, IEEE TPDS 2018; Allegretti, Bolelli & Grana,
// IEEE TPDS 2020).  The labels array is the parent array of a union-find
// over each frame's pixels, by linear index y * w + x within the frame.
//   1. label_local: one 32x32-thread block per 32x32 tile of one frame
//      (grid: tiles across, tiles down, frames).  The block stages the
//      tile's mask and region in shared memory, unites each foreground
//      pixel with its left and upper neighbours inside the tile, then
//      writes each foreground pixel's tile root as a frame index and the
//      background as h * w.
//   2. label_merge: one thread per pixel of each tile's top and left edge
//      unites it with its neighbour across the border, in global memory.
//   3. label_flatten: each foreground pixel takes the root of its tree.
// A union links the larger root under the smaller with atomicMin and, if
// the root was linked meanwhile, unites again from what it now points to
// (unite).  Every parent pointer therefore points to a smaller index, so
// each tree's root is its component's smallest linear index whatever order
// the atomics run in: the labels equal the plain scan's bit for bit and do
// not change from run to run.  Within a tile a pixel's local index orders
// as its frame index does, so the tile roots of step 1 are already the
// smallest frame indices of the tile's pieces.  Reads of the parent array
// go through volatile pointers: another thread, or another SM, may have
// linked the root meanwhile.
//
// What bounds it: one read of the mask (1 B a pixel) and the region (4 B)
// and one write of the labels (4 B), 2,764,800 B for a 640x480 frame,
// 0.83 us at 3.35 TB/s.  In practice three launches' latency and the
// atomics bound it, not bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblabel.so label.cu   (ops/_build.py does this)

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;              // a tile is kTile x kTile pixels
constexpr int kMaxGridYZ = 65535;      // tiles down and frames per launch

// the root of x's tree
__device__ __forceinline__ int find_root(const volatile int* parent, int x) {
  for (int p = parent[x]; p != x; p = parent[x]) x = p;
  return x;
}

// join the trees of a and b, the larger root under the smaller
__device__ void unite(volatile int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(const_cast<int*>(&parent[b]), a);
    if (old == b) return;
    // b was linked meanwhile to old < b; atomicMin kept the smaller of old
    // and a, so unite a with old to keep both links
    b = old;
  }
}

template <typename R>
__global__ void __launch_bounds__(kTile* kTile)
    label_local(const uint8_t* __restrict__ mask, const R* __restrict__ region,
                int* __restrict__ lab, int h, int w) {
  __shared__ int parent[kTile * kTile];
  __shared__ uint8_t fg[kTile * kTile];
  __shared__ R reg[kTile * kTile];
  const int lx = threadIdx.x, ly = threadIdx.y;
  const int x = blockIdx.x * kTile + lx, y = blockIdx.y * kTile + ly;
  const int i = ly * kTile + lx;
  const bool inside = x < w && y < h;
  const int64_t p = static_cast<int64_t>(blockIdx.z) * h * w +
                    static_cast<int64_t>(y) * w + x;
  const bool on = inside && mask[p] != 0;
  fg[i] = on;
  if (region != nullptr) reg[i] = on ? region[p] : R(0);
  parent[i] = i;
  __syncthreads();
  if (on) {
    if (lx > 0 && fg[i - 1] && (region == nullptr || reg[i - 1] == reg[i])) {
      unite(parent, i, i - 1);
    }
    if (ly > 0 && fg[i - kTile] &&
        (region == nullptr || reg[i - kTile] == reg[i])) {
      unite(parent, i, i - kTile);
    }
  }
  __syncthreads();
  if (inside) {
    int out = h * w;
    if (on) {
      const int r = find_root(parent, i);
      out = (blockIdx.y * kTile + r / kTile) * w + blockIdx.x * kTile +
            r % kTile;
    }
    lab[p] = out;
  }
}

// threads [0, kTile): the tile's top edge against the row above; threads
// [kTile, 2 kTile): its left edge against the column to the left
template <typename R>
__global__ void __launch_bounds__(2 * kTile)
    label_merge(const uint8_t* __restrict__ mask, const R* __restrict__ region,
                int* lab, int h, int w) {
  const int t = threadIdx.x;
  const bool top = t < kTile;
  const int x = blockIdx.x * kTile + (top ? t : 0);
  const int y = blockIdx.y * kTile + (top ? 0 : t - kTile);
  if (x >= w || y >= h || (top ? y == 0 : x == 0)) return;
  const int64_t frame = static_cast<int64_t>(blockIdx.z) * h * w;
  const int a = y * w + x;
  const int b = top ? a - w : a - 1;
  if (mask[frame + a] == 0 || mask[frame + b] == 0) return;
  if (region != nullptr && region[frame + a] != region[frame + b]) return;
  unite(lab + frame, a, b);
}

__global__ void __launch_bounds__(kTile* kTile)
    label_flatten(int* lab, int h, int w) {
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  if (x >= w || y >= h) return;
  volatile int* parent = lab + static_cast<int64_t>(blockIdx.z) * h * w;
  const int i = y * w + x;
  const int v = parent[i];
  // other threads overwrite their own entries with their roots meanwhile:
  // either value read is an ancestor in the same tree
  if (v != h * w) parent[i] = find_root(parent, v);
}

template <typename R>
cudaError_t launch(const uint8_t* mask, const R* region, int* out, int n,
                   int h, int w, cudaStream_t s) {
  const int tiles_x = (w + kTile - 1) / kTile;
  const int tiles_y = (h + kTile - 1) / kTile;
  const dim3 tile_block(kTile, kTile);
  for (int n0 = 0; n0 < n; n0 += kMaxGridYZ) {
    const int frames = n - n0 < kMaxGridYZ ? n - n0 : kMaxGridYZ;
    const int64_t off = static_cast<int64_t>(n0) * h * w;
    const R* reg = region == nullptr ? nullptr : region + off;
    const dim3 grid(tiles_x, tiles_y, frames);
    label_local<R><<<grid, tile_block, 0, s>>>(mask + off, reg, out + off, h, w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    label_merge<R><<<grid, 2 * kTile, 0, s>>>(mask + off, reg, out + off, h, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    label_flatten<<<grid, tile_block, 0, s>>>(out + off, h, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Labels n frames of h x w on `stream`: out[f, y, x] is the smallest
// linear index y' * w + x' of the 4-connected component of (y, x) in frame
// f, h * w on the background.  mask (n, h, w) is bool (one byte, 0 or 1);
// region (n, h, w) holds int32 (region_bytes 4) or int64 (8) ids, or is
// null (region_bytes 0) to join every masked neighbour; out (n, h, w) is
// int32.  All contiguous device buffers.  Requires h * w <= 2^31 - 1 and
// ceil(h / 32) <= 65535.  Returns the cudaError_t of the launches: three
// per 65535 frames.
int dp_label(const void* mask, const void* region, int region_bytes, void* out,
             int n, int h, int w, void* stream) {
  if (n < 0 || h < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  if (static_cast<int64_t>(h) * w > INT_MAX ||
      (h + kTile - 1) / kTile > kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (region_bytes) {
    case 0:
      err = launch<int32_t>(m, nullptr, o, n, h, w, s);
      break;
    case 4:
      err = launch(m, static_cast<const int32_t*>(region), o, n, h, w, s);
      break;
    case 8:
      err = launch(m, static_cast<const int64_t*>(region), o, n, h, w, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
