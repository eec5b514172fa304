// Native capture shim — the lib_dscapture equivalent (the PyTorch port's
// copy of deepprior_tpu/cpp/capture.cpp; the same frames, the same C API).
//
// The reference ships a DepthSense-SDK CPython extension
// (src/util/initdepthsense.cxx / depthsense.cxx) whose essential design is:
//   * a capture loop producing depth frames at a fixed rate,
//   * double-buffered publication via an atomic pointer swap, so the Python
//     reader never observes a torn frame (initdepthsense.cxx:95-111), and
//   * a module surface start/stop/getDepthMap/getIntrinsics/getAcceleration
//     (depthsense.cxx:203-223).
//
// This shim reproduces that contract hardware-free — but with a seqlock
// (two generation-counted slots, depth+colour published together) instead
// of the reference's bare pointer swap, which can tear when the writer
// laps a slow reader and can pair mismatched depth/colour generations.
// A std::thread capture loop (in-process; the reference used fork+mmap
// because of the SDK's event loop) with two selectable backends:
//   * "synthetic": renders a moving-blob hand scene (deterministic),
//   * "file":      replays raw float32 frames from a binary file whose
//                  layout is [int32 h, int32 w, int32 n, float32 data...].
// A real camera SDK backend slots into the same CaptureBackend interface.
//
// Exposed as a plain C API consumed from Python via ctypes
// (deepprior_tpu_torch/realtime/camera.py::CaptureDevice), built with g++
// by deepprior_tpu_torch/ops/_build.py::host_library_path.

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// A publication slot carrying a depth frame and its colour frame under ONE
// generation counter (seqlock): even seq = stable, odd = being written.
// Readers validate seq before AND after copying, so a slow reader that the
// writer laps simply retries on the newer slot — no torn frames, and depth
// + colour always pair up (the reference's double buffer could hand
// ds_get_sync a new depth frame with the previous colour frame).
struct Slot {
  std::atomic<uint64_t> seq{0};
  std::vector<float> depth;
  std::vector<uint8_t> colour;
};

struct CaptureState {
  int width = 320;
  int height = 240;
  float fx = 224.5f, fy = 230.5f, ux = 160.0f, uy = 120.0f;
  double fps = 30.0;

  // colour camera (reference depthsense.cxx keeps a 640x480x3 RGB stream
  // alongside the 320x240 depth stream)
  int cwidth = 640;
  int cheight = 480;
  float cfx = 449.0f, cfy = 461.0f, cux = 320.0f, cuy = 240.0f;
  // stereo extrinsics, row-major 3x4 [R|t]: colour_cam_point = R*X + t,
  // X in depth-camera mm.  A pure 25 mm horizontal baseline.
  float extrinsics[12] = {1, 0, 0, -25.0f,
                          0, 1, 0, 0,
                          0, 0, 1, 0};

  // two seqlock slots; `latest` indexes the most recently published one
  Slot slots[2];
  std::atomic<int> latest{-1};

  std::atomic<long long> frame_counter{0};
  std::atomic<long long> cframe_counter{0};
  std::atomic<bool> running{false};
  std::thread worker;

  // backends
  std::string mode;
  std::vector<float> file_frames;  // file backend: n*h*w floats
  int file_n = 0;

  float accel[3] = {0.0f, -9.81f, 0.0f};
};

CaptureState* g_state = nullptr;

void render_synthetic(CaptureState& s, float* out, long long t) {
  // moving hand-blob: a sphere sweeping a Lissajous path, everything else 0
  const float cx = s.ux + 60.0f * std::sin(static_cast<float>(t) / 20.0f);
  const float cy = s.uy + 40.0f * std::cos(static_cast<float>(t) / 25.0f);
  const float cz = 700.0f + 80.0f * std::sin(static_cast<float>(t) / 30.0f);
  const float radius_mm = 90.0f;
  const float r_px = radius_mm * s.fx / cz;
  const float r2 = r_px * r_px;
  for (int v = 0; v < s.height; ++v) {
    for (int u = 0; u < s.width; ++u) {
      const float du = static_cast<float>(u) - cx;
      const float dv = static_cast<float>(v) - cy;
      const float d2 = du * du + dv * dv;
      if (d2 <= r2) {
        const float bulge =
            radius_mm * std::sqrt(1.0f - d2 / (r2 > 1e-6f ? r2 : 1e-6f));
        out[v * s.width + u] = cz - bulge;
      } else {
        out[v * s.width + u] = 0.0f;
      }
    }
  }
}

// Colour frames are forward-splatted from the depth frame through the
// stereo extrinsics, so every backend (synthetic or file replay) gets an
// RGB stream geometrically consistent with its depth stream — the UV remap
// in ds_get_sync then recovers the splatted colours, which is the property
// the reference's buildSyncMap (depthsense.cxx:53-85) relies on.
void render_colour_from_depth(CaptureState& s, const float* depth,
                              uint8_t* out) {
  // background: vertical gradient
  for (int v = 0; v < s.cheight; ++v) {
    const uint8_t g = static_cast<uint8_t>(40 + v / 4);
    for (int u = 0; u < s.cwidth; ++u) {
      uint8_t* px = out + (v * s.cwidth + u) * 3;
      px[0] = g;
      px[1] = 60;
      px[2] = 90;
    }
  }
  const float* E = s.extrinsics;
  for (int v = 0; v < s.height; ++v) {
    for (int u = 0; u < s.width; ++u) {
      const float d = depth[v * s.width + u];
      if (d <= 0.0f) continue;
      const float X = (static_cast<float>(u) - s.ux) * d / s.fx;
      const float Y = (static_cast<float>(v) - s.uy) * d / s.fy;
      const float px = E[0] * X + E[1] * Y + E[2] * d + E[3];
      const float py = E[4] * X + E[5] * Y + E[6] * d + E[7];
      const float pz = E[8] * X + E[9] * Y + E[10] * d + E[11];
      if (pz <= 0.0f) continue;
      const int cu = static_cast<int>(s.cfx * px / pz + s.cux);
      const int cv = static_cast<int>(s.cfy * py / pz + s.cuy);
      // splat a 3x3 block: colour res is 2x depth res, so 1-px splats
      // leave holes the sync-map nearest lookup would land in
      for (int dv = -1; dv <= 1; ++dv) {
        for (int du = -1; du <= 1; ++du) {
          const int uu = cu + du, vv = cv + dv;
          if (uu < 0 || uu >= s.cwidth || vv < 0 || vv >= s.cheight) continue;
          uint8_t* o = out + (vv * s.cwidth + uu) * 3;
          o[0] = 210;  // skin tone
          o[1] = 160;
          o[2] = 120;
        }
      }
    }
  }
}

// per-pixel depth->colour UV map, the reference's uvFullMap: normalized
// colour-image coordinates for each depth pixel, negative when invalid
void compute_uv(const CaptureState& s, const float* depth, float* uv) {
  const float* E = s.extrinsics;
  for (int v = 0; v < s.height; ++v) {
    for (int u = 0; u < s.width; ++u) {
      float* o = uv + (v * s.width + u) * 2;
      const float d = depth[v * s.width + u];
      if (d <= 0.0f) {
        o[0] = -1.0f;
        o[1] = -1.0f;
        continue;
      }
      const float X = (static_cast<float>(u) - s.ux) * d / s.fx;
      const float Y = (static_cast<float>(v) - s.uy) * d / s.fy;
      const float px = E[0] * X + E[1] * Y + E[2] * d + E[3];
      const float py = E[4] * X + E[5] * Y + E[6] * d + E[7];
      const float pz = E[8] * X + E[9] * Y + E[10] * d + E[11];
      if (pz <= 0.0f) {
        o[0] = -1.0f;
        o[1] = -1.0f;
        continue;
      }
      o[0] = (s.cfx * px / pz + s.cux) / static_cast<float>(s.cwidth);
      o[1] = (s.cfy * py / pz + s.cuy) / static_cast<float>(s.cheight);
    }
  }
}

bool load_file_frames(CaptureState& s, const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  int32_t hdr[3];
  if (std::fread(hdr, sizeof(int32_t), 3, f) != 3) {
    std::fclose(f);
    return false;
  }
  s.height = hdr[0];
  s.width = hdr[1];
  s.file_n = hdr[2];
  const size_t total =
      static_cast<size_t>(s.height) * s.width * static_cast<size_t>(s.file_n);
  s.file_frames.resize(total);
  const size_t got = std::fread(s.file_frames.data(), sizeof(float), total, f);
  std::fclose(f);
  return got == total;
}

void capture_loop(CaptureState* s) {
  using clock = std::chrono::steady_clock;
  const auto period = std::chrono::duration<double>(1.0 / s->fps);
  auto next = clock::now();
  while (s->running.load(std::memory_order_acquire)) {
    const long long t = s->frame_counter.load(std::memory_order_relaxed);
    Slot& slot = s->slots[t & 1];

    // seqlock write: odd seq marks the slot in-flight
    slot.seq.fetch_add(1, std::memory_order_relaxed);
    std::atomic_thread_fence(std::memory_order_release);

    float* dst = slot.depth.data();
    if (s->mode == "file" && s->file_n > 0) {
      const size_t frame_px = static_cast<size_t>(s->height) * s->width;
      const float* src = s->file_frames.data() + (t % s->file_n) * frame_px;
      std::memcpy(dst, src, frame_px * sizeof(float));
    } else {
      render_synthetic(*s, dst, t);
    }
    // colour stream: splat the fresh depth frame through the extrinsics —
    // written into the SAME slot so the pair publishes atomically
    render_colour_from_depth(*s, dst, slot.colour.data());

    slot.seq.fetch_add(1, std::memory_order_release);
    s->latest.store(static_cast<int>(t & 1), std::memory_order_release);
    s->frame_counter.fetch_add(1, std::memory_order_release);
    s->cframe_counter.fetch_add(1, std::memory_order_release);

    next += std::chrono::duration_cast<clock::duration>(period);
    std::this_thread::sleep_until(next);
  }
}

// Copy a consistent (depth, colour) snapshot out of the newest slot.
// Either destination may be null.  Returns false only if nothing has been
// published yet (or after ~1000 laps, which at 30 fps cannot happen unless
// the process is wedged).
bool read_snapshot(CaptureState& s, float* depth_out, uint8_t* colour_out) {
  for (int attempt = 0; attempt < 1000; ++attempt) {
    const int i = s.latest.load(std::memory_order_acquire);
    if (i < 0) return false;
    Slot& slot = s.slots[i];
    const uint64_t s1 = slot.seq.load(std::memory_order_acquire);
    if (s1 & 1) continue;  // writer mid-flight on this slot; re-resolve
    if (depth_out)
      std::memcpy(depth_out, slot.depth.data(),
                  slot.depth.size() * sizeof(float));
    if (colour_out)
      std::memcpy(colour_out, slot.colour.data(), slot.colour.size());
    std::atomic_thread_fence(std::memory_order_acquire);
    if (slot.seq.load(std::memory_order_relaxed) == s1) return true;
  }
  return false;
}

}  // namespace

extern "C" {

int ds_start(const char* mode, const char* source, double fps) {
  if (g_state && g_state->running.load()) return 1;  // already running
  delete g_state;
  g_state = new CaptureState();
  g_state->mode = mode ? mode : "synthetic";
  g_state->fps = fps > 0 ? fps : 30.0;
  if (g_state->mode == "file") {
    if (!load_file_frames(*g_state, source)) {
      delete g_state;
      g_state = nullptr;
      return 2;  // bad file
    }
  }
  const size_t px = static_cast<size_t>(g_state->width) * g_state->height;
  const size_t cpx =
      static_cast<size_t>(g_state->cwidth) * g_state->cheight * 3;
  for (Slot& slot : g_state->slots) {
    slot.depth.assign(px, 0.0f);
    slot.colour.assign(cpx, 0);
  }
  g_state->running.store(true, std::memory_order_release);
  g_state->worker = std::thread(capture_loop, g_state);
  return 0;
}

void ds_stop(void) {
  if (!g_state) return;
  g_state->running.store(false, std::memory_order_release);
  if (g_state->worker.joinable()) g_state->worker.join();
}

int ds_get_depth(float* out, int capacity) {
  if (!g_state || !g_state->running.load(std::memory_order_acquire)) return 0;
  const int px = g_state->width * g_state->height;
  if (capacity < px) return 0;
  return read_snapshot(*g_state, out, nullptr) ? 1 : 0;
}

int ds_depth_width(void) { return g_state ? g_state->width : 0; }
int ds_depth_height(void) { return g_state ? g_state->height : 0; }

long long ds_frame_counter(void) {
  return g_state ? g_state->frame_counter.load(std::memory_order_acquire) : 0;
}

void ds_get_intrinsics(float* out4) {
  if (!g_state) return;
  out4[0] = g_state->fx;
  out4[1] = g_state->fy;
  out4[2] = g_state->ux;
  out4[3] = g_state->uy;
}

void ds_get_accel(float* out3) {
  if (!g_state) return;
  std::memcpy(out3, g_state->accel, 3 * sizeof(float));
}

// ---- colour / vertex / UV / sync surface (reference depthsense.cxx
// getColourMap/getVertices/getVerticesFP/getUVMap/getSyncMap, :203-223) ----

int ds_colour_width(void) { return g_state ? g_state->cwidth : 0; }
int ds_colour_height(void) { return g_state ? g_state->cheight : 0; }

long long ds_colour_frame_counter(void) {
  return g_state ? g_state->cframe_counter.load(std::memory_order_acquire) : 0;
}

int ds_get_colour(uint8_t* out, int capacity) {
  if (!g_state || !g_state->running.load(std::memory_order_acquire)) return 0;
  const int n = g_state->cwidth * g_state->cheight * 3;
  if (capacity < n) return 0;
  return read_snapshot(*g_state, nullptr, out) ? 1 : 0;
}

// (dH, dW, 3) vertex map in depth-camera mm; int16 variant saturates like
// the reference's vertexFullMap, fp variant is exact. Invalid depth -> 0.
int ds_get_vertices_fp(float* out, int capacity) {
  if (!g_state || !g_state->running.load(std::memory_order_acquire)) return 0;
  CaptureState& s = *g_state;
  const int n = s.width * s.height * 3;
  if (capacity < n) return 0;
  std::vector<float> snap(static_cast<size_t>(s.width) * s.height);
  if (!read_snapshot(s, snap.data(), nullptr)) return 0;
  const float* depth = snap.data();
  for (int v = 0; v < s.height; ++v) {
    for (int u = 0; u < s.width; ++u) {
      const float d = depth[v * s.width + u];
      float* o = out + (v * s.width + u) * 3;
      o[0] = d > 0.0f ? (static_cast<float>(u) - s.ux) * d / s.fx : 0.0f;
      o[1] = d > 0.0f ? (static_cast<float>(v) - s.uy) * d / s.fy : 0.0f;
      o[2] = d;
    }
  }
  return 1;
}

int ds_get_vertices(int16_t* out, int capacity) {
  if (!g_state) return 0;
  CaptureState& s = *g_state;
  const int n = s.width * s.height * 3;
  if (capacity < n) return 0;
  std::vector<float> fp(n);
  if (!ds_get_vertices_fp(fp.data(), n)) return 0;
  for (int i = 0; i < n; ++i) {
    float x = fp[i];
    if (x > 32767.0f) x = 32767.0f;
    if (x < -32768.0f) x = -32768.0f;
    out[i] = static_cast<int16_t>(x);
  }
  return 1;
}

// (dH, dW, 2) normalized colour coords per depth pixel; invalid -> (-1, -1)
int ds_get_uv(float* out, int capacity) {
  if (!g_state || !g_state->running.load(std::memory_order_acquire)) return 0;
  CaptureState& s = *g_state;
  const int n = s.width * s.height * 2;
  if (capacity < n) return 0;
  std::vector<float> snap(static_cast<size_t>(s.width) * s.height);
  if (!read_snapshot(s, snap.data(), nullptr)) return 0;
  compute_uv(s, snap.data(), out);
  return 1;
}

// (dH, dW, 3) colour sampled at each depth pixel's UV — the reference's
// buildSyncMap remap (depthsense.cxx:53-85): nearest colour pixel at
// (uvy*cH, uvx*cW) where 0<uv<1 and the depth is valid, else black.
int ds_get_sync(uint8_t* out, int capacity) {
  if (!g_state || !g_state->running.load(std::memory_order_acquire)) return 0;
  CaptureState& s = *g_state;
  const int n = s.width * s.height * 3;
  if (capacity < n) return 0;
  // one snapshot -> depth and colour are from the SAME capture generation
  std::vector<float> dsnap(static_cast<size_t>(s.width) * s.height);
  std::vector<uint8_t> csnap(static_cast<size_t>(s.cwidth) * s.cheight * 3);
  if (!read_snapshot(s, dsnap.data(), csnap.data())) return 0;
  const float* depth = dsnap.data();
  const uint8_t* colour = csnap.data();
  std::vector<float> uv(static_cast<size_t>(s.width) * s.height * 2);
  compute_uv(s, depth, uv.data());
  for (int i = 0; i < s.width * s.height; ++i) {
    const float uvx = uv[i * 2 + 0];
    const float uvy = uv[i * 2 + 1];
    uint8_t* o = out + i * 3;
    if (uvx > 0.0f && uvx < 1.0f && uvy > 0.0f && uvy < 1.0f &&
        depth[i] > 0.0f) {
      const int ci = static_cast<int>(uvy * static_cast<float>(s.cheight));
      const int cj = static_cast<int>(uvx * static_cast<float>(s.cwidth));
      const uint8_t* c = colour + (ci * s.cwidth + cj) * 3;
      o[0] = c[0];
      o[1] = c[1];
      o[2] = c[2];
    } else {
      o[0] = 0;
      o[1] = 0;
      o[2] = 0;
    }
  }
  return 1;
}

void ds_get_color_intrinsics(float* out4) {
  if (!g_state) return;
  out4[0] = g_state->cfx;
  out4[1] = g_state->cfy;
  out4[2] = g_state->cux;
  out4[3] = g_state->cuy;
}

void ds_get_extrinsics(float* out12) {
  if (!g_state) return;
  std::memcpy(out12, g_state->extrinsics, 12 * sizeof(float));
}

}  // extern "C"
