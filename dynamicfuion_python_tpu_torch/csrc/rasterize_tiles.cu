// Phase 2 of the binned rasterizer: per tile, the nearest fragment (K = 1).
//
// Replaces the Pallas TPU kernel `rasterize_tiles_pallas` (body
// `_make_kernel`) of dynamicfuion_python_tpu/ops/pallas/rasterize_tiles.py.
// The TPU kernel streamed a pre-gathered attribute-major [T, 16, K] copy of
// every bin's faces so that it needed no gathers; here each block gathers
// its bin's 9 floats per face itself from the contiguous [F, 9] face array,
// and no [T, K, 9] copy is ever written to device memory.
//
// Layout: one block per tile, one thread per pixel (tile_size^2 threads,
// 256 for the fitter's 16 x 16 tiles). The block walks its bin in chunks of
// CHUNK faces staged in shared memory; every thread tests every staged face
// against its pixel and keeps a running (depth, face, b0, b1, b2, d2).
// Bins are filled from the front, so the walk stops at the first empty slot.
//
// Bound on the H100: operations. Each (pixel, face) test needs ~51 FP32
// operations (three edge functions, three point-segment distances) on 36
// bytes of face data that 256 pixels share, so the kernel sits far above the
// FP32 ridge; the design keeps the face data in shared memory and the running
// minimum in registers, so device memory sees each face once per bin and each
// output once. This simple version recomputes the ~21 per-face operations
// (edge vectors, area, squared edge lengths) in every pixel, and, built with
// --fmad=false, issues a multiply-add as two instructions: it can reach at
// most half the card's FP32 peak.
//
// Math matches _fragment_candidates of the JAX package's XLA rasterizer and
// the plain PyTorch version beside the wrapper, operation by operation (built
// with --fmad=false): integer pixel coordinates, 1 / max(z, 1e-9) perspective
// weights, max(sum, 1e-12) normalisation. On equal depth the lower face id
// wins (the rule of the JAX fitter's rasterize_splat).

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 128;
constexpr float BG_DEPTH = 3.0e38f;

__device__ __forceinline__ float edge_fn(float px, float py, float ax, float ay, float bx,
                                         float by) {
  return (px - ax) * (by - ay) - (py - ay) * (bx - ax);
}

__device__ __forceinline__ float point_segment_d2(float px, float py, float ax, float ay,
                                                  float bx, float by) {
  const float dx = bx - ax;
  const float dy = by - ay;
  const float len2 = dx * dx + dy * dy;
  float t = ((px - ax) * dx + (py - ay) * dy) / fmaxf(len2, 1e-12f);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float ex = ax + t * dx - px;
  const float ey = ay + t * dy - py;
  return ex * ex + ey * ey;
}

__global__ void rasterize_tiles_kernel(const float* __restrict__ faces, int num_faces,
                                       const int* __restrict__ table, int bin_capacity,
                                       int tile_size, int tiles_w, float blur2,
                                       int perspective, int clip_bary, int cull,
                                       int* __restrict__ face_out,
                                       float* __restrict__ depth_out,
                                       float* __restrict__ bary_out,
                                       float* __restrict__ dist_out) {
  __shared__ float s_face[9][CHUNK];
  __shared__ int s_id[CHUNK];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int num_px = blockDim.x;
  const float px = static_cast<float>((tile % tiles_w) * tile_size + p % tile_size);
  const float py = static_cast<float>((tile / tiles_w) * tile_size + p / tile_size);
  const int* bin = table + static_cast<long long>(tile) * bin_capacity;

  float best_d = BG_DEPTH, best_b0 = 0.f, best_b1 = 0.f, best_b2 = 0.f, best_s = 0.f;
  int best_f = -1;

  for (int c0 = 0; c0 < bin_capacity; c0 += CHUNK) {
    const int n = min(CHUNK, bin_capacity - c0);
    __syncthreads();  // the previous chunk is consumed by every thread
    for (int j = p; j < n; j += num_px) {
      int id = bin[c0 + j];
      if (id >= num_faces) id = -1;
      s_id[j] = id;
      if (id >= 0) {
#pragma unroll
        for (int q = 0; q < 9; ++q) s_face[q][j] = faces[9LL * id + q];
      }
    }
    __syncthreads();
    if (s_id[0] < 0) break;  // same value in every thread: bins fill from the front
    for (int j = 0; j < n; ++j) {
      const int id = s_id[j];
      if (id < 0) break;
      const float ax = s_face[0][j], ay = s_face[1][j], az = s_face[2][j];
      const float bx = s_face[3][j], by = s_face[4][j], bz = s_face[5][j];
      const float cx = s_face[6][j], cy = s_face[7][j], cz = s_face[8][j];

      const float area = edge_fn(cx, cy, ax, ay, bx, by);
      const float e0 = edge_fn(px, py, bx, by, cx, cy);
      const float e1 = edge_fn(px, py, cx, cy, ax, ay);
      const float e2 = edge_fn(px, py, ax, ay, bx, by);
      const bool orientation_ok = cull ? (area > 0.0f) : (fabsf(area) > 1e-12f);
      const float safe_area = fabsf(area) > 1e-12f ? area : 1e-12f;
      float w0 = e0 / safe_area;
      float w1 = e1 / safe_area;
      float w2 = e2 / safe_area;
      const bool inside = (w0 >= 0.0f) && (w1 >= 0.0f) && (w2 >= 0.0f);

      const float d2 = fminf(fminf(point_segment_d2(px, py, ax, ay, bx, by),
                                   point_segment_d2(px, py, bx, by, cx, cy)),
                             point_segment_d2(px, py, cx, cy, ax, ay));
      bool hit = orientation_ok && (inside || d2 <= blur2);
      if (!hit) continue;

      if (perspective) {
        const float pa = w0 * (1.0f / fmaxf(az, 1e-9f));
        const float pb = w1 * (1.0f / fmaxf(bz, 1e-9f));
        const float pc = w2 * (1.0f / fmaxf(cz, 1e-9f));
        const float denom = fmaxf(pa + pb + pc, 1e-12f);
        w0 = pa / denom;
        w1 = pb / denom;
        w2 = pc / denom;
      }
      if (clip_bary) {
        const float c0c = fminf(fmaxf(w0, 0.0f), 1.0f);
        const float c1c = fminf(fmaxf(w1, 0.0f), 1.0f);
        const float c2c = fminf(fmaxf(w2, 0.0f), 1.0f);
        const float denom = fmaxf(c0c + c1c + c2c, 1e-12f);
        w0 = c0c / denom;
        w1 = c1c / denom;
        w2 = c2c / denom;
      }
      const float depth = w0 * az + w1 * bz + w2 * cz;
      if (!(depth > 0.0f)) continue;
      if (depth < best_d || (depth == best_d && id < best_f)) {
        best_d = depth;
        best_f = id;
        best_b0 = w0;
        best_b1 = w1;
        best_b2 = w2;
        best_s = inside ? -d2 : d2;
      }
    }
  }

  const bool empty = !(best_d < BG_DEPTH);
  const long long o = static_cast<long long>(tile) * num_px + p;
  const long long ob = static_cast<long long>(tile) * 3 * num_px + p;
  face_out[o] = empty ? -1 : best_f;
  depth_out[o] = best_d;
  bary_out[ob] = empty ? 0.f : best_b0;
  bary_out[ob + num_px] = empty ? 0.f : best_b1;
  bary_out[ob + 2 * num_px] = empty ? 0.f : best_b2;
  dist_out[o] = empty ? 0.f : best_s;
}

}  // namespace

extern "C" int rasterize_tiles(const float* faces, int num_faces, const int* table,
                               int num_tiles, int bin_capacity, int tile_size, int tiles_w,
                               float blur2, int perspective, int clip_bary, int cull,
                               int* face_out, float* depth_out, float* bary_out,
                               float* dist_out, void* stream) {
  if (num_tiles > 0) {
    rasterize_tiles_kernel<<<num_tiles, tile_size * tile_size, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        faces, num_faces, table, bin_capacity, tile_size, tiles_w, blur2, perspective,
        clip_bary, cull, face_out, depth_out, bary_out, dist_out);
  }
  return static_cast<int>(cudaGetLastError());
}
