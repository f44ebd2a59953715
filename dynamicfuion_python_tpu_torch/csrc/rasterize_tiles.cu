// Phase 2 of the binned rasterizer: per pixel, the nearest fragment (K = 1)
// among the faces binned to its tile.
//
// Replaces the Pallas TPU kernel `rasterize_tiles_pallas` (body
// `_make_kernel`) of dynamicfuion_python_tpu/ops/pallas/rasterize_tiles.py.
// The TPU kernel streamed a pre-gathered attribute-major [T, 16, K] copy of
// every bin's faces and tested every face against every pixel of the tile;
// here each block gathers its bin's faces from the contiguous [F, 9] array
// itself, and no [T, K, 9] copy is ever written to device memory.
//
// Bound on the H100: bytes. Counted as the function needs it (each bin
// entry tested only at the tile's pixels inside the face's box, widened by
// the blur radius: ~51 FP32 operations per test, ~21 per entry), the
// fitter's ~80k bin entries need ~0.3 M tests, ~18 M operations: less time
// at 67 TFLOP/s than moving the ~10 MB of bin entries, listed faces (36 B
// each, read once) and outputs at 3.35 TB/s. Built with --fmad=false (see below) the FP32 issue ceiling is
// 33.5 T instructions/s, half the FMA peak; the count stays below the byte
// bound there too. What the design does about it:
//
// - Per-face setup once per staged face. A block stages CHUNK bin entries
//   in shared memory and computes, once per face, what every pixel test
//   reuses: the edge deltas, the safe area, each edge's max(len^2, 1e-12),
//   the three 1 / max(z, 1e-9) and the face's pixel box. A face that fails
//   the orientation test (never a hit) gets no pixels.
// - A box cull before any division: a pixel outside the face's box,
//   widened by the blur radius + CULL_MARGIN, never meets the face
//   (argument below). The staged entries' boxes, clipped to the tile, are
//   counted and scanned into a list of (pixel, entry) pairs, and each lane
//   of the block takes one pair at a time: a lane never idles on a pixel
//   outside a face's box, however small the faces (the fitter's are ~3 px
//   across: with a pixel per lane, most lanes of a 16 x 2 warp strip would
//   sit masked off on each face the strip touches).
// - Per pixel, the nearest hit as one 64-bit key (depth bits << 32 | face
//   id) in shared memory, lowered with atomicMin: hit depths are > 0, so
//   the key orders exactly as (depth, face id) and the result does not
//   depend on the order of the pairs. The winner's barycentrics and
//   distance are recomputed once at the end from its 9 floats.
// - One wave: one block of 128 threads per tile, __launch_bounds__(128, 10)
//   so that 10 blocks stay resident per SM and the fitter's 1200 tiles all
//   run at once on the 132 SMs; the longest bins start with the rest.
// - Outputs in image layout: face int32[H, W], depth f32[H, W], bary
//   f32[H, W, 3], signed d2 f32[H, W], written directly (pixels past a
//   ragged right or bottom edge are not written), so the caller runs no
//   de-tiling copies.
//
// Math matches _fragment_math / rasterize_tiles_plain in ops/rasterize.py
// operation by operation, with the same operations in the same order:
// hoisting a value does not change how it rounds, and the divisions stay
// IEEE divisions. Built with --fmad=false, so no multiply and add are fused,
// the kernel equals the plain version bit for bit. On equal depth the lower
// face id wins (the rule of the JAX fitter's rasterize_splat).
//
// Why the cull is exact. Let a pixel p (integer coordinates) lie left of a
// face's box by more than M = r + 1 - 2^-8 >= 0.99 px (r = |blur radius|;
// the 2^-8 covers the rounding of the box edge at |coordinates| <= 2^16).
// Let L be the larger axis extent of the union of the tile and the face's
// box, so every |p - v| is at most L, and E the face box's larger extent,
// so every edge delta is at most E <= L. (Right, above and below are
// symmetric.) A face is culled only when its coordinates are finite with
// magnitude <= 2^16, r <= 4096 and |area| >= 2^-19 L^2 E; the others
// (slivers, faces far off screen) are tested at every pixel of the tile.
// - Not inside: every corner has v.x - p.x > M, and p = sum l_i v_i with
//   sum l_i = 1, so the negative barycentrics satisfy sum |l_i| >= M / L and
//   one edge function has exact value |e_i| >= |A| M / (2 L) (A the exact
//   doubled area of the float corners), with the sign opposite to A. An
//   edge function is two rounded products of rounded differences, off by at
//   most ~8 u L E (u = 2^-24), and the area by ~8 u E^2. With
//   |area| >= 2^-19 L^2 E = 32 u L^2 E (> 24.3 u L^2 E, what the two need)
//   the rounded e_i and area keep their signs, the quotient e_i / safe_area
//   is negative (far from underflow), and `inside` is false.
// - Not within the blur radius: for t in [0, 1] the rounded point
//   a + t (b - a) lies at most u (2.02 * 2^17 + 2^16) < 0.03 px left of the
//   box, so |e.x| > r + 0.96 after rounding and the rounded squared distance
//   to every edge exceeds fl(r^2).
// So a culled (pixel, face) pair is no hit in the plain version either.

#include <cuda_runtime.h>

#include <limits>

namespace {

constexpr int CHUNK = 128;  // bin entries staged per round
constexpr float BG_DEPTH = 3.0e38f;
constexpr float CULL_MARGIN = 1.0f;           // px beyond the blur radius
constexpr float CULL_MAX_COORD = 65536.0f;    // 2^16 px
constexpr float CULL_MAX_RADIUS = 4096.0f;
constexpr float CULL_AREA_SCALE = 1.9073486328125e-06f;  // 2^-19
constexpr float INF = std::numeric_limits<float>::infinity();

// A face's 9 floats and the constants every pixel test reuses.
struct Face {
  float ax, ay, az, bx, by, bz, cx, cy, cz;
  float abx, aby, bcx, bcy, cax, cay;  // b - a, c - b, a - c
  float len_ab, len_bc, len_ca;        // max(|edge|^2, 1e-12)
  float area, safe_area;
  float ia, ib, ic;                    // 1 / max(z, 1e-9)
};

__device__ __forceinline__ Face load_face(const float* __restrict__ f) {
  Face c;
  c.ax = __ldg(f + 0); c.ay = __ldg(f + 1); c.az = __ldg(f + 2);
  c.bx = __ldg(f + 3); c.by = __ldg(f + 4); c.bz = __ldg(f + 5);
  c.cx = __ldg(f + 6); c.cy = __ldg(f + 7); c.cz = __ldg(f + 8);
  c.abx = c.bx - c.ax; c.aby = c.by - c.ay;
  c.bcx = c.cx - c.bx; c.bcy = c.cy - c.by;
  c.cax = c.ax - c.cx; c.cay = c.ay - c.cy;
  c.len_ab = fmaxf(c.abx * c.abx + c.aby * c.aby, 1e-12f);
  c.len_bc = fmaxf(c.bcx * c.bcx + c.bcy * c.bcy, 1e-12f);
  c.len_ca = fmaxf(c.cax * c.cax + c.cay * c.cay, 1e-12f);
  c.area = (c.cx - c.ax) * c.aby - (c.cy - c.ay) * c.abx;  // edge_fn(c; a, b)
  c.safe_area = fabsf(c.area) > 1e-12f ? c.area : 1e-12f;
  c.ia = 1.0f / fmaxf(c.az, 1e-9f);
  c.ib = 1.0f / fmaxf(c.bz, 1e-9f);
  c.ic = 1.0f / fmaxf(c.cz, 1e-9f);
  return c;
}

// Squared distance from p to the segment from (ax, ay) along (dx, dy);
// (pax, pay) = p - a, len = max(|d|^2, 1e-12).
__device__ __forceinline__ float seg_d2(float px, float py, float pax, float pay, float ax,
                                        float ay, float dx, float dy, float len) {
  float t = (pax * dx + pay * dy) / len;
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float ex = ax + t * dx - px;
  const float ey = ay + t * dy - py;
  return ex * ex + ey * ey;
}

struct Frag {
  float depth, w0, w1, w2, sd2;
};

// The plain version's test of one face at one pixel, orientation aside
// (faces that fail it are never evaluated). Returns whether it is a hit.
__device__ __forceinline__ bool eval_face(const Face& c, float px, float py, float blur2,
                                          int perspective, int clip_bary, Frag& out) {
  const float pax = px - c.ax, pay = py - c.ay;
  const float pbx = px - c.bx, pby = py - c.by;
  const float pcx = px - c.cx, pcy = py - c.cy;
  const float e0 = pbx * c.bcy - pby * c.bcx;  // edge_fn(p; b, c)
  const float e1 = pcx * c.cay - pcy * c.cax;  // edge_fn(p; c, a)
  const float e2 = pax * c.aby - pay * c.abx;  // edge_fn(p; a, b)
  float w0 = e0 / c.safe_area;
  float w1 = e1 / c.safe_area;
  float w2 = e2 / c.safe_area;
  const bool inside = (w0 >= 0.0f) && (w1 >= 0.0f) && (w2 >= 0.0f);
  const float d2 = fminf(fminf(seg_d2(px, py, pax, pay, c.ax, c.ay, c.abx, c.aby, c.len_ab),
                               seg_d2(px, py, pbx, pby, c.bx, c.by, c.bcx, c.bcy, c.len_bc)),
                         seg_d2(px, py, pcx, pcy, c.cx, c.cy, c.cax, c.cay, c.len_ca));
  if (!(inside || d2 <= blur2)) return false;
  if (perspective) {
    const float pa = w0 * c.ia;
    const float pb = w1 * c.ib;
    const float pc = w2 * c.ic;
    const float denom = fmaxf(pa + pb + pc, 1e-12f);
    w0 = pa / denom;
    w1 = pb / denom;
    w2 = pc / denom;
  }
  if (clip_bary) {
    const float c0 = fminf(fmaxf(w0, 0.0f), 1.0f);
    const float c1 = fminf(fmaxf(w1, 0.0f), 1.0f);
    const float c2 = fminf(fmaxf(w2, 0.0f), 1.0f);
    const float denom = fmaxf(c0 + c1 + c2, 1e-12f);
    w0 = c0 / denom;
    w1 = c1 / denom;
    w2 = c2 / denom;
  }
  out.depth = w0 * c.az + w1 * c.bz + w2 * c.cz;
  out.w0 = w0;
  out.w1 = w1;
  out.w2 = w2;
  out.sd2 = inside ? -d2 : d2;
  return out.depth > 0.0f;
}

// Staged bin entries, struct of arrays, and each entry's pixel box clipped
// to the tile and the image: columns [ix0, ix0 + nx), rows from iy0, and
// the offset of its first (pixel, entry) pair in the chunk's pair list.
struct Stage {
  float ax[CHUNK], ay[CHUNK], az[CHUNK], bx[CHUNK], by[CHUNK], bz[CHUNK];
  float cx[CHUNK], cy[CHUNK], cz[CHUNK];
  float abx[CHUNK], aby[CHUNK], bcx[CHUNK], bcy[CHUNK], cax[CHUNK], cay[CHUNK];
  float len_ab[CHUNK], len_bc[CHUNK], len_ca[CHUNK], safe_area[CHUNK];
  float ia[CHUNK], ib[CHUNK], ic[CHUNK];
  int id[CHUNK], ix0[CHUNK], iy0[CHUNK], nx[CHUNK];
  int count[CHUNK];
  int start[CHUNK + 1];
};

__device__ __forceinline__ Face staged_face(const Stage& s, int j) {
  Face c;
  c.ax = s.ax[j]; c.ay = s.ay[j]; c.az = s.az[j];
  c.bx = s.bx[j]; c.by = s.by[j]; c.bz = s.bz[j];
  c.cx = s.cx[j]; c.cy = s.cy[j]; c.cz = s.cz[j];
  c.abx = s.abx[j]; c.aby = s.aby[j]; c.bcx = s.bcx[j];
  c.bcy = s.bcy[j]; c.cax = s.cax[j]; c.cay = s.cay[j];
  c.len_ab = s.len_ab[j]; c.len_bc = s.len_bc[j]; c.len_ca = s.len_ca[j];
  c.safe_area = s.safe_area[j];
  c.ia = s.ia[j]; c.ib = s.ib[j]; c.ic = s.ic[j];
  return c;
}

__device__ __forceinline__ bool coord_ok(float v) { return fabsf(v) <= CULL_MAX_COORD; }

// Integer pixels p in [p0, p1] with lo <= p <= hi (lo, hi may be infinite):
// writes the first and returns how many.
__device__ __forceinline__ int pixel_span(float lo, float hi, int p0, int p1, int& first) {
  const float a = fmaxf(ceilf(lo), static_cast<float>(p0));
  const float b = fminf(floorf(hi), static_cast<float>(p1));
  first = static_cast<int>(fminf(a, static_cast<float>(p1)));
  return b >= a ? static_cast<int>(b - a) + 1 : 0;
}

template <int THREADS, int MIN_BLOCKS, int TILE_PX>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
rasterize_tiles_kernel(const float* __restrict__ faces, int num_faces,
                       const int* __restrict__ table, int bin_capacity, int tile_size,
                       int tiles_w, int height, int width, float radius, float blur2,
                       int perspective, int clip_bary, int cull, int* __restrict__ face_out,
                       float* __restrict__ depth_out, float* __restrict__ bary_out,
                       float* __restrict__ dist_out) {
  __shared__ Stage s;
  // per pixel of the tile, the nearest hit as (depth bits << 32 | face id):
  // hit depths are > 0, whose bits order like the floats, so the smallest
  // key is the smallest depth and, among equal depths, the lowest face id
  __shared__ unsigned long long s_key[TILE_PX];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int x0 = (tile % tiles_w) * tile_size;
  const int y0 = (tile / tiles_w) * tile_size;
  const int x1 = min(x0 + tile_size, width) - 1;  // last column/row in the image
  const int y1 = min(y0 + tile_size, height) - 1;
  const float tx0 = static_cast<float>(x0), tx1 = static_cast<float>(x0 + tile_size - 1);
  const float ty0 = static_cast<float>(y0), ty1 = static_cast<float>(y0 + tile_size - 1);
  const float margin = radius + CULL_MARGIN;
  const int num_px = tile_size * tile_size;
  const int* bin = table + static_cast<long long>(tile) * bin_capacity;
  const unsigned long long no_hit =
      (static_cast<unsigned long long>(__float_as_uint(BG_DEPTH)) << 32) | 0xffffffffull;
  for (int p = tid; p < num_px; p += THREADS) s_key[p] = no_hit;

  for (int c0 = 0; c0 < bin_capacity; c0 += CHUNK) {
    const int n = min(CHUNK, bin_capacity - c0);
    __syncthreads();  // the previous chunk is consumed by every thread
    // stage: per-face constants and the face's box, once per entry
    for (int j = tid; j < CHUNK; j += THREADS) {
      const int id = j < n ? bin[c0 + j] : -1;
      s.id[j] = id;
      int count = 0, ix0 = x0, iy0 = y0, nx = 0;
      if (id >= 0 && id < num_faces) {
        const Face c = load_face(faces + 9LL * id);
        s.ax[j] = c.ax; s.ay[j] = c.ay; s.az[j] = c.az;
        s.bx[j] = c.bx; s.by[j] = c.by; s.bz[j] = c.bz;
        s.cx[j] = c.cx; s.cy[j] = c.cy; s.cz[j] = c.cz;
        s.abx[j] = c.abx; s.aby[j] = c.aby; s.bcx[j] = c.bcx;
        s.bcy[j] = c.bcy; s.cax[j] = c.cax; s.cay[j] = c.cay;
        s.len_ab[j] = c.len_ab; s.len_bc[j] = c.len_bc; s.len_ca[j] = c.len_ca;
        s.safe_area[j] = c.safe_area;
        s.ia[j] = c.ia; s.ib[j] = c.ib; s.ic[j] = c.ic;
        // a face that fails the orientation test is never a hit: no pixels
        const bool orientation_ok = cull ? (c.area > 0.0f) : (fabsf(c.area) > 1e-12f);
        if (orientation_ok) {
          const float xmin = fminf(fminf(c.ax, c.bx), c.cx);
          const float xmax = fmaxf(fmaxf(c.ax, c.bx), c.cx);
          const float ymin = fminf(fminf(c.ay, c.by), c.cy);
          const float ymax = fmaxf(fmaxf(c.ay, c.by), c.cy);
          // L and E of the exactness argument above
          const float ext = fmaxf(fmaxf(xmax, tx1) - fminf(xmin, tx0),
                                  fmaxf(ymax, ty1) - fminf(ymin, ty0));
          const float face_ext = fmaxf(xmax - xmin, ymax - ymin);
          const bool cullable = coord_ok(c.ax) && coord_ok(c.ay) && coord_ok(c.bx) &&
                                coord_ok(c.by) && coord_ok(c.cx) && coord_ok(c.cy) &&
                                radius <= CULL_MAX_RADIUS &&
                                fabsf(c.area) >= CULL_AREA_SCALE * ext * ext * face_ext;
          // slivers and faces far off screen: every pixel of the tile
          const float lox = cullable ? xmin - margin : -INF;
          const float hix = cullable ? xmax + margin : INF;
          const float loy = cullable ? ymin - margin : -INF;
          const float hiy = cullable ? ymax + margin : INF;
          nx = pixel_span(lox, hix, x0, x1, ix0);
          count = nx * pixel_span(loy, hiy, y0, y1, iy0);
        }
      } else if (id >= num_faces) {
        s.id[j] = num_faces;  // out of range: skipped
      }
      s.ix0[j] = ix0;
      s.iy0[j] = iy0;
      s.nx[j] = nx;
      s.count[j] = count;
    }
    __syncthreads();
    if (s.id[0] < 0) break;  // same value in every thread: bins fill from the front
    // exclusive scan of the counts: the chunk's (pixel, entry) pair list
    if (tid < 32) {
      constexpr int PER_LANE = CHUNK / 32;
      int local[PER_LANE];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        local[i] = sum;
        sum += s.count[tid * PER_LANE + i];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const int base = incl - sum;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) s.start[tid * PER_LANE + i] = base + local[i];
      if (tid == 31) s.start[CHUNK] = incl;
    }
    __syncthreads();
    // every lane takes one (pixel, entry) pair: lanes stay busy whatever
    // the faces' sizes, and a pixel outside a face's box costs nothing
    const int total = s.start[CHUNK];
    for (int q = tid; q < total; q += THREADS) {
      int lo = 0, hi = CHUNK;  // s.start[lo] <= q < s.start[hi]
#pragma unroll
      for (int step = 0; step < 7; ++step) {  // log2(CHUNK)
        const int mid = (lo + hi) >> 1;
        if (s.start[mid] <= q) lo = mid; else hi = mid;
      }
      const int j = lo;
      const int local = q - s.start[j];
      const int w = s.nx[j];
      const int dy = local / w;
      const int gx = s.ix0[j] + (local - dy * w);
      const int gy = s.iy0[j] + dy;
      Frag fr;
      if (eval_face(staged_face(s, j), static_cast<float>(gx), static_cast<float>(gy), blur2,
                    perspective, clip_bary, fr)) {
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(fr.depth)) << 32) |
            static_cast<unsigned int>(s.id[j]);
        atomicMin(&s_key[(gy - y0) * tile_size + (gx - x0)], key);
      }
    }
  }
  __syncthreads();

  // per pixel the winner's barycentrics and distance, recomputed with the
  // same operations (hence the same bits) as in the loop
  for (int p = tid; p < num_px; p += THREADS) {
    const int gx = x0 + p % tile_size;
    const int gy = y0 + p / tile_size;
    if (gx >= width || gy >= height) continue;
    const unsigned long long key = s_key[p];
    const float best_d = __uint_as_float(static_cast<unsigned int>(key >> 32));
    const int best_f = static_cast<int>(static_cast<unsigned int>(key));
    const long long o = static_cast<long long>(gy) * width + gx;
    Frag fr = {BG_DEPTH, 0.f, 0.f, 0.f, 0.f};
    const bool empty = !(best_d < BG_DEPTH);
    if (!empty) {
      eval_face(load_face(faces + 9LL * best_f), static_cast<float>(gx), static_cast<float>(gy),
                blur2, perspective, clip_bary, fr);
    }
    face_out[o] = empty ? -1 : best_f;
    depth_out[o] = best_d;
    bary_out[3 * o + 0] = empty ? 0.f : fr.w0;
    bary_out[3 * o + 1] = empty ? 0.f : fr.w1;
    bary_out[3 * o + 2] = empty ? 0.f : fr.w2;
    dist_out[o] = empty ? 0.f : fr.sd2;
  }
}

// tile_size <= 16: 128 threads and 10 resident blocks per SM, so the
// fitter's 1200 tiles run in one wave on 132 SMs; up to 32: 256 threads.
#define SMALL_KERNEL rasterize_tiles_kernel<128, 10, 256>
#define LARGE_KERNEL rasterize_tiles_kernel<256, 4, 1024>

}  // namespace

extern "C" int rasterize_tiles(const float* faces, int num_faces, const int* table,
                               int num_tiles, int bin_capacity, int tile_size, int tiles_w,
                               int height, int width, float radius, float blur2,
                               int perspective, int clip_bary, int cull, int* face_out,
                               float* depth_out, float* bary_out, float* dist_out,
                               void* stream) {
  if (tile_size < 1 || tile_size > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tile_size <= 16) {
      SMALL_KERNEL<<<num_tiles, 128, 0, st>>>(
          faces, num_faces, table, bin_capacity, tile_size, tiles_w, height, width, radius,
          blur2, perspective, clip_bary, cull, face_out, depth_out, bary_out, dist_out);
    } else {
      LARGE_KERNEL<<<num_tiles, 256, 0, st>>>(
          faces, num_faces, table, bin_capacity, tile_size, tiles_w, height, width, radius,
          blur2, perspective, clip_bary, cull, face_out, depth_out, bary_out, dist_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the kernel variant that serves tile_size.
extern "C" int rasterize_tiles_occupancy(int tile_size, int* blocks_per_sm) {
  if (tile_size <= 16) {
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, SMALL_KERNEL, 128, 0));
  }
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, LARGE_KERNEL, 256, 0));
}
