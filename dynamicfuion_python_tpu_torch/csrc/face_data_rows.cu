// The fitter's face data term, from a Gauss-Newton iteration's inputs to the
// rows its segment sum adds: for each compacted pixel p and each of its face's
// 12 node slots s, row p * 12 + s of [cap * 12, 42] f32 (the 36 products of
// the lumped 6x6 block, then the 6 gradient entries), the row's segment (the
// slot's node, or num_nodes for a dropped slot), and the pixel's residual and
// robust weight.
//
// Replaces no TPU kernel: the JAX package computes this term in XLA
// (models/fitter.py::_data_term_face, _pixel_stage1, _chain_rule,
// _assemble_normal_equations). Its plain PyTorch form, kept beside the
// wrapper in models/fitter.py, takes ~970 launches an iteration on 184,320
// pixels and writes 42 row vectors before stacking them.
//
// Every value equals the plain form's on the card bit for bit (built with
// --fmad=false, each operation in the plain form's order):
// - pair tables (_pair_tables): per (vertex, anchor) pair the rotated offset
//   and normal, ((g + R o) + t) * w, and the four anchors summed as a CUDA
//   reduction over a middle axis of 4 sums them: in order, one thread each;
// - stage 1 (_pixel_stage1 and its autograd backward): each backward
//   formula as PyTorch's autograd writes it (div: g / b and -g * ((a / b) / b);
//   reciprocal: -g * (r * r); sqrt: g / (2 r); maximum: g / 2 on a tie, 0
//   below), gradient contributions added in the order the autograd engine
//   delivers them (its consumers by decreasing sequence number), and every
//   sum over the 3 corners, forward or a broadcast's gradient, as a CUDA
//   reduction over a contiguous axis of 3 sums it: (a0 + a2) + a1;
// - the chain rule (_chain_rule): the 12 pairs added into their slots in pair
//   order from zero, the dropped anchors (weight 0, slot 0) included;
// - the rows (_assemble_normal_equations): masks, Tukey weights (r / c on the
//   card is r * (1 / c)), the lumped scale 1 / max(|J_t|, 1e-3) times the
//   weight, (j_a * j_b) * scale and (-j_c) * (w r); dropped slots are 0.
// The constants are Python floats rounded to f32, as PyTorch rounds them.
//
// Bound on the H100: memory. The card has to write the rows once (2,016 B a
// pixel, 371.6 MB at 184,320 pixels) and the segments (96 B a pixel); the
// per-face and per-vertex tables it gathers (~12 MB at 65,536 faces) stay in
// the 50 MB L2. About 0.40 GB in all (ops/face_data_rows.py counts it), ~0.12
// ms at 3.35 TB/s; ~3,000 f32 operations a pixel (~0.55 G in all, ~0.017 ms
// at the 33.5 T/s --fmad=false allows) are far under it.
//
// Design: one thread per pixel computes its face's pair quantities, stage 1
// and the chain rule, keeping its 12 slots' jacobian rows, scale and g weight
// in shared memory (97 words a thread: an odd stride, so a warp's threads hit
// distinct banks); the block then writes its pixels' rows as one contiguous
// run of 16-byte stores (a pixel's 2,016 B written by one thread would leave
// every warp store strided), and its segments as one run of 8-byte stores.
// No atomics, no allocation, no synchronization with the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;  // pixels per block
constexpr int SLOTS = 12;
constexpr int COLS = 42;
constexpr int SLOT_WORDS = 8;  // j[6], scale, g weight
constexpr int PIXEL_WORDS = SLOTS * SLOT_WORDS + 1;

// PyTorch's CUDA reductions (read off the card: ATen's reduce config): a
// contiguous axis of 3 goes to two lanes of a warp (elements 0 and 2, then 1
// from a shuffle); a middle axis of 4, too short to split, to one thread
__device__ __forceinline__ float sum3(float a, float b, float c) { return (a + c) + b; }
__device__ __forceinline__ float sum4(float a, float b, float c, float d) { return ((a + b) + c) + d; }

// torch.maximum: NaN propagates
__device__ __forceinline__ float tmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// maximum's backward for its first argument:
// where(self == other, grad / 2, grad).masked_fill_(self < other, 0)
__device__ __forceinline__ float max_grad(float self, float other, float g) {
  const float r = self == other ? g * 0.5f : g;
  return self < other ? 0.0f : r;
}

struct Pair {
  float w;       // anchor weight (0 for a dropped anchor)
  int slot;      // face slot (0 for a dropped anchor)
  float ro[3];   // R (v - g)
  float rn[3];   // R n
  float pv[3];   // w * ((g + R (v - g)) + t)
  float pn[3];   // w * R n
};

struct Tables {
  const int* tris;           // [F, 3]
  const int64_t* slot_map;   // [F, 3, 4]
  const int* face_nodes;     // [F, 12]
  const float* weights;      // [V, 4]
  const float* pos;          // [N, 3]
  const float* rot;          // [N, 9]
  const float* trans;        // [N, 3]
  const float* verts;        // [V, 3]
  const float* normals;      // [V, 3]
};

__device__ __forceinline__ Pair load_pair(const Tables& t, int face, int i, int k) {
  Pair p;
  const int vtx = __ldg(t.tris + 3 * face + i);
  const long long slot = __ldg(reinterpret_cast<const long long*>(t.slot_map) + (3 * face + i) * 4 + k);
  p.w = slot >= 0 ? __ldg(t.weights + 4 * vtx + k) : 0.0f;
  p.slot = slot < 0 ? 0 : static_cast<int>(slot);
  int nid = __ldg(t.face_nodes + SLOTS * face + p.slot);
  nid = nid < 0 ? 0 : nid;
  const float* r = t.rot + 9 * nid;
  float rr[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) rr[j] = __ldg(r + j);
  float g[3], tt[3], v[3], n[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g[c] = __ldg(t.pos + 3 * nid + c);
    tt[c] = __ldg(t.trans + 3 * nid + c);
    v[c] = __ldg(t.verts + 3 * vtx + c);
    n[c] = __ldg(t.normals + 3 * vtx + c);
  }
  const float ox = v[0] - g[0], oy = v[1] - g[1], oz = v[2] - g[2];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p.ro[c] = (rr[3 * c] * ox + rr[3 * c + 1] * oy) + rr[3 * c + 2] * oz;
    p.rn[c] = (rr[3 * c] * n[0] + rr[3 * c + 1] * n[1]) + rr[3 * c + 2] * n[2];
    p.pv[c] = p.w * ((g[c] + p.ro[c]) + tt[c]);
    p.pn[c] = p.w * p.rn[c];
  }
  return p;
}

__global__ void __launch_bounds__(THREADS)
face_data_rows_kernel(const long long* __restrict__ idx, const long long* __restrict__ n_ok,
                      const int* __restrict__ pix_face, const uint8_t* __restrict__ mask,
                      const float* __restrict__ ref_points, int cap, int width, int row0,
                      const float* __restrict__ intrinsics, Tables tab, int num_nodes,
                      int tukey, float tukey_cutoff, float tukey_inv, int lump,
                      float* __restrict__ rows, long long* __restrict__ seg,
                      float* __restrict__ residuals, float* __restrict__ weights) {
  __shared__ float s_slot[THREADS * PIXEL_WORDS];
  __shared__ long long s_seg[THREADS * SLOTS];
  const int t = threadIdx.x;
  const int p0 = blockIdx.x * THREADS;
  const int n = min(THREADS, cap - p0);
  float* js = s_slot + t * PIXEL_WORDS;

  if (t < n) {
    const int p = p0 + t;
    long long pix;
    bool ok;
    int face;
    if (idx != nullptr) {
      pix = __ldg(idx + p);
      ok = p < __ldg(n_ok);
      face = ok ? __ldg(pix_face + pix) : 0;
    } else {
      pix = p;
      face = __ldg(pix_face + p);
      ok = face >= 0 && __ldg(mask + p) != 0;
    }
    face = face < 0 ? 0 : face;
    const float px = static_cast<float>(pix % width);
    const float py = static_cast<float>(pix / width + row0);
    const float r0 = __ldg(ref_points + 3 * pix);
    const float r1 = __ldg(ref_points + 3 * pix + 1);
    const float r2 = __ldg(ref_points + 3 * pix + 2);
    const float fx = __ldg(intrinsics + 0), cxi = __ldg(intrinsics + 2);
    const float fy = __ldg(intrinsics + 4), cyi = __ldg(intrinsics + 5);

    // ---- pair tables: warped corners wv[i] and normals wn[i]
    float wv[3][3], wn[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Pair q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = load_pair(tab, face, i, k);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        wv[i][c] = sum4(q[0].pv[c], q[1].pv[c], q[2].pv[c], q[3].pv[c]);
        wn[i][c] = sum4(q[0].pn[c], q[1].pn[c], q[2].pn[c], q[3].pn[c]);
      }
    }

    // ---- stage 1, forward
    const float c6 = static_cast<float>(1e-6), c12 = static_cast<float>(1e-12), c9 = static_cast<float>(1e-9);
    float z[3], t1[3], t3[3], u[3], v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      z[k] = tmax(wv[k][2], c6);
      t1[k] = wv[k][0] / z[k];
      u[k] = t1[k] * fx + cxi;
      t3[k] = wv[k][1] / z[k];
      v[k] = t3[k] * fy + cyi;
    }
    const float ax = u[0], ay = v[0], bx = u[1], by = v[1], cx2 = u[2], cy2 = v[2];
    const float a1 = cx2 - ax, a2 = by - ay, a3 = a1 * a2, a4 = cy2 - ay, a5 = bx - ax, a6 = a4 * a5;
    const float area = a3 - a6;
    const float b1 = px - bx, b2 = cy2 - by, b3 = b1 * b2, b4 = py - by, b5 = cx2 - bx, b6 = b4 * b5;
    const float q1 = px - cx2, q2 = ay - cy2, q3 = q1 * q2, q4 = py - cy2, q5 = ax - cx2, q6 = q4 * q5;
    const float d1 = px - ax, d2 = by - ay, d3 = d1 * d2, d4 = py - ay, d5 = bx - ax, d6 = d4 * d5;
    const float e[3] = {b3 - b6, q3 - q6, d3 - d6};
    const bool keep_area = fabsf(area) > c12;
    const float sa = keep_area ? area : c12;
    float b2d[3], pw[3], bary[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      b2d[k] = e[k] / sa;
      pw[k] = b2d[k] / z[k];
    }
    const float spw = sum3(pw[0], pw[1], pw[2]);
    const float mpw = tmax(spw, c12);
#pragma unroll
    for (int k = 0; k < 3; ++k) bary[k] = pw[k] / mpw;
    const float depth = sum3(bary[0] * wv[0][2], bary[1] * wv[1][2], bary[2] * wv[2][2]);
    const float q2x = (px - cxi) / fx, q2y = (py - cyi) / fy;
    const float prx = q2x * depth, pry = q2y * depth;
    const float nx = sum3(bary[0] * wn[0][0], bary[1] * wn[1][0], bary[2] * wn[2][0]);
    const float ny = sum3(bary[0] * wn[0][1], bary[1] * wn[1][1], bary[2] * wn[2][1]);
    const float nz = sum3(bary[0] * wn[0][2], bary[1] * wn[1][2], bary[2] * wn[2][2]);
    const float n5 = (nx * nx + ny * ny) + nz * nz;
    const float sq = sqrtf(n5);
    const float mx = tmax(sq, c9);
    const float rc = 1.0f / mx;
    const float inv = rc;  // rc * 1.0
    const float f1 = prx - r0, f3 = pry - r1, f6 = depth - r2;
    const float f8 = (nx * f1 + ny * f3) + nz * f6;
    const float res = inv * f8;

    // ---- stage 1, backward (d res / d the 18 warped scalars)
    const float g_f8 = inv;  // 1 * inv
    const float g_nz82 = g_f8 * f6, g_f6 = g_f8 * nz;
    const float g_ny79 = g_f8 * f3, g_f3 = g_f8 * ny;
    const float g_nx77 = g_f8 * f1, g_f1 = g_f8 * nx;
    const float g_mx = -f8 * (rc * rc);  // reciprocal's backward of g_inv = 1 * f8
    const float g_sq = max_grad(sq, c9, g_mx);
    const float g_n5 = g_sq / (2.0f * sq);
    const float mzz = g_n5 * nz, myy = g_n5 * ny, mxx = g_n5 * nx;
    const float g_nz = (g_nz82 + mzz) + mzz;
    const float g_ny = (g_ny79 + myy) + myy;
    const float g_nx = (g_nx77 + mxx) + mxx;
    const float g_depth = (g_f6 + g_f3 * q2y) + g_f1 * q2x;
    float g_wx[3], g_wy[3], g_wz[3], g_mx3[3], g_my3[3], g_mz3[3], g_bary[3], g_pw[3], g_b2d[3];
    float tm[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_mz3[k] = g_nz * bary[k];
      g_my3[k] = g_ny * bary[k];
      g_mx3[k] = g_nx * bary[k];
      g_bary[k] = ((g_nz * wn[k][2] + g_ny * wn[k][1]) + g_nx * wn[k][0]) + g_depth * wv[k][2];
      tm[k] = -g_bary[k] * (bary[k] / mpw);
    }
    const float g_spw = max_grad(spw, c12, sum3(tm[0], tm[1], tm[2]));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_pw[k] = g_bary[k] / mpw + g_spw;
      g_b2d[k] = g_pw[k] / z[k];
      tm[k] = -g_b2d[k] * (b2d[k] / sa);
    }
    const float g_sa = sum3(tm[0], tm[1], tm[2]);
    const float g_area = keep_area ? g_sa : 0.0f;
    const float g_a6 = -g_area;
    const float g_a4 = g_a6 * a5, g_a5 = g_a6 * a4, g_a1 = g_area * a2, g_a2 = g_area * a1;
    const float g_e0 = g_b2d[0] / sa, g_e1 = g_b2d[1] / sa, g_e2 = g_b2d[2] / sa;
    const float gd6 = -g_e2, gd4 = gd6 * d5, gd5 = gd6 * d4, gd1 = g_e2 * d2, gd2 = g_e2 * d1;
    const float gq6 = -g_e1, gq4 = gq6 * q5, gq5 = gq6 * q4, gq1 = g_e1 * q2, gq2 = g_e1 * q1;
    const float gb6 = -g_e0, gb4 = gb6 * b5, gb5 = gb6 * b4, gb1 = g_e0 * b2, gb2 = g_e0 * b1;
    const float g_u[3] = {(((-gd5 + -gd1) + gq5) + -g_a5) + -g_a1,
                          ((gd5 + -gb5) + -gb1) + g_a5,
                          ((-gq5 + -gq1) + gb5) + g_a1};
    const float g_v[3] = {(((-gd4 + -gd2) + gq2) + -g_a4) + -g_a2,
                          ((gd2 + -gb4) + -gb2) + g_a2,
                          ((-gq4 + -gq2) + gb2) + g_a4};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float g_t1 = g_u[k] * fx, g_t3 = g_v[k] * fy;
      g_wx[k] = g_t1 / z[k];
      g_wy[k] = g_t3 / z[k];
      const float g_z = (-g_pw[k] * (pw[k] / z[k]) + -g_t3 * (t3[k] / z[k])) + -g_t1 * (t1[k] / z[k]);
      g_wz[k] = g_depth * bary[k] + max_grad(wv[k][2], c6, g_z);
    }

    // ---- chain rule: the pairs added into their slots in pair order
#pragma unroll
    for (int j = 0; j < SLOTS * 6; ++j) js[(j / 6) * SLOT_WORDS + j % 6] = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float gwx = g_wx[i], gwy = g_wy[i], gwz = g_wz[i];
      const float gmx = g_mx3[i], gmy = g_my3[i], gmz = g_mz3[i];
#pragma unroll 1
      for (int k = 0; k < 4; ++k) {
        const Pair q = load_pair(tab, face, i, k);
        const float rx = q.ro[0], ry = q.ro[1], rz = q.ro[2];
        const float sx = q.rn[0], sy = q.rn[1], sz = q.rn[2];
        const float nw = -q.w;
        float* dst = js + q.slot * SLOT_WORDS;
        dst[0] = dst[0] + nw * ((gwy * rz - gwz * ry) + (gmy * sz - gmz * sy));
        dst[1] = dst[1] + nw * ((gwz * rx - gwx * rz) + (gmz * sx - gmx * sz));
        dst[2] = dst[2] + nw * ((gwx * ry - gwy * rx) + (gmx * sy - gmy * sx));
        dst[3] = dst[3] + q.w * gwx;
        dst[4] = dst[4] + q.w * gwy;
        dst[5] = dst[5] + q.w * gwz;
      }
    }

    // ---- robust weight, then each slot's mask, scale and g weight
    const float r = ok ? res : 0.0f;
    float tw = 1.0f;
    if (tukey) {
      const float x = r * tukey_inv;
      const float y = 1.0f - x * x;
      tw = fabsf(r) < tukey_cutoff ? y * y : 0.0f;
    }
    const float w = ok ? tw : 0.0f;
    residuals[p] = r;
    weights[p] = w;
#pragma unroll 1
    for (int s = 0; s < SLOTS; ++s) {
      float* d = js + s * SLOT_WORDS;
      const int node = __ldg(tab.face_nodes + SLOTS * face + s);
      const bool slot_ok = node >= 0 && w > 0.0f;
      float scale = 1.0f;
      if (lump) {
        const float w_eff = sqrtf((d[3] * d[3] + d[4] * d[4]) + d[5] * d[5]);
        const float lo = static_cast<float>(1e-3);
        const float clamped = w_eff != w_eff ? w_eff : (w_eff < lo ? lo : w_eff);
        scale = 1.0f / clamped;
      }
      d[6] = slot_ok ? scale * w : 0.0f;
      d[7] = slot_ok ? w * r : 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) d[c] = slot_ok ? d[c] : 0.0f;
      s_seg[t * SLOTS + s] = slot_ok ? node : num_nodes;
    }
  }
  __syncthreads();

  // ---- the block's rows and segments, contiguous from row p0 * 12
  float* out = rows + static_cast<long long>(p0) * SLOTS * COLS;
  const int total = n * SLOTS * COLS;
  auto value = [&](int e) -> float {
    const int row = e / COLS, c = e - row * COLS;
    const int lp = row / SLOTS, s = row - lp * SLOTS;
    const float* d = s_slot + lp * PIXEL_WORDS + s * SLOT_WORDS;
    if (c < 36) {
      const int a = c / 6, b = c - a * 6;
      return (d[a] * d[b]) * d[6];
    }
    return -d[c - 36] * d[7];
  };
  if (n == THREADS) {
    // 64 pixels x 2,016 B: a multiple of 16 B from a 16 B aligned start
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int q = t; q < total / 4; q += THREADS) {
      const int e = 4 * q;
      out4[q] = make_float4(value(e), value(e + 1), value(e + 2), value(e + 3));
    }
  } else {
    for (int e = t; e < total; e += THREADS) out[e] = value(e);
  }
  long long* seg_out = seg + static_cast<long long>(p0) * SLOTS;
  for (int e = t; e < n * SLOTS; e += THREADS) seg_out[e] = s_seg[e];
}

}  // namespace

extern "C" int face_data_rows(const void* idx, const void* n_ok, const void* pix_face, const void* mask,
                              const void* ref_points, int cap, int width, int row0, const void* intrinsics,
                              const void* tris, const void* slot_map, const void* face_nodes,
                              const void* anchor_weights, const void* pos, const void* rot, const void* trans,
                              const void* verts, const void* normals, int num_nodes, int tukey,
                              float tukey_cutoff, float tukey_inv, int lump, void* rows, void* seg,
                              void* residuals, void* weights, void* stream) {
  if (cap <= 0) return 0;
  Tables tab{static_cast<const int*>(tris), static_cast<const int64_t*>(slot_map),
             static_cast<const int*>(face_nodes), static_cast<const float*>(anchor_weights),
             static_cast<const float*>(pos), static_cast<const float*>(rot), static_cast<const float*>(trans),
             static_cast<const float*>(verts), static_cast<const float*>(normals)};
  const int blocks = (cap + THREADS - 1) / THREADS;
  face_data_rows_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(idx), static_cast<const long long*>(n_ok),
      static_cast<const int*>(pix_face), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(ref_points), cap, width, row0, static_cast<const float*>(intrinsics), tab,
      num_nodes, tukey, tukey_cutoff, tukey_inv, lump, static_cast<float*>(rows),
      static_cast<long long*>(seg), static_cast<float*>(residuals), static_cast<float*>(weights));
  return static_cast<int>(cudaGetLastError());
}
