// Indexed mesh -> pixel-space face vertices + near/far clip flag.
//
// Replaces the Pallas TPU kernel `_expand_project` (body `_kernel`) of
// dynamicfuion_python_tpu/ops/pallas/mesh_expand.py. That kernel sorted faces
// by minimum vertex id and swept 128-lane windows of a component-major vertex
// table, because an XLA gather on the TPU costs per row. On Hopper a gather
// of three 12-byte vertices per face is served by L2 (the fitter's vertex
// table is well under 50 MB), so faces stay in the caller's order.
//
// Bound on the H100: memory. Per face it reads 12 B of indices and up to
// 36 B of vertices and writes 36 B + 1 B, about 0.5 floating-point operations
// per byte, far below the card's ~20 FLOP/B ridge for FP32. At the fitter's
// 65,536 faces that is ~3.6 MB, ~1.1 us at 3.35 TB/s, about what the launch
// itself costs; launch_floor (an empty kernel, launched on this kernel's
// grid or on B1's) measures the part of it no kernel body can remove.
//
// Design: one thread per face computes its 9 floats and valid flag into
// shared memory; the block then writes its faces' [THREADS, 9] rows and
// flags as contiguous 16-byte stores (a thread writing its own 36-byte row
// would leave every warp store strided). Index and vertex loads take the
// read-only path (__ldg).
//
// Math matches extract_face_vertices of the JAX package and the plain
// PyTorch version beside the wrapper, operation by operation (built with
// --fmad=false): safe_z = |z| > 1e-9 ? z : 1e-9, u = x / safe_z * fx + cx,
// v = y / safe_z * fy + cy, valid = every corner has near < z < far.
// Vertex ids are clamped into [0, V), as an XLA gather clamps them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW = 9;  // floats per face

__global__ void __launch_bounds__(THREADS)
mesh_expand_kernel(const float* __restrict__ verts, int num_verts,
                   const int* __restrict__ tris, int num_faces,
                   const float* __restrict__ intrinsics, float near_z, float far_z,
                   float* __restrict__ out, uint8_t* __restrict__ valid) {
  __shared__ __align__(16) float s_out[THREADS * ROW];
  __shared__ __align__(16) uint8_t s_valid[THREADS];
  const int f0 = blockIdx.x * THREADS;
  const int n = min(THREADS, num_faces - f0);
  const int t = threadIdx.x;
  if (t < n) {
    const int f = f0 + t;
    const float fx = __ldg(intrinsics + 0);
    const float cx = __ldg(intrinsics + 2);
    const float fy = __ldg(intrinsics + 4);
    const float cy = __ldg(intrinsics + 5);
    bool ok = true;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      int vi = __ldg(tris + 3 * f + i);
      vi = vi < 0 ? 0 : (vi >= num_verts ? num_verts - 1 : vi);
      const float x = __ldg(verts + 3 * vi + 0);
      const float y = __ldg(verts + 3 * vi + 1);
      const float z = __ldg(verts + 3 * vi + 2);
      ok = ok && (z > near_z) && (z < far_z);
      const float safe_z = fabsf(z) > 1e-9f ? z : 1e-9f;
      // stride 9 words: the 32 threads of a warp hit 32 distinct banks
      s_out[ROW * t + 3 * i + 0] = x / safe_z * fx + cx;
      s_out[ROW * t + 3 * i + 1] = y / safe_z * fy + cy;
      s_out[ROW * t + 3 * i + 2] = z;
    }
    s_valid[t] = ok ? 1 : 0;
  }
  __syncthreads();
  // The block's rows start at a multiple of THREADS * 36 bytes and its flags
  // at a multiple of THREADS bytes: both 16-byte aligned.
  float* dst = out + static_cast<long long>(f0) * ROW;
  uint8_t* vdst = valid + f0;
  if (n == THREADS) {
    const float4* src4 = reinterpret_cast<const float4*>(s_out);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = t; i < THREADS * ROW / 4; i += THREADS) dst4[i] = src4[i];
    if (t < THREADS / 16) {
      reinterpret_cast<uint4*>(vdst)[t] = reinterpret_cast<const uint4*>(s_valid)[t];
    }
  } else {  // the last, partial block
    for (int i = t; i < n * ROW; i += THREADS) dst[i] = s_out[i];
    if (t < n) vdst[t] = s_valid[t];
  }
}

// An empty kernel, timed beside a kernel on that kernel's grid.
__global__ void launch_floor_kernel() {}

int blocks_for(int num_faces) { return (num_faces + THREADS - 1) / THREADS; }

}  // namespace

extern "C" int mesh_expand(const float* verts, int num_verts, const int* tris, int num_faces,
                           const float* intrinsics, float near_z, float far_z, float* out,
                           uint8_t* valid, void* stream) {
  if (num_faces > 0) {
    mesh_expand_kernel<<<blocks_for(num_faces), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        verts, num_verts, tris, num_faces, intrinsics, near_z, far_z, out, valid);
  }
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on a grid of `blocks` blocks of `threads` threads.
extern "C" int launch_floor(int blocks, int threads, void* stream) {
  if (blocks > 0) {
    launch_floor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  }
  return static_cast<int>(cudaGetLastError());
}
