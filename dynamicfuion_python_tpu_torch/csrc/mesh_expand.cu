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
// per byte, far below the card's ~20 FLOP/B ridge for FP32. One thread per
// face keeps the writes coalesced; at the fitter's 65,536 faces the launch
// itself is the larger cost.
//
// Math matches extract_face_vertices of the JAX package and the plain
// PyTorch version beside the wrapper, operation by operation (built with
// --fmad=false): safe_z = |z| > 1e-9 ? z : 1e-9, u = x / safe_z * fx + cx,
// v = y / safe_z * fy + cy, valid = every corner has near < z < far.
// Vertex ids are clamped into [0, V), as an XLA gather clamps them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void mesh_expand_kernel(const float* __restrict__ verts, int num_verts,
                                   const int* __restrict__ tris, int num_faces,
                                   const float* __restrict__ intrinsics, float near_z,
                                   float far_z, float* __restrict__ out,
                                   uint8_t* __restrict__ valid) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= num_faces) return;
  const float fx = intrinsics[0];
  const float cx = intrinsics[2];
  const float fy = intrinsics[4];
  const float cy = intrinsics[5];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    int vi = tris[3 * f + i];
    vi = vi < 0 ? 0 : (vi >= num_verts ? num_verts - 1 : vi);
    const float x = verts[3 * vi + 0];
    const float y = verts[3 * vi + 1];
    const float z = verts[3 * vi + 2];
    ok = ok && (z > near_z) && (z < far_z);
    const float safe_z = fabsf(z) > 1e-9f ? z : 1e-9f;
    out[9 * f + 3 * i + 0] = x / safe_z * fx + cx;
    out[9 * f + 3 * i + 1] = y / safe_z * fy + cy;
    out[9 * f + 3 * i + 2] = z;
  }
  valid[f] = ok ? 1 : 0;
}

}  // namespace

extern "C" int mesh_expand(const float* verts, int num_verts, const int* tris, int num_faces,
                           const float* intrinsics, float near_z, float far_z, float* out,
                           uint8_t* valid, void* stream) {
  if (num_faces > 0) {
    const int threads = 256;
    const int blocks = (num_faces + threads - 1) / threads;
    mesh_expand_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        verts, num_verts, tris, num_faces, intrinsics, near_z, far_z, out, valid);
  }
  return static_cast<int>(cudaGetLastError());
}
