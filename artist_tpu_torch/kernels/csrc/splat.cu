// Bilinear splat of ray intensities onto per-heliostat flux bitmaps, and its
// vector-Jacobian product: hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   band_accumulate_kernel<kNoWindows> <- _splat_fwd_kernel (artist_tpu/kernels/splat_pallas.py,
//       via _splat_forward, bilinear_splat_pallas) and _scatter_kernel
//       (tools/splat_formulation_bench.py, via scatter_forward); the kernel is in
//       splat_band.cuh, shared with splat_window.cu
//   splat_backward_kernel              <- _splat_bwd_kernel (via _splat_bwd), and
//       _dyn_bwd_kernel (via _dyn_bwd): splat_window.cu's head note says why the
//       dynamic window's VJP is this gather
//
// Semantics (the reference's 4-neighbour scatter with strict bounds, fp32):
//   a ray (e, u, w) of heliostat m is valid when le = floor(e) lies in
//   [0, W-2] and lu = floor(u) in [0, H-2]; with fe = e - le, fu = u - lu it
//   deposits w(1-fu)(1-fe), w(1-fu)fe, w fu(1-fe), w fu fe into
//   out[m, lu, le], out[m, lu, le+1], out[m, lu+1, le], out[m, lu+1, le+1].
//   The validity test runs in float before any cast to int, so NaN, +-inf
//   and huge coordinates are simply invalid and deposit nothing. No flip.
//
// The TPU kernel is a one-hot matmul only because Mosaic cannot express a
// per-ray scatter; what it keeps out of device memory is the heliostat's map,
// resident in VMEM across all its rays. The forward does the same in shared
// memory: the map does not fit one block (256 x 256 fp32 = 256 KB against
// 227 KB), so it is cut into as few bands of rows as fit (2 of 128 rows at
// 256 x 256), one thread block each. The block reads every ray of its
// heliostat, adds the taps that land in its rows with shared-memory atomics
// and stores its band whole. A block owns its pixels: the output needs no
// zeroing, and no global atomic is sent. Each pixel is a sum of its deposits
// in run-dependent order, within the tolerance that chip_smoke.check_forward
// gives any two summation orders, 2.01 u (n - 1) sum|deposit|.
//
// Bound on the H100: bytes. A ray costs 14 (forward) or 29 (backward) fp32
// operations against 12 bytes read (forward) or 24 bytes moved (backward),
// far below the card's ~20 flop/byte ridge for fp32. What costs the forward
// is the taps: a shared-memory fp32 atomicAdd is a compare-and-swap loop on
// Hopper (ATOMS.CAST.SPIN). Step 0's counts at the flagship chunk ([100,
// 40000] rays -> [100, 256, 256], all valid): 12.2 deposits a touched pixel,
// but a warp's 32 rays fall on 31 distinct cells, so the previous design (a
// ray a thread, four global atomics) was bound by the 16 M atomics' L2 lines,
// not by collisions: 0.2005 ms, 0.1168 with the same taps sent to each ray's
// own 16 bytes. Measured by chip_smoke.py on an H100 80GB HBM3 (700 W limit)
// at the flagship chunk: forward 0.0975-0.0981 ms (that design 0.2008-0.2014
// in the same runs; index_add_ 0.209-0.211; bound 0.022), at the formulation
// tool's 32 M rays 0.578-0.584 ms (the PR 5 band kernel, a flush of global
// atomics after two shares of 86-row bands, 0.639-0.644); backward 0.049 ms
// against 0.030. Tried and dropped (PERF.md): 86-row bands in shares with a
// bulk-reduce, float4-atomic or scalar flush (0.121-0.127 ms), fewer rays a
// thread, 64-bit CAS pairs (0.43-0.54 ms), smaller bands with more blocks an
// SM. The backward is a pure gather and is deterministic.
//
// Interface: plain C, loaded with ctypes. The caller allocates every buffer
// and passes PyTorch's current stream; each function returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue when a band
// does not fit shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_band.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

struct Cell {
    bool valid;
    int64_t offset;  // lu * W + le within one bitmap
    float fe, fu;
};

__device__ __forceinline__ Cell locate(float e, float u, int height, int width) {
    Cell cell;
    const float le = floorf(e);
    const float lu = floorf(u);
    // Written so that NaN fails every comparison and lands in "invalid".
    cell.valid = (le >= 0.0f) && (le <= static_cast<float>(width - 2)) &&
                 (lu >= 0.0f) && (lu <= static_cast<float>(height - 2));
    cell.fe = e - le;
    cell.fu = u - lu;
    cell.offset = cell.valid
        ? static_cast<int64_t>(static_cast<int>(lu)) * width + static_cast<int>(le)
        : 0;
    return cell;
}

// VJP of the forward for cotangent g [M, H, W]. The derivative factors are
// one-hot (-1 at the lower cell, +1 at the upper), not the tent's one-sided
// slope, so exact-integer coordinates keep (-1, +1). dw does not depend on w:
// zero-weight in-bounds rays still get it. Invalid rays get zeros and read
// nothing from g.
__global__ void splat_backward_kernel(const float* __restrict__ e,
                                      const float* __restrict__ u,
                                      const float* __restrict__ w,
                                      const float* __restrict__ g,
                                      float* __restrict__ grad_e,
                                      float* __restrict__ grad_u,
                                      float* __restrict__ grad_w,
                                      int64_t num_maps, int64_t rays_per_map,
                                      int height, int width) {
    const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (ray >= rays_per_map) return;
    const int64_t map_size = static_cast<int64_t>(height) * width;
    for (int64_t m = blockIdx.y; m < num_maps; m += gridDim.y) {
        const int64_t i = m * rays_per_map + ray;
        const Cell cell = locate(e[i], u[i], height, width);
        float de = 0.0f, du = 0.0f, dw = 0.0f;
        if (cell.valid) {
            const float* base = g + m * map_size + cell.offset;
            const float g00 = base[0];
            const float g01 = base[1];
            const float g10 = base[width];
            const float g11 = base[width + 1];
            const float weight = w[i];
            const float fe = cell.fe, fu = cell.fu;
            dw = (1.0f - fu) * (1.0f - fe) * g00 + (1.0f - fu) * fe * g01 +
                 fu * (1.0f - fe) * g10 + fu * fe * g11;
            de = weight * ((1.0f - fu) * (g01 - g00) + fu * (g11 - g10));
            du = weight * ((1.0f - fe) * (g10 - g00) + fe * (g11 - g01));
        }
        grad_e[i] = de;
        grad_u[i] = du;
        grad_w[i] = dw;
    }
}

dim3 grid_for(int64_t num_maps, int64_t rays_per_map) {
    const int64_t blocks_x = (rays_per_map + kThreads - 1) / kThreads;
    const int64_t blocks_y = num_maps < kMaxGridY ? num_maps : kMaxGridY;
    return dim3(static_cast<unsigned>(blocks_x), static_cast<unsigned>(blocks_y), 1);
}

}  // namespace

extern "C" int splat_shared_limit(int device, int* bytes) {
    return static_cast<int>(cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

extern "C" int splat_forward(const float* e, const float* u, const float* w, float* out,
                             int64_t num_maps, int64_t rays_per_map, int height, int width,
                             int band_rows, int device, void* stream) {
    cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return static_cast<int>(status);
    return static_cast<int>(launch_band_accumulate<kNoWindows>(e, u, w, out, nullptr, num_maps, rays_per_map,
                                                               height, width, band_rows, 1, 0, nullptr, 1, 0,
                                                               device, static_cast<cudaStream_t>(stream)));
}

extern "C" int splat_backward(const float* e, const float* u, const float* w, const float* g,
                              float* grad_e, float* grad_u, float* grad_w,
                              int64_t num_maps, int64_t rays_per_map, int height, int width,
                              int device, void* stream) {
    cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return static_cast<int>(status);
    splat_backward_kernel<<<grid_for(num_maps, rays_per_map), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        e, u, w, g, grad_e, grad_u, grad_w, num_maps, rays_per_map, height, width);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
