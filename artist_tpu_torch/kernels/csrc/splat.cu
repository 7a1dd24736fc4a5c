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
// tool's 32 M rays 0.578-0.584 ms (the band kernel before it, a flush of global
// atomics after two shares of 86-row bands, 0.639-0.644). Tried and dropped
// (PERF.md): 86-row bands in shares with a bulk-reduce, float4-atomic or
// scalar flush (0.121-0.127 ms), fewer rays a thread, 64-bit CAS pairs
// (0.43-0.54 ms), smaller bands with more blocks an SM.
//
// The backward is a pure gather: no atomics, so two launches give the same
// bits. Its bound is its streams' bytes (e and u read, w where valid, de, du
// and dw written: 24 a ray) and g's, 4 a touched pixel. The card reads g in
// 32-byte sectors, and its L2 fetches 64 bytes (cudaLimitMaxL2FetchGranularity
// reads 64; set to 32 it changed no time), so the sector floor counts 32 bytes
// for each sector a tap falls on. Where a map's rays are dense on it (the
// surface step's, reconstructor's, plant's and kinematics' chunks: 32-308 taps
// a sector) the floor is the bound: 0.0307 against 0.0302 ms at [100, 40000].
// At the PAINT reconstruction's [4000, 1000] batch the 13 M taps of 3.3 M valid
// rays fall on 5.2 M sectors (3.8 M 64-byte segments) of a 1 GB g: bound 0.042
// ms, sector floor 0.077, 64-byte floor 0.101. The design: lane l of a warp
// takes the warp's rays l, l + 32, ..., so that every warp-wide load covers 32
// consecutive rays and neighbouring rays' taps share sectors; one flat grid
// over the M x N rays, so no block runs part empty at N = 1,000; where
// rays_per_map >= H W / 16, 4 rays a thread, their 12 stream loads and 16 taps
// issued before one is used; where sparser, 1, since there more gathers in
// flight only cost (0.151 ms at [4000, 1000] with 4, 0.133 with 1); 32-bit
// indices where they fit (64-bit throughout cost 13-19% on dense maps: 0.0481
// against 0.0405 ms at [100, 40000], 2.863 against 2.480 at [1500, 190000]; the
// same at [4000, 1000]), the 64-bit instantiation kept for larger inputs and
// checked by chip_smoke.py through splat_backward_wide. ptxas: 48 registers (54
// with 64-bit indices) at 4 rays a thread, 30 (29) at 1, no spills. Measured by
// tools/backward_turns.py on an H100 80GB HBM3 (700 W limit), replayed from a
// CUDA graph, in turns with the kernel before (a ray a thread, a row of blocks
// a map): [100, 40000] 0.0406 ms (0.0471), [100, 4, 10000] in place 0.0407
// (0.0471), [36, 120000] 0.0435 (0.0469), [500, 20000] 0.0935 (0.0980), [1500,
// 190000] 2.477 (2.798), [4000, 1000] 0.1329 (0.1343). Tried and dropped, same
// tool on builds of each variant: 8 rays a thread (0.0439 ms at [100, 40000],
// 2.666 at [1500, 190000]), 2 (within 1-3% of 4); evict-first streams (2-7%
// slower on dense maps but [36, 120000], 3% faster there); taps cached in L2
// only (0.094 and 7.33 ms); 4 consecutive rays a thread with 16-byte stream
// accesses and evict-first hints (0.0442, 2.517 and, at [4000, 1000], 0.148 ms,
// against the interleaved layout's 0.0428, 2.617 and 0.153 with the same
// hints); staging a window's rows in shared memory (splat_window.cu's note).
//
// Interface: plain C, loaded with ctypes. The caller allocates every buffer
// and passes PyTorch's current stream; each function returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue when a band
// does not fit shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "splat_band.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
// A thread's rays where a map's rays are dense on it; below a kSparseShare-th of
// its pixels they are sparse, and a thread takes one.
constexpr int kDenseRays = 4;
constexpr int64_t kSparseShare = 16;
constexpr int64_t kMaxBlocks = 0x7fffffff;

template <typename Index>
struct Cell {
    bool valid;
    Index offset;  // lu * W + le within one bitmap
    float fe, fu;
};

template <typename Index>
__device__ __forceinline__ Cell<Index> locate(float e, float u, int height, int width) {
    Cell<Index> cell;
    const float le = floorf(e);
    const float lu = floorf(u);
    // Written so that NaN fails every comparison and lands in "invalid".
    cell.valid = (le >= 0.0f) && (le <= static_cast<float>(width - 2)) &&
                 (lu >= 0.0f) && (lu <= static_cast<float>(height - 2));
    cell.fe = e - le;
    cell.fu = u - lu;
    cell.offset = cell.valid
        ? static_cast<Index>(static_cast<int>(lu)) * width + static_cast<int>(le)
        : 0;
    return cell;
}

// VJP of the forward for cotangent g [M, H, W]. The derivative factors are
// one-hot (-1 at the lower cell, +1 at the upper), not the tent's one-sided
// slope, so exact-integer coordinates keep (-1, +1). dw does not depend on w:
// zero-weight in-bounds rays still get it. Invalid rays get zeros and read
// nothing from g.
//
// The M x N rays are one flat sequence. Warp v takes rays [32 kRays v,
// 32 kRays (v + 1)), its lane l the rays l + 32 k: every warp-wide load, a
// tap's included, covers 32 consecutive rays, which fall near each other on
// the map, and no alignment is needed (any storage offset, any N). A thread
// issues its 3 kRays stream loads, then its 4 kRays taps, before it uses one.
// It finds its map with one division and steps to the next map where its
// rays cross one. Index is int where every flat index of the streams and of g
// fits (kWide false): 64-bit index math costs 13-19% on dense maps (PERF.md).
template <int kRays, bool kWide>
__global__ void __launch_bounds__(kThreads) splat_backward_kernel(
    const float* __restrict__ e, const float* __restrict__ u, const float* __restrict__ w,
    const float* __restrict__ g, float* __restrict__ grad_e, float* __restrict__ grad_u,
    float* __restrict__ grad_w, int64_t total, int64_t rays_per_map, int64_t warps, int height, int width) {
    using Index = typename std::conditional<kWide, int64_t, int>::type;
    const Index n = static_cast<Index>(total);
    const Index per_map = static_cast<Index>(rays_per_map);
    const Index map_size = static_cast<Index>(height) * width;
    const Index lane = threadIdx.x % kWarp;
    const Index stride = static_cast<Index>(gridDim.x) * (kThreads / kWarp);
    for (Index warp = (static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
         warp < static_cast<Index>(warps); warp += stride) {
        const Index start = warp * (kWarp * kRays) + lane;
        float re[kRays], ru[kRays], rw[kRays];
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
            const Index i = start + k * kWarp;
            // A place past the sequence takes e = -1: invalid, it reads nothing.
            re[k] = i < n ? e[i] : -1.0f;
            ru[k] = i < n ? u[i] : 0.0f;
            rw[k] = i < n ? w[i] : 0.0f;
        }

        Index map = start / per_map;
        Index ray = start - map * per_map;
        bool valid[kRays];
        float fe[kRays], fu[kRays];
        float g00[kRays], g01[kRays], g10[kRays], g11[kRays];
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
            const Cell<Index> cell = locate<Index>(re[k], ru[k], height, width);
            valid[k] = cell.valid;
            fe[k] = cell.fe;
            fu[k] = cell.fu;
            const float* tap = g + map * map_size + cell.offset;
            g00[k] = cell.valid ? __ldg(tap) : 0.0f;
            g01[k] = cell.valid ? __ldg(tap + 1) : 0.0f;
            g10[k] = cell.valid ? __ldg(tap + width) : 0.0f;
            g11[k] = cell.valid ? __ldg(tap + width + 1) : 0.0f;
            if (k + 1 < kRays) {
                for (ray += kWarp; ray >= per_map; ray -= per_map) ++map;
            }
        }

#pragma unroll
        for (int k = 0; k < kRays; ++k) {
            const Index i = start + k * kWarp;
            if (i >= n) break;
            const float a = fe[k], b = fu[k];
            const float dw = (1.0f - b) * (1.0f - a) * g00[k] + (1.0f - b) * a * g01[k] +
                             b * (1.0f - a) * g10[k] + b * a * g11[k];
            const float de = rw[k] * ((1.0f - b) * (g01[k] - g00[k]) + b * (g11[k] - g10[k]));
            const float du = rw[k] * ((1.0f - a) * (g10[k] - g00[k]) + a * (g11[k] - g01[k]));
            grad_e[i] = valid[k] ? de : 0.0f;
            grad_u[i] = valid[k] ? du : 0.0f;
            grad_w[i] = valid[k] ? dw : 0.0f;
        }
    }
}

template <int kRays, bool kWide>
cudaError_t launch_backward(const float* e, const float* u, const float* w, const float* g, float* grad_e,
                            float* grad_u, float* grad_w, int64_t total, int64_t rays_per_map, int height,
                            int width, cudaStream_t stream) {
    const int64_t warps = (total + kWarp * kRays - 1) / (kWarp * kRays);
    const int64_t blocks = (warps * kWarp + kThreads - 1) / kThreads;
    splat_backward_kernel<kRays, kWide><<<static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks),
                                          kThreads, 0, stream>>>(
        e, u, w, g, grad_e, grad_u, grad_w, total, rays_per_map, warps, height, width);
    return cudaGetLastError();
}

// The gather on M maps of N rays. With force_wide, 64-bit indices whatever the
// sizes: the instantiation that only more than 2^31 rays or cotangent elements
// reach otherwise, which chip_smoke.py checks through splat_backward_wide.
cudaError_t backward(const float* e, const float* u, const float* w, const float* g, float* grad_e,
                     float* grad_u, float* grad_w, int64_t num_maps, int64_t rays_per_map, int height,
                     int width, int device, void* stream, bool force_wide) {
    cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return status;
    const int64_t total = num_maps * rays_per_map;
    if (total == 0) return cudaSuccess;
    // A thread takes kDenseRays rays where a map's rays are dense on it, one where they
    // are sparse: there more gathers in flight cost more than they hide (PERF.md).
    const bool sparse = rays_per_map * kSparseShare < static_cast<int64_t>(height) * width;
    // int indices where the streams and g fit, with the slack of a warp's last rays.
    const int64_t slack = static_cast<int64_t>(kWarp) * kDenseRays;
    const int64_t map_size = static_cast<int64_t>(height) * width;
    const bool wide = force_wide || total + slack > 0x7fffffff || (num_maps + slack) * map_size > 0x7fffffff;
    const auto launch = sparse ? (wide ? &launch_backward<1, true> : &launch_backward<1, false>)
                               : (wide ? &launch_backward<kDenseRays, true> : &launch_backward<kDenseRays, false>);
    return launch(e, u, w, g, grad_e, grad_u, grad_w, total, rays_per_map, height, width,
                  static_cast<cudaStream_t>(stream));
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
    return static_cast<int>(backward(e, u, w, g, grad_e, grad_u, grad_w, num_maps, rays_per_map, height, width,
                                     device, stream, false));
}

extern "C" int splat_backward_wide(const float* e, const float* u, const float* w, const float* g,
                                   float* grad_e, float* grad_u, float* grad_w,
                                   int64_t num_maps, int64_t rays_per_map, int height, int width,
                                   int device, void* stream) {
    return static_cast<int>(backward(e, u, w, g, grad_e, grad_u, grad_w, num_maps, rays_per_map, height, width,
                                     device, stream, true));
}

extern "C" const char* splat_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
