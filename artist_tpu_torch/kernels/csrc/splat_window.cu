// Dynamic-window bilinear splat and its vector-Jacobian product, and the
// 2-D window forward of the splat-formulation tool: hand-written CUDA for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   band_accumulate_kernel<true>        <- _dyn_fwd_kernel
//       (artist_tpu/kernels/splat_pallas.py, via _dyn_forward,
//        bilinear_splat_dynamic_window); the kernel is in splat_band.cuh
//   dynamic_window_backward_kernel      <- _dyn_bwd_kernel (via _dyn_bwd)
//   dynamic_window_forward_kernel<true> <- _dyn2d_fwd_kernel
//       (tools/splat_formulation_bench.py, via dyn2d_forward)
//
// Semantics: the 4-tap splat of splat.cu (strict bounds tested in float
// before any int cast, so NaN, +-inf and 1e30 are invalid; the (-1, +1)
// one-hot derivative factors; dw independent of w; zeros for invalid rays).
// The rays of each heliostat are cut into blocks of `block` rays; each block
// has a window: rows [ou, ou + window_u) and, for the 2-D variant, columns
// [oe, oe + window_e). ou is floor(min u) over the block's valid rays, rounded
// down to a multiple of 8 and clamped to [0, H - window_u]; oe likewise to a
// multiple of 128 in [0, W - window_e]. The block fits when
// max u <= ou + window_u - 2 (and max e <= oe + window_e - 2), which covers
// the deposit rows floor(u) and floor(u) + 1. A block with no valid ray fits
// at offset 0. Validity is the in-bounds test, not w > 0: a zero-weight ray
// still gets dw and so must lie inside its window. These are the TPU
// kernels' offsets (_dyn_offsets, and the tool's dyn2d_forward) exactly.
//
// The row-window forward (row 3). On the TPU the heliostat's whole map stays
// in VMEM across its ray blocks, and the window cuts each block's one-hot
// matmul to the window's rows; a block that does not fit takes all rows.
// band_accumulate_kernel<true> keeps the map on chip the same way (in bands
// of rows, one thread block each; see splat.cu), so every deposit lands in its
// rows there, those of its block's window when the block fits and the map's
// when it falls back: with a per-tap scatter there is no matmul for the window
// to cut. The kernel still derives every block's window from its valid rays,
// as plan_block does, and counts the fitting blocks on the device: the block
// of band b plans the b-th of equal runs of ray blocks, each warp reducing
// its 128 rays a step (4 rays 32 apart a thread, so that a step stays in one
// ray block). Step 0 at the block-window step's first chunk: 3,892 of 4,000
// blocks fit, but a heliostat's fitting blocks change origin 23-36 times
// (runs of 1.33 blocks on average), so a 96-row tile kept across blocks of
// one origin saved little; such walkers measured 0.14-0.29 ms (PERF.md).
//   2-D forward (row 13, the tool's), one thread block a ray block: it
//   reduces its valid rays' extents (plan_block), adds a fitting block's rays
//   into a [window_u, window_e] tile (96 x 128 = 48 KB) with shared-memory
//   atomics, zeroing and then flushing only the touched rectangle, one
//   global atomicAdd a non-zero pixel; a block that does not fit adds
//   straight into the map. It counts fitting blocks on the device.
//   Backward (row 4), fitting block: the touched rectangle of the cotangent
//   is copied into shared memory with cp.async and the rays gather their four
//   taps there; a fallback block gathers from device memory. Deterministic.
//
// Bound on the H100: bytes, as splat.cu's kernels: per ray 12 bytes read
// (forward) or 24 moved (backward) against 14 or 29 fp32 operations.
// Measured by chip_smoke.py on an H100 80GB HBM3 (700 W limit) at the
// flagship chunk reordered point-major ([100, 40000] rays, 4 rays a point):
// row-window forward 0.1069-0.1071 ms (the previous design, one block a ray
// block with a scalar flush, 0.2038-0.2063 in the same runs; splat.cu's
// forward 0.103 on the same rays; index_add_ 0.200-0.206; bound 0.022).
// Backward 0.101 ms against splat.cu's 0.048 ms: two 96 KB blocks an SM
// leave it 16 warps to hide its gathers' latency. At the formulation tool's
// 32 M rays the 2-D forward takes 0.72 ms against index_add_'s 1.55 ms.
//
// Interface: plain C, loaded with ctypes. The caller allocates every buffer
// (the 2-D forward's output and every counter already zeroed) and passes
// PyTorch's current stream; each launch function returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue when the tile or the band does
// not fit shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "splat_band.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;
constexpr int kRowAlign = 8;
constexpr int kColumnAlign = 128;

struct Cell {
    bool valid;
    int le, lu;  // lower column and row
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
    cell.le = cell.valid ? static_cast<int>(le) : 0;
    cell.lu = cell.valid ? static_cast<int>(lu) : 0;
    return cell;
}

// A ray block's window: whether it fits, its origin, and the rectangle its
// deposits touch in window coordinates (inclusive; empty when row_lo > row_hi).
struct Plan {
    int fits;
    int ou, oe;
    int row_lo, row_hi, col_lo, col_hi;
};

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, s));
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
    return x;
}

// Every thread of the block calls this; on return `plan` holds the block's
// window for rays [first, last) of one heliostat.
template <bool ColumnWindow>
__device__ void plan_block(const float* __restrict__ e, const float* __restrict__ u,
                           int64_t first, int64_t last, int height, int width,
                           int window_u, int window_e, Plan* plan, float* scratch) {
    float min_u = INFINITY, max_u = -INFINITY, min_e = INFINITY, max_e = -INFINITY;
    for (int64_t r = first + threadIdx.x; r < last; r += kThreads) {
        const float ray_e = e[r], ray_u = u[r];
        if (locate(ray_e, ray_u, height, width).valid) {
            min_u = fminf(min_u, ray_u);
            max_u = fmaxf(max_u, ray_u);
            min_e = fminf(min_e, ray_e);
            max_e = fmaxf(max_e, ray_e);
        }
    }
    min_u = warp_min(min_u);
    max_u = warp_max(max_u);
    min_e = warp_min(min_e);
    max_e = warp_max(max_e);
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
        scratch[warp] = min_u;
        scratch[kWarps + warp] = max_u;
        scratch[2 * kWarps + warp] = min_e;
        scratch[3 * kWarps + warp] = max_e;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int k = 1; k < kWarps; ++k) {
            min_u = fminf(min_u, scratch[k]);
            max_u = fmaxf(max_u, scratch[kWarps + k]);
            min_e = fminf(min_e, scratch[2 * kWarps + k]);
            max_e = fmaxf(max_e, scratch[3 * kWarps + k]);
        }
        Plan p{1, 0, 0, 0, -1, 0, -1};
        if (min_u <= max_u) {  // some valid ray
            const int lu_min = static_cast<int>(floorf(min_u));
            const int lu_max = static_cast<int>(floorf(max_u));
            const int le_min = static_cast<int>(floorf(min_e));
            const int le_max = static_cast<int>(floorf(max_e));
            p.ou = min(max((lu_min / kRowAlign) * kRowAlign, 0), height - window_u);
            bool fits = max_u <= static_cast<float>(p.ou + window_u - 2);
            if (ColumnWindow) {
                p.oe = min(max((le_min / kColumnAlign) * kColumnAlign, 0), width - window_e);
                fits = fits && max_e <= static_cast<float>(p.oe + window_e - 2);
            }
            p.fits = fits ? 1 : 0;
            p.row_lo = lu_min - p.ou;
            p.row_hi = lu_max + 1 - p.ou;
            p.col_lo = le_min - p.oe;
            p.col_hi = le_max + 1 - p.oe;
        }
        *plan = p;
    }
    __syncthreads();
}

// Row 13 (ColumnWindow = true; row 3 took ColumnWindow = false until
// window_walk_kernel replaced it). Grid: (ray blocks per heliostat, heliostats).
template <bool ColumnWindow>
__global__ void __launch_bounds__(kThreads) dynamic_window_forward_kernel(
    const float* __restrict__ e, const float* __restrict__ u, const float* __restrict__ w,
    float* __restrict__ out, int* __restrict__ fitting, int64_t num_maps, int64_t rays_per_map,
    int height, int width, int block, int window_u, int window_e) {
    extern __shared__ float tile[];  // [window_u, tile_width]
    __shared__ float scratch[4 * kWarps];
    __shared__ Plan plan;
    const int tile_width = ColumnWindow ? window_e : width;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * block;
    const int64_t last = first + block < rays_per_map ? first + block : rays_per_map;
    const int64_t map_size = static_cast<int64_t>(height) * width;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int64_t m = blockIdx.y; m < num_maps; m += gridDim.y) {
        const float* em = e + m * rays_per_map;
        const float* um = u + m * rays_per_map;
        const float* wm = w + m * rays_per_map;
        float* om = out + m * map_size;
        plan_block<ColumnWindow>(em, um, first, last, height, width, window_u, window_e, &plan, scratch);
        const Plan p = plan;
        if (p.fits) {
            for (int row = p.row_lo + warp; row <= p.row_hi; row += kWarps)
                for (int col = p.col_lo + lane; col <= p.col_hi; col += 32)
                    tile[row * tile_width + col] = 0.0f;
            __syncthreads();
            for (int64_t r = first + threadIdx.x; r < last; r += kThreads) {
                const Cell c = locate(em[r], um[r], height, width);
                if (!c.valid) continue;
                const float weight = wm[r];
                float* base = tile + (c.lu - p.ou) * tile_width + (c.le - p.oe);
                atomicAdd(base, weight * (1.0f - c.fu) * (1.0f - c.fe));
                atomicAdd(base + 1, weight * (1.0f - c.fu) * c.fe);
                atomicAdd(base + tile_width, weight * c.fu * (1.0f - c.fe));
                atomicAdd(base + tile_width + 1, weight * c.fu * c.fe);
            }
            __syncthreads();
            for (int row = p.row_lo + warp; row <= p.row_hi; row += kWarps) {
                for (int col = p.col_lo + lane; col <= p.col_hi; col += 32) {
                    const float value = tile[row * tile_width + col];
                    if (value != 0.0f)
                        atomicAdd(om + static_cast<int64_t>(p.ou + row) * width + p.oe + col, value);
                }
            }
            if (threadIdx.x == 0) atomicAdd(fitting, 1);
        } else {
            for (int64_t r = first + threadIdx.x; r < last; r += kThreads) {
                const Cell c = locate(em[r], um[r], height, width);
                if (!c.valid) continue;
                const float weight = wm[r];
                float* base = om + static_cast<int64_t>(c.lu) * width + c.le;
                atomicAdd(base, weight * (1.0f - c.fu) * (1.0f - c.fe));
                atomicAdd(base + 1, weight * (1.0f - c.fu) * c.fe);
                atomicAdd(base + width, weight * c.fu * (1.0f - c.fe));
                atomicAdd(base + width + 1, weight * c.fu * c.fe);
            }
        }
        __syncthreads();  // the next heliostat reuses plan and tile
    }
}

__device__ __forceinline__ void cp_async_4(float* shared, const float* global) {
    const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(address), "l"(global));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// The four taps of a ray whose lower-left tap is base[0] in a map of row
// stride `stride`: (de, du, dw) as splat.cu's backward computes them.
__device__ __forceinline__ void tap_cotangents(const float* base, int stride, float weight,
                                               float fe, float fu, float& de, float& du, float& dw) {
    const float g00 = base[0];
    const float g01 = base[1];
    const float g10 = base[stride];
    const float g11 = base[stride + 1];
    dw = (1.0f - fu) * (1.0f - fe) * g00 + (1.0f - fu) * fe * g01 +
         fu * (1.0f - fe) * g10 + fu * fe * g11;
    de = weight * ((1.0f - fu) * (g01 - g00) + fu * (g11 - g10));
    du = weight * ((1.0f - fe) * (g10 - g00) + fe * (g11 - g01));
}

// Row 4: the VJP of the row-window forward for cotangent g [M, H, W].
__global__ void __launch_bounds__(kThreads) dynamic_window_backward_kernel(
    const float* __restrict__ e, const float* __restrict__ u, const float* __restrict__ w,
    const float* __restrict__ g, float* __restrict__ grad_e, float* __restrict__ grad_u,
    float* __restrict__ grad_w, int64_t num_maps, int64_t rays_per_map, int height, int width,
    int block, int window) {
    extern __shared__ float tile[];  // [window, width]: the touched rows of g
    __shared__ float scratch[4 * kWarps];
    __shared__ Plan plan;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * block;
    const int64_t last = first + block < rays_per_map ? first + block : rays_per_map;
    const int64_t map_size = static_cast<int64_t>(height) * width;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int64_t m = blockIdx.y; m < num_maps; m += gridDim.y) {
        const int64_t offset = m * rays_per_map;
        const float* gm = g + m * map_size;
        plan_block<false>(e + offset, u + offset, first, last, height, width, window, 0, &plan, scratch);
        const Plan p = plan;
        if (p.fits) {
            for (int row = p.row_lo + warp; row <= p.row_hi; row += kWarps)
                for (int col = p.col_lo + lane; col <= p.col_hi; col += 32)
                    cp_async_4(tile + row * width + col, gm + static_cast<int64_t>(p.ou + row) * width + col);
            cp_async_wait_all();
            __syncthreads();
        }
        for (int64_t r = first + threadIdx.x; r < last; r += kThreads) {
            const int64_t i = offset + r;
            const Cell c = locate(e[i], u[i], height, width);
            float de = 0.0f, du = 0.0f, dw = 0.0f;
            if (c.valid) {
                if (p.fits)
                    tap_cotangents(tile + (c.lu - p.ou) * width + c.le, width, w[i], c.fe, c.fu, de, du, dw);
                else
                    tap_cotangents(gm + static_cast<int64_t>(c.lu) * width + c.le, width, w[i], c.fe, c.fu,
                                   de, du, dw);
            }
            grad_e[i] = de;
            grad_u[i] = du;
            grad_w[i] = dw;
        }
        __syncthreads();  // the next heliostat reuses plan and tile
    }
}

dim3 grid_for(int64_t num_maps, int64_t rays_per_map, int block) {
    const int64_t blocks_x = (rays_per_map + block - 1) / block;
    const int64_t blocks_y = num_maps < kMaxGridY ? num_maps : kMaxGridY;
    return dim3(static_cast<unsigned>(blocks_x), static_cast<unsigned>(blocks_y), 1);
}

// Opt the kernel in to `bytes` of dynamic shared memory, or refuse if the
// card's per-block limit cannot hold them beside the kernel's static ones.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes, int device) {
    int limit = 0;
    cudaError_t status = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (status != cudaSuccess) return status;
    cudaFuncAttributes attributes;
    status = cudaFuncGetAttributes(&attributes, kernel);
    if (status != cudaSuccess) return status;
    if (bytes + attributes.sharedSizeBytes > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

}  // namespace

extern "C" int splat_window_shared_limit(int device, int* bytes) {
    return static_cast<int>(cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

extern "C" int splat_window_band_forward(const float* e, const float* u, const float* w, float* out, int* fitting,
                                         int64_t num_maps, int64_t rays_per_map, int height, int width,
                                         int band_rows, int block, int window, int device, void* stream) {
    cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return static_cast<int>(status);
    return static_cast<int>(launch_band_accumulate<true>(e, u, w, out, fitting, num_maps, rays_per_map, height,
                                                         width, band_rows, block, window, device,
                                                         static_cast<cudaStream_t>(stream)));
}

extern "C" int splat_window_forward(const float* e, const float* u, const float* w, float* out,
                                    int* fitting, int64_t num_maps, int64_t rays_per_map, int height,
                                    int width, int block, int window_u, int window_e, int device, void* stream) {
    cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return static_cast<int>(status);
    const size_t bytes = sizeof(float) * static_cast<size_t>(window_u) * window_e;
    status = allow_shared(dynamic_window_forward_kernel<true>, bytes, device);
    if (status != cudaSuccess) return static_cast<int>(status);
    dynamic_window_forward_kernel<true><<<grid_for(num_maps, rays_per_map, block), kThreads, bytes,
                                          static_cast<cudaStream_t>(stream)>>>(
        e, u, w, out, fitting, num_maps, rays_per_map, height, width, block, window_u, window_e);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int splat_window_backward(const float* e, const float* u, const float* w, const float* g,
                                     float* grad_e, float* grad_u, float* grad_w, int64_t num_maps,
                                     int64_t rays_per_map, int height, int width, int block, int window,
                                     int device, void* stream) {
    cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return static_cast<int>(status);
    const size_t bytes = sizeof(float) * static_cast<size_t>(window) * width;
    status = allow_shared(dynamic_window_backward_kernel, bytes, device);
    if (status != cudaSuccess) return static_cast<int>(status);
    dynamic_window_backward_kernel<<<grid_for(num_maps, rays_per_map, block), kThreads, bytes,
                                     static_cast<cudaStream_t>(stream)>>>(
        e, u, w, g, grad_e, grad_u, grad_w, num_maps, rays_per_map, height, width, block, window);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_window_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
