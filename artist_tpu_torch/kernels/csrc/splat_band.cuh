// The forward of the bilinear splat with each heliostat's map held in shared
// memory, band by band: hand-written CUDA for Hopper (sm_90a), shared by
// splat.cu (rows 1 and 14, Plan = kNoWindows) and splat_window.cu (row 3,
// kRowWindows; row 13, kTileWindows). splat.cu's head note gives the design
// and its measurements, splat_window.cu's those of the windows.
//
// Grid: (bands, heliostats). The block of band b holds rows [b * band_rows,
// (b + 1) * band_rows) of heliostat m's map in shared memory, reads every ray
// of m (a few a thread at a time, all their u before any e or w), adds
// the taps that land in its rows with shared-memory atomics, and stores the
// band whole: no other block writes those pixels, so the map needs no zeroing
// and no global atomic. A ray whose two tap rows straddle a band border adds
// its upper row in one band and its lower row in the next. The rays are read
// in the order of the stream; the sum does not depend on it.
//
// Windows (Plan != kNoWindows): the rays of a heliostat also form a sequence,
// cut into blocks of `block` rays, and each block gets the TPU kernels'
// dynamic window: ou = floor(least valid u) rounded down to a multiple of 8
// and clamped to [0, H - window]; with kTileWindows also oe = floor(least
// valid e) rounded down to a multiple of 128 and clamped to [0, W - window_e].
// The block fits when its largest valid u <= ou + window - 2 (and largest
// valid e <= oe + window_e - 2); a block with no valid ray fits. Only the
// count of fitting blocks leaves the kernel: with the map on chip, every
// deposit lands in its rows whether its block fits or not. The block of band b
// plans the b-th of `bands` equal runs of ray blocks, keeping their least and
// largest valid coordinates in shared memory as the bits of non-negative
// floats (a valid ray has u, e >= 0; +0.0 turns -0.0 into +0.0), which order as
// ints. After the accumulate it adds its count of fitting blocks to its own
// entry of fitting[bands * gridDim.y], which it zeroes first: the count is
// their sum, and the caller zeroes nothing.
//
// kRowWindows (row 3) reads the rays where the render step makes them: a
// stream holds `rays_per_point` (r) rows of P = N / r points, ray (j, p) at
// j * P + p, and the sequence takes point order[0]'s r rays, then
// order[1]'s, and so on (without an order, points 0, 1, ...). A ray block is
// then scattered over the stream: 32 rays in place fall in 2.4 blocks at the
// block-window step's chunk. So the accumulate reads the stream in place,
// with row 1's loop, and a separate pass after it plans, a warp a planned
// block: each lane takes 8 rays of the sequence 32 apart, loads their points'
// order entries and then their u and e, and the warp reduces the block's
// extents, which it alone writes. The pass reads what the accumulate read
// again, from L2, through the order (6.8 lines of 128 bytes a warp's 32 rays).
// kTileWindows (row 13) takes [M, N] rays whose blocks are runs of
// consecutive rays, and plans inside the accumulate, reading each ray once:
// its threads take 8 rays 32 apart, so that a warp's step lies in one ray
// block, which the warp reduces once; a step that straddles two blocks adds
// ray by ray with shared atomics.

#pragma once

#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBandThreads = 1024;
constexpr int kRowAlignment = 8;
constexpr int kColumnAlignment = 128;
constexpr unsigned kAllLanes = 0xffffffffu;

// What band_accumulate_kernel plans besides its accumulate.
enum WindowPlan : int {
    kNoWindows = 0,    // nothing: the full splat
    kRowWindows = 1,   // each ray block's row window (row 3)
    kTileWindows = 2,  // each ray block's row and column window (row 13)
};

// The offset of an address in 4-byte words modulo 16 bytes.
__device__ __forceinline__ int word_phase(const float* address) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(address) >> 2) & 3);
}

__device__ __forceinline__ float band_warp_min(float x) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) x = fminf(x, __shfl_xor_sync(kAllLanes, x, s));
    return x;
}

__device__ __forceinline__ float band_warp_max(float x) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(kAllLanes, x, s));
    return x;
}

// The window origin of a block whose least valid coordinate is `least`: floor(least)
// rounded down to a multiple of `alignment`, clamped into [0, limit].
__device__ __forceinline__ int window_origin(float least, int alignment, int limit) {
    return min(max((static_cast<int>(floorf(least)) / alignment) * alignment, 0), limit);
}

template <int Plan>
__global__ void __launch_bounds__(kBandThreads) band_accumulate_kernel(
    const float* __restrict__ e, const float* __restrict__ u, const float* __restrict__ w,
    float* __restrict__ out, int* __restrict__ fitting, int64_t num_maps, int rays_per_map, int height,
    int width, int band_rows, int block, int window, const int* __restrict__ order, int rays_per_point,
    int window_e) {
    // The band, [band_rows, width] at the map's word phase; then, with windows, the planned
    // ray blocks' least and largest valid u (and e), as the bits of non-negative floats.
    extern __shared__ __align__(16) float band_memory[];
    constexpr bool kWindows = Plan != kNoWindows;
    constexpr int kExtents = Plan == kTileWindows ? 4 : 2;
    // kTileWindows plans inside the accumulate: its blocks are runs of consecutive rays.
    constexpr bool kFused = Plan == kTileWindows;
    // Rays a thread takes a step, all their u loaded before any e or w, and their stride:
    // kBandThreads apart, or 32 apart for the fused plan, so that a warp's step (256 rays)
    // lies in one ray block, which it plans with one reduction.
    constexpr int kRays = 8;
    constexpr int kStride = kFused ? 32 : kBandThreads;
    // Rays of the sequence a lane of the separate plan pass takes a step, 32 apart.
    constexpr int kPlanRays = 8;
    int* extents = reinterpret_cast<int*>(band_memory + band_rows * width + 4);
    const int bands = static_cast<int>(gridDim.x);
    const int band = static_cast<int>(blockIdx.x);
    const int row0 = band * band_rows;
    const int rows = min(band_rows, height - row0);
    const int size = rows * width;
    const int lane = threadIdx.x % 32;
    const int64_t map_size = static_cast<int64_t>(height) * width;
    // Windows: the run of ray blocks [first_planned, first_planned + planned) this block plans.
    const int blocks_per_map = kWindows ? (rays_per_map + block - 1) / block : 0;
    const int first_planned = kWindows ? band * blocks_per_map / bands : 0;
    const int planned = kWindows ? (band + 1) * blocks_per_map / bands - first_planned : 0;
    const int points = kWindows ? rays_per_map / rays_per_point : 0;
    // floor(u) of a valid ray with a tap row in the band; NaN fails both tests.
    const float lowest = static_cast<float>(max(row0 - 1, 0));
    const float highest = static_cast<float>(min(row0 + rows - 1, height - 2));
    const float last_row = static_cast<float>(height - 2);
    const float last_column = static_cast<float>(width - 2);
    int* tally = kWindows ? fitting + blockIdx.y * gridDim.x + blockIdx.x : nullptr;
    if (kWindows && threadIdx.x == 0) *tally = 0;  // before the first barrier below
    for (int64_t m = blockIdx.y; m < num_maps; m += gridDim.y) {
        float* om = out + m * map_size + static_cast<int64_t>(row0) * width;
        const int phase = word_phase(om);
        float* tile = band_memory + phase;
        for (int i = threadIdx.x; i < size + 4; i += kBandThreads) band_memory[i] = 0.0f;
        for (int i = threadIdx.x; kFused && i < planned; i += kBandThreads) {
            for (int k = 0; k < kExtents; k += 2) {
                extents[kExtents * i + k] = INT_MAX;
                extents[kExtents * i + k + 1] = -1;
            }
        }
        __syncthreads();
        const float* em = e + m * rays_per_map;
        const float* um = u + m * rays_per_map;
        const float* wm = w + m * rays_per_map;
        // Each step, a thread takes the rays base + kStride k, k < kRays, and the warp's lowest
        // is base - lane. Whole warps step, so that the warp-wide reductions below see every lane.
        for (int base = kStride == 32 ? (threadIdx.x / 32) * 32 * kRays + lane : threadIdx.x;
             base - lane < rays_per_map; base += kBandThreads * kRays) {
            float ray_u[kRays], ray_e[kRays], weight[kRays];
            bool ours[kRays], plan[kRays];
            // kFused: the planned block that holds all the warp's rays of this step, -1 when
            // none of them is planned here, -2 when they straddle blocks (each ray then finds its own).
            int slot = -1;
            if (kFused) {
                const int low = base - lane, high = min(low + 32 * kRays, rays_per_map) - 1;
                const int first = low / block - first_planned;
                slot = first != high / block - first_planned ? -2 : first >= 0 && first < planned ? first : -1;
            }
#pragma unroll
            for (int k = 0; k < kRays; ++k) {
                const int r = base + kStride * k;
                ray_u[k] = r < rays_per_map ? um[r] : -1.0f;
                plan[k] = kFused && r < rays_per_map && slot != -1;
                if (kFused && slot == -2 && plan[k]) {
                    const int own = r / block - first_planned;
                    plan[k] = own >= 0 && own < planned;
                }
            }
#pragma unroll
            for (int k = 0; k < kRays; ++k) {
                const int r = base + kStride * k;
                const float lu = floorf(ray_u[k]);
                ours[k] = lu >= lowest && lu <= highest;
                ray_e[k] = ours[k] || plan[k] ? em[r] : -1.0f;
                weight[k] = ours[k] ? wm[r] : 0.0f;
            }
#pragma unroll
            for (int k = 0; k < kRays; ++k) {
                const float lu = floorf(ray_u[k]);
                const float le = floorf(ray_e[k]);
                if (!(ours[k] && le >= 0.0f && le <= last_column)) continue;
                const float fe = ray_e[k] - le, fu = ray_u[k] - lu;
                const int row = static_cast<int>(lu) - row0;  // -1 when only the lower tap row is ours
                const int col = static_cast<int>(le);
                if (row >= 0) {
                    float* target = tile + row * width + col;
                    atomicAdd(target, weight[k] * (1.0f - fu) * (1.0f - fe));
                    atomicAdd(target + 1, weight[k] * (1.0f - fu) * fe);
                }
                if (row + 1 < rows) {
                    float* target = tile + (row + 1) * width + col;
                    atomicAdd(target, weight[k] * fu * (1.0f - fe));
                    atomicAdd(target + 1, weight[k] * fu * fe);
                }
            }
            if (kFused && slot != -1) {
                // Least and largest valid u, then e: coordinates k of the extents.
                int least[2] = {INT_MAX, INT_MAX}, most[2] = {-1, -1};
#pragma unroll
                for (int k = 0; k < kRays; ++k) {
                    const float lu = floorf(ray_u[k]), le = floorf(ray_e[k]);
                    if (!(plan[k] && le >= 0.0f && le <= last_column && lu >= 0.0f && lu <= last_row)) continue;
                    const int bits[2] = {__float_as_int(ray_u[k] + 0.0f), __float_as_int(ray_e[k] + 0.0f)};
                    if (slot >= 0) {
                        for (int c = 0; c < 2; ++c) {
                            least[c] = min(least[c], bits[c]);
                            most[c] = max(most[c], bits[c]);
                        }
                    } else {
                        const int own = (base + kStride * k) / block - first_planned;
                        for (int c = 0; c < 2; ++c) {
                            atomicMin(extents + kExtents * own + 2 * c, bits[c]);
                            atomicMax(extents + kExtents * own + 2 * c + 1, bits[c]);
                        }
                    }
                }
                if (slot >= 0) {
                    for (int c = 0; c < 2; ++c) {
                        least[c] = __reduce_min_sync(kAllLanes, least[c]);
                        most[c] = __reduce_max_sync(kAllLanes, most[c]);
                    }
                    if (lane == 0 && most[0] >= 0) {
                        for (int c = 0; c < 2; ++c) {
                            atomicMin(extents + kExtents * slot + 2 * c, least[c]);
                            atomicMax(extents + kExtents * slot + 2 * c + 1, most[c]);
                        }
                    }
                }
            }
        }
        if (Plan == kRowWindows) {
            // The separate plan pass, a warp a planned block; the warp alone writes its extents.
            for (int i = threadIdx.x / 32; i < planned; i += kBandThreads / 32) {
                const int first = (first_planned + i) * block;
                const int last = min(first + block, rays_per_map);
                float least = INFINITY, most = -INFINITY;
                for (int s = first + lane; s < last; s += 32 * kPlanRays) {
                    int ray[kPlanRays];
#pragma unroll
                    for (int k = 0; k < kPlanRays; ++k) {
                        const int sequence = s + 32 * k;
                        const int point = sequence / rays_per_point;
                        // An order entry outside [0, P) reads nothing: its rays leave the plan.
                        const int p = sequence >= last ? -1 : order ? order[point] : point;
                        ray[k] = p < 0 || p >= points ? -1 : (sequence - point * rays_per_point) * points + p;
                    }
                    float ray_u[kPlanRays], ray_e[kPlanRays];
#pragma unroll
                    for (int k = 0; k < kPlanRays; ++k) {
                        ray_u[k] = ray[k] >= 0 ? um[ray[k]] : -1.0f;
                        ray_e[k] = ray[k] >= 0 ? em[ray[k]] : -1.0f;
                    }
#pragma unroll
                    for (int k = 0; k < kPlanRays; ++k) {
                        const float lu = floorf(ray_u[k]), le = floorf(ray_e[k]);
                        if (!(le >= 0.0f && le <= last_column && lu >= 0.0f && lu <= last_row)) continue;
                        least = fminf(least, ray_u[k]);
                        most = fmaxf(most, ray_u[k]);
                    }
                }
                least = band_warp_min(least);
                most = band_warp_max(most);
                if (lane == 0) {
                    extents[2 * i] = most >= 0.0f ? __float_as_int(least + 0.0f) : INT_MAX;
                    extents[2 * i + 1] = most >= 0.0f ? __float_as_int(most + 0.0f) : -1;
                }
            }
        }
        __syncthreads();  // every tap and extent has landed
        if (kWindows) {
            int fits = 0;
            for (int i = threadIdx.x; i < planned; i += kBandThreads) {
                const int* extent = extents + kExtents * i;
                bool fit = true;  // a block with no valid ray fits at offset 0
                if (extent[1] >= 0) {
                    const int ou = window_origin(__int_as_float(extent[0]), kRowAlignment, height - window);
                    fit = __int_as_float(extent[1]) <= static_cast<float>(ou + window - 2);
                    if (Plan == kTileWindows) {
                        const int oe = window_origin(__int_as_float(extent[2]), kColumnAlignment, width - window_e);
                        fit = fit && __int_as_float(extent[3]) <= static_cast<float>(oe + window_e - 2);
                    }
                }
                fits += fit;
            }
            fits = __reduce_add_sync(kAllLanes, fits);
            if (lane == 0 && fits) atomicAdd(tally, fits);
        }
        // The band is this block's alone: store it whole, 16 bytes a thread where aligned.
        const int head = min(size, (4 - phase) & 3);
        const int quads = (size - head) / 4;
        if (threadIdx.x < head) om[threadIdx.x] = tile[threadIdx.x];
        for (int q = threadIdx.x; q < quads; q += kBandThreads)
            *reinterpret_cast<float4*>(om + head + 4 * q) = *reinterpret_cast<const float4*>(tile + head + 4 * q);
        const int tail = head + 4 * quads + threadIdx.x;
        if (tail < size) om[tail] = tile[tail];
        __syncthreads();  // the band and the extents are read before the next heliostat writes them
    }
}

// Launches band_accumulate_kernel<Plan> on `stream`, after opting it in to its shared
// memory, or refuses with cudaErrorInvalidValue when that exceeds the card's per-block
// limit, a map has more rays than 32-bit ray indices reach, or a plan's sizes are not
// positive or r does not divide the rays of a map. `order` (P = N / r entries, or null)
// and `rays_per_point` cut the sequence of ray blocks; `window_e` is kTileWindows's.
template <int Plan>
cudaError_t launch_band_accumulate(const float* e, const float* u, const float* w, float* out, int* fitting,
                                   int64_t num_maps, int64_t rays_per_map, int height, int width,
                                   int band_rows, int block, int window, const int* order, int rays_per_point,
                                   int window_e, int device, cudaStream_t stream) {
    if (band_rows < 1 || rays_per_map > INT_MAX - 8 * kBandThreads) return cudaErrorInvalidValue;
    if (Plan != kNoWindows && (block < 1 || rays_per_point < 1 || rays_per_map % rays_per_point))
        return cudaErrorInvalidValue;
    const int bands = (height + band_rows - 1) / band_rows;
    const int64_t planned = Plan ? ((rays_per_map + block - 1) / block + bands - 1) / bands : 0;  // at most
    const size_t bytes = sizeof(float) * (static_cast<size_t>(band_rows) * width + 4) +
                         sizeof(int) * (Plan == kTileWindows ? 4 : 2) * planned;
    int limit = 0;
    cudaError_t status = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (status != cudaSuccess) return status;
    if (bytes > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
    status = cudaFuncSetAttribute(band_accumulate_kernel<Plan>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(bytes));
    if (status != cudaSuccess) return status;
    const dim3 grid(static_cast<unsigned>(bands), static_cast<unsigned>(num_maps < 65535 ? num_maps : 65535), 1);
    band_accumulate_kernel<Plan><<<grid, kBandThreads, bytes, stream>>>(
        e, u, w, out, fitting, num_maps, static_cast<int>(rays_per_map), height, width, band_rows, block, window,
        order, rays_per_point, window_e);
    return cudaGetLastError();
}

}  // namespace
