// The forward of the bilinear splat with each heliostat's map held in shared
// memory, band by band: hand-written CUDA for Hopper (sm_90a), shared by
// splat.cu (rows 1 and 14, Windows = false) and splat_window.cu (row 3,
// Windows = true). splat.cu's head note gives the design and its measurements.
//
// Grid: (bands, heliostats). The block of band b holds rows [b * band_rows,
// (b + 1) * band_rows) of heliostat m's map in shared memory, reads every ray
// of m (a few a thread at a time, all their u before any e or w), adds
// the taps that land in its rows with shared-memory atomics, and stores the
// band whole: no other block writes those pixels, so the map needs no zeroing
// and no global atomic. A ray whose two tap rows straddle a band border adds
// its upper row in one band and its lower row in the next.
//
// Windows: the rays are also cut into blocks of `block` rays, and each block
// gets the dynamic window of splat_window.cu's plan_block: ou = floor(least
// valid u) rounded down to a multiple of 8 and clamped to [0, H - window];
// the block fits when its largest valid u <= ou + window - 2 (a block with no
// valid ray fits). The block of band b plans the b-th of `bands` equal runs of
// ray blocks, keeping their least and largest valid u in shared memory as the
// bits of non-negative floats (a valid ray has u >= 0; +0.0 turns -0.0 into
// +0.0), which order as ints, and adds its fitting blocks to *fitting.

#pragma once

#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBandThreads = 1024;
constexpr int kRowAlignment = 8;
constexpr unsigned kAllLanes = 0xffffffffu;

// The offset of an address in 4-byte words modulo 16 bytes.
__device__ __forceinline__ int word_phase(const float* address) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(address) >> 2) & 3);
}

template <bool Windows>
__global__ void __launch_bounds__(kBandThreads) band_accumulate_kernel(
    const float* __restrict__ e, const float* __restrict__ u, const float* __restrict__ w,
    float* __restrict__ out, int* __restrict__ fitting, int64_t num_maps, int rays_per_map, int height,
    int width, int band_rows, int block, int window) {
    // The band, [band_rows, width] at the map's word phase; then, with Windows, the planned
    // ray blocks' least and largest valid u.
    extern __shared__ __align__(16) float band_memory[];
    // Rays a thread takes a step, all their u loaded before any e or w, and their stride:
    // the full splat's 8 rays kBandThreads apart; the window's 4 rays 32 apart, so that a
    // warp's step lies in one ray block, which it plans with one reduction.
    constexpr int kRays = Windows ? 4 : 8;
    constexpr int kStride = Windows ? 32 : kBandThreads;
    int* extents = reinterpret_cast<int*>(band_memory + band_rows * width + 4);
    const int bands = static_cast<int>(gridDim.x);
    const int band = static_cast<int>(blockIdx.x);
    const int row0 = band * band_rows;
    const int rows = min(band_rows, height - row0);
    const int size = rows * width;
    const int lane = threadIdx.x % 32;
    const int64_t map_size = static_cast<int64_t>(height) * width;
    // Windows: the run of ray blocks [first_planned, first_planned + planned) this block plans.
    const int blocks_per_map = Windows ? (rays_per_map + block - 1) / block : 0;
    const int first_planned = Windows ? band * blocks_per_map / bands : 0;
    const int planned = Windows ? (band + 1) * blocks_per_map / bands - first_planned : 0;
    // floor(u) of a valid ray with a tap row in the band; NaN fails both tests.
    const float lowest = static_cast<float>(max(row0 - 1, 0));
    const float highest = static_cast<float>(min(row0 + rows - 1, height - 2));
    const float last_row = static_cast<float>(height - 2);
    const float last_column = static_cast<float>(width - 2);
    for (int64_t m = blockIdx.y; m < num_maps; m += gridDim.y) {
        float* om = out + m * map_size + static_cast<int64_t>(row0) * width;
        const int phase = word_phase(om);
        float* tile = band_memory + phase;
        for (int i = threadIdx.x; i < size + 4; i += kBandThreads) band_memory[i] = 0.0f;
        for (int i = threadIdx.x; i < planned; i += kBandThreads) {
            extents[2 * i] = INT_MAX;
            extents[2 * i + 1] = -1;
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
            // Windows: the planned block that holds all the warp's rays of this step, -1 when
            // none of them is planned here, -2 when they straddle blocks (each ray then finds its own).
            int slot = -1;
            if (Windows) {
                const int low = base - lane, high = min(low + 32 * kRays, rays_per_map) - 1;
                const int first = low / block - first_planned;
                slot = first != high / block - first_planned ? -2 : first >= 0 && first < planned ? first : -1;
            }
#pragma unroll
            for (int k = 0; k < kRays; ++k) {
                const int r = base + kStride * k;
                ray_u[k] = r < rays_per_map ? um[r] : -1.0f;
                plan[k] = Windows && r < rays_per_map && slot != -1;
                if (Windows && slot == -2 && plan[k]) {
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
            if (Windows && slot != -1) {
                int least = INT_MAX, most = -1;
#pragma unroll
                for (int k = 0; k < kRays; ++k) {
                    const float lu = floorf(ray_u[k]), le = floorf(ray_e[k]);
                    if (!(plan[k] && le >= 0.0f && le <= last_column && lu >= 0.0f && lu <= last_row)) continue;
                    const int bits = __float_as_int(ray_u[k] + 0.0f);
                    if (slot >= 0) {
                        least = min(least, bits);
                        most = max(most, bits);
                    } else {
                        const int own = (base + kStride * k) / block - first_planned;
                        atomicMin(extents + 2 * own, bits);
                        atomicMax(extents + 2 * own + 1, bits);
                    }
                }
                if (slot >= 0) {
                    least = __reduce_min_sync(kAllLanes, least);
                    most = __reduce_max_sync(kAllLanes, most);
                    if (lane == 0 && most >= 0) {
                        atomicMin(extents + 2 * slot, least);
                        atomicMax(extents + 2 * slot + 1, most);
                    }
                }
            }
        }
        __syncthreads();  // every tap and extent has landed
        if (Windows) {
            int fits = 0;
            for (int i = threadIdx.x; i < planned; i += kBandThreads) {
                bool fit = true;  // a block with no valid ray fits at offset 0
                if (extents[2 * i + 1] >= 0) {
                    const int lu_min = static_cast<int>(floorf(__int_as_float(extents[2 * i])));
                    const int ou = min(max((lu_min / kRowAlignment) * kRowAlignment, 0), height - window);
                    fit = __int_as_float(extents[2 * i + 1]) <= static_cast<float>(ou + window - 2);
                }
                fits += fit;
            }
            fits = __reduce_add_sync(kAllLanes, fits);
            if (lane == 0 && fits) atomicAdd(fitting, fits);
        }
        // The band is this block's alone: store it whole, 16 bytes a thread where aligned.
        const int head = min(size, (4 - phase) & 3);
        const int quads = (size - head) / 4;
        if (threadIdx.x < head) om[threadIdx.x] = tile[threadIdx.x];
        for (int q = threadIdx.x; q < quads; q += kBandThreads)
            *reinterpret_cast<float4*>(om + head + 4 * q) = *reinterpret_cast<const float4*>(tile + head + 4 * q);
        const int tail = head + 4 * quads + threadIdx.x;
        if (tail < size) om[tail] = tile[tail];
        __syncthreads();  // the band is read before the next heliostat zeroes it
    }
}

// Launches band_accumulate_kernel<Windows> on `stream`, after opting it in to its
// shared memory, or refuses with cudaErrorInvalidValue when that exceeds the card's
// per-block limit or a map has more rays than 32-bit ray indices reach.
template <bool Windows>
cudaError_t launch_band_accumulate(const float* e, const float* u, const float* w, float* out, int* fitting,
                                   int64_t num_maps, int64_t rays_per_map, int height, int width,
                                   int band_rows, int block, int window, int device, cudaStream_t stream) {
    if (band_rows < 1 || rays_per_map > INT_MAX - 8 * kBandThreads || (Windows && block < 1))
        return cudaErrorInvalidValue;
    const int bands = (height + band_rows - 1) / band_rows;
    const int64_t planned = Windows ? ((rays_per_map + block - 1) / block + bands - 1) / bands : 0;  // at most
    const size_t bytes = sizeof(float) * (static_cast<size_t>(band_rows) * width + 4) + 2 * sizeof(int) * planned;
    int limit = 0;
    cudaError_t status = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (status != cudaSuccess) return status;
    if (bytes > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
    status = cudaFuncSetAttribute(band_accumulate_kernel<Windows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(bytes));
    if (status != cudaSuccess) return status;
    const dim3 grid(static_cast<unsigned>(bands), static_cast<unsigned>(num_maps < 65535 ? num_maps : 65535), 1);
    band_accumulate_kernel<Windows><<<grid, kBandThreads, bytes, stream>>>(
        e, u, w, out, fitting, num_maps, static_cast<int>(rays_per_map), height, width, band_rows, block, window);
    return cudaGetLastError();
}

}  // namespace
