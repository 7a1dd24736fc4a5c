// Per-ray accumulate of the bilinear splat into a whole heliostat map held
// on chip, one band of rows per thread block: hand-written CUDA for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   band_accumulate_kernel <- _scatter_kernel
//       (tools/splat_formulation_bench.py, via scatter_forward)
// which walks its rays one by one and adds each ray's four taps into the
// heliostat's whole [H, W] map resident in VMEM.
//
// Semantics: the forward of splat.cu (strict bounds tested in float before
// any int cast, so NaN, +-inf and 1e30 are invalid; fp32 deposits).
//
// Design. A map does not fit one block's shared memory at the flagship size
// (256 x 256 fp32 = 256 KB, against 227 KB a block), so it is cut into bands
// of band_rows rows (the caller picks them so that two 1024-thread blocks
// share an SM: 3 bands of 86 rows, 86 KB each, at 256 x 256), and a heliostat's
// rays into shares of rays_per_share. One block per (band, share, heliostat)
// zeroes its band in shared memory, reads every ray of its share, and keeps
// only the taps that land in its rows: a ray whose two tap rows straddle a
// band border adds its upper row in one band and its lower row in the other.
// The taps are shared-memory atomics on the block's own memory. It then adds
// the rows its taps touched to the heliostat's map in device memory, one
// global atomicAdd per non-zero pixel, so the shares of a band meet there in
// any order.
//
// Bound on the H100: bytes, as splat.cu's forward (12 bytes read a ray
// against 14 fp32 operations). What costs is the taps: shared-memory fp32
// atomicAdd is a compare-and-swap loop on Hopper (ATOMS.CAST.SPIN). Each
// band reads every ray of its share; a warp whose rays all miss the band,
// the common case for the tool's rays (a warp is one surface point's 32 rays
// with a 6 px jitter), skips its e and w loads. Measured by chip_smoke.py on
// an H100 SXM 80 GB (700 W limit) at the formulation tool's 32 M rays: 0.63 ms
// (3 bands x 10 shares x 100 heliostats), against index_add_'s 1.55 ms, the
// 2-D window forward's 0.72 ms and a 0.12 ms byte bound; the previous design,
// which held each map in a 2-block cluster and sent half the taps to the other
// block's shared memory, took 2.60 ms, 2.44 of them without its flush. Merging
// a warp's equal addresses before the atomic (__match_any_sync and a sum over
// the matching lanes) made it 1.2-2.6x slower at every band shape tried, and
// 86-row bands beat 128 and 64.
//
// Interface: plain C, loaded with ctypes. The caller allocates the output
// (zeroed) and passes PyTorch's current stream. The launch function returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue when a band
// does not fit shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxGridY = 65535;
constexpr unsigned kFullMask = 0xffffffffu;

// Grid: (bands x shares, heliostats); block x takes band x mod bands and
// share x / bands.
__global__ void __launch_bounds__(kThreads) band_accumulate_kernel(
    const float* __restrict__ e, const float* __restrict__ u, const float* __restrict__ w,
    float* __restrict__ out, int64_t num_maps, int64_t rays_per_map, int height, int width,
    int band_rows, int bands, int64_t rays_per_share) {
    extern __shared__ float band[];  // [band_rows, width]: this block's rows of the map
    __shared__ int touched[2];       // the first and last band row a tap landed in
    const int lane = threadIdx.x & 31;
    const int row0 = static_cast<int>(blockIdx.x % bands) * band_rows;
    const int rows = min(band_rows, height - row0);
    const int64_t first = static_cast<int64_t>(blockIdx.x / bands) * rays_per_share;
    const int64_t last = first + rays_per_share < rays_per_map ? first + rays_per_share : rays_per_map;
    const int64_t map_size = static_cast<int64_t>(height) * width;
    // floor(u) of a valid ray with a tap row in the band; NaN fails both tests.
    const float lowest = static_cast<float>(max(row0 - 1, 0));
    const float highest = static_cast<float>(min(row0 + rows - 1, height - 2));
    const float last_column = static_cast<float>(width - 2);
    for (int64_t m = blockIdx.y; m < num_maps; m += gridDim.y) {
        for (int i = threadIdx.x; i < rows * width; i += kThreads) band[i] = 0.0f;
        if (threadIdx.x == 0) {
            touched[0] = rows;
            touched[1] = -1;
        }
        __syncthreads();
        const float* em = e + m * rays_per_map;
        const float* um = u + m * rays_per_map;
        const float* wm = w + m * rays_per_map;
        int top = rows, bottom = -1;
        for (int64_t base = first; base < last; base += kThreads) {
            const int64_t r = base + threadIdx.x;
            bool upper = false, lower = false;  // whether the ray's upper, lower tap row is ours
            int row = 0, col = 0;
            float value[4];
            if (r < last) {
                const float ray_u = um[r];
                const float lu = floorf(ray_u);
                if (lu >= lowest && lu <= highest) {
                    const float ray_e = em[r];
                    const float le = floorf(ray_e);
                    if (le >= 0.0f && le <= last_column) {
                        const float fe = ray_e - le, fu = ray_u - lu;
                        const float weight = wm[r];
                        value[0] = weight * (1.0f - fu) * (1.0f - fe);
                        value[1] = weight * (1.0f - fu) * fe;
                        value[2] = weight * fu * (1.0f - fe);
                        value[3] = weight * fu * fe;
                        row = static_cast<int>(lu) - row0;  // -1 when only the lower tap row is ours
                        col = static_cast<int>(le);
                        upper = row >= 0;
                        lower = row + 1 < rows;
                    }
                }
            }
            if (upper) {
                float* target = band + row * width + col;
                atomicAdd(target, value[0]);
                atomicAdd(target + 1, value[1]);
                top = min(top, row);
                bottom = max(bottom, row);
            }
            if (lower) {
                float* target = band + (row + 1) * width + col;
                atomicAdd(target, value[2]);
                atomicAdd(target + 1, value[3]);
                top = min(top, row + 1);
                bottom = max(bottom, row + 1);
            }
        }
        top = __reduce_min_sync(kFullMask, top);
        bottom = __reduce_max_sync(kFullMask, bottom);
        if (lane == 0 && top <= bottom) {
            atomicMin(&touched[0], top);
            atomicMax(&touched[1], bottom);
        }
        __syncthreads();  // every tap has landed
        float* om = out + m * map_size + static_cast<int64_t>(row0) * width;
        const int end = (touched[1] + 1) * width;
        for (int i = touched[0] * width + threadIdx.x; i < end; i += kThreads) {
            const float value = band[i];
            if (value != 0.0f) atomicAdd(om + i, value);
        }
        __syncthreads();  // the band and touched are read before the next heliostat resets them
    }
}

}  // namespace

extern "C" int splat_scatter_shared_limit(int device, int* bytes) {
    return static_cast<int>(cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

extern "C" int splat_scatter_forward(const float* e, const float* u, const float* w, float* out,
                                     int64_t num_maps, int64_t rays_per_map, int height, int width,
                                     int band_rows, int64_t rays_per_share, int device, void* stream) {
    cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (band_rows < 1 || rays_per_share < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = sizeof(float) * static_cast<size_t>(band_rows) * width;
    int limit = 0;
    status = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (bytes > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
    status = cudaFuncSetAttribute(band_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(bytes));
    if (status != cudaSuccess) return static_cast<int>(status);
    const int bands = (height + band_rows - 1) / band_rows;
    const int64_t shares = (rays_per_map + rays_per_share - 1) / rays_per_share;
    const dim3 grid(static_cast<unsigned>(bands * shares),
                    static_cast<unsigned>(num_maps < kMaxGridY ? num_maps : kMaxGridY), 1);
    band_accumulate_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        e, u, w, out, num_maps, rays_per_map, height, width, band_rows, bands, rays_per_share);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_scatter_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
