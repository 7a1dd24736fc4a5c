// Per-ray accumulate of the bilinear splat into a whole heliostat map held
// on chip, in the distributed shared memory of a thread-block cluster:
// hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   cluster_accumulate_kernel <- _scatter_kernel
//       (tools/splat_formulation_bench.py, via scatter_forward)
// which walks its rays one by one and adds each ray's four taps into the
// heliostat's whole [H, W] map resident in VMEM.
//
// Semantics: the forward of splat.cu (strict bounds tested in float before
// any int cast, so NaN, +-inf and 1e30 are invalid; fp32 deposits).
//
// Design. A map does not fit one block's shared memory at the flagship size
// (256 x 256 fp32 = 256 KB, against 227 KB a block), so a cluster of C blocks
// (C chosen by the caller: the fewest whose shared memory holds the map, at
// most the portable 8) holds it together: block r owns rows
// [r R, (r + 1) R) with R = ceil(H / C), R x W fp32 in its dynamic shared
// memory. Each cluster takes a contiguous share of one heliostat's rays; its
// blocks zero their rows, synchronise the cluster, and add every ray's taps
// with shared-memory atomics into the owning block's rows through
// cooperative_groups::this_cluster().map_shared_rank. After a second cluster
// synchronisation each block flushes its rows to the heliostat's map in
// device memory, one global atomicAdd per non-zero pixel, so several
// clusters can split one map's rays.
//
// Bound on the H100: bytes, as splat.cu's forward (12 bytes read a ray
// against 14 fp32 operations). The taps go to distributed shared memory,
// half of them to another SM of the cluster; what that costs against L2
// atomics is what this kernel measures. Measured by chip_smoke.py on an H100
// SXM 80 GB (700 W limit) at the formulation tool's 32 M rays: 2.60 ms,
// against splat.cu's forward 1.66 ms, index_add_ 1.55 ms and a 0.12 ms
// byte bound: the distributed-shared-memory atomics cost more than L2's.
//
// Interface: plain C, loaded with ctypes. The caller allocates the output
// (zeroed) and passes PyTorch's current stream. The launch function returns
// cudaGetLastError() after its launch, cudaErrorInvalidValue when the rows do
// not fit shared memory, or kNoActiveCluster when the card cannot schedule
// one cluster of this shape (cudaOccupancyMaxActiveClusters gives 0).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxGridY = 65535;
constexpr int kNoActiveCluster = -1;

__global__ void __launch_bounds__(kThreads) cluster_accumulate_kernel(
    const float* __restrict__ e, const float* __restrict__ u, const float* __restrict__ w,
    float* __restrict__ out, int64_t num_maps, int64_t rays_per_map, int height, int width,
    int64_t rays_per_cluster, int rows_per_block) {
    extern __shared__ float rows[];  // [rows_per_block, width]: this block's rows of the map
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int size = static_cast<int>(cluster.num_blocks());
    const int64_t first = static_cast<int64_t>(blockIdx.x / size) * rays_per_cluster;
    const int64_t end = first + rays_per_cluster;
    const int64_t last = end < rays_per_map ? end : rays_per_map;
    const int64_t map_size = static_cast<int64_t>(height) * width;
    const int owned = rows_per_block * width;
    const int row0 = rank * rows_per_block;
    for (int64_t m = blockIdx.y; m < num_maps; m += gridDim.y) {
        for (int i = threadIdx.x; i < owned; i += kThreads) rows[i] = 0.0f;
        cluster.sync();  // every block's rows are zero before any tap lands
        const float* em = e + m * rays_per_map;
        const float* um = u + m * rays_per_map;
        const float* wm = w + m * rays_per_map;
        for (int64_t r = first + static_cast<int64_t>(rank) * kThreads + threadIdx.x; r < last;
             r += static_cast<int64_t>(size) * kThreads) {
            const float ray_e = em[r], ray_u = um[r];
            const float le = floorf(ray_e);
            const float lu = floorf(ray_u);
            // Written so that NaN fails every comparison and lands in "invalid".
            if (!((le >= 0.0f) && (le <= static_cast<float>(width - 2)) && (lu >= 0.0f) &&
                  (lu <= static_cast<float>(height - 2))))
                continue;
            const float fe = ray_e - le, fu = ray_u - lu;
            const float weight = wm[r];
            const int col = static_cast<int>(le);
            const int row = static_cast<int>(lu);
            const float values[2][2] = {
                {weight * (1.0f - fu) * (1.0f - fe), weight * (1.0f - fu) * fe},
                {weight * fu * (1.0f - fe), weight * fu * fe},
            };
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int owner = (row + k) / rows_per_block;
                float* target = cluster.map_shared_rank(rows, owner) +
                                ((row + k) - owner * rows_per_block) * width + col;
                atomicAdd(target, values[k][0]);
                atomicAdd(target + 1, values[k][1]);
            }
        }
        cluster.sync();  // every tap has landed
        float* om = out + m * map_size;
        for (int i = threadIdx.x; i < owned; i += kThreads) {
            const int row = row0 + i / width;
            if (row >= height) break;
            const float value = rows[i];
            if (value != 0.0f) atomicAdd(om + static_cast<int64_t>(row) * width + i % width, value);
        }
        // A block reads only its own rows from here on, so it may go on to the
        // next heliostat (or exit): the others add into its rows again only
        // after the next cluster.sync(), which it reaches after zeroing them.
    }
}

}  // namespace

extern "C" int splat_scatter_shared_limit(int device, int* bytes) {
    return static_cast<int>(cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

extern "C" int splat_scatter_forward(const float* e, const float* u, const float* w, float* out,
                                     int64_t num_maps, int64_t rays_per_map, int height, int width,
                                     int cluster, int64_t clusters_per_map, int device, void* stream) {
    cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return static_cast<int>(status);
    const int rows_per_block = (height + cluster - 1) / cluster;
    const size_t bytes = sizeof(float) * static_cast<size_t>(rows_per_block) * width;
    int limit = 0;
    status = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (bytes > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
    status = cudaFuncSetAttribute(cluster_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(bytes));
    if (status != cudaSuccess) return static_cast<int>(status);

    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(clusters_per_map * cluster),
                          static_cast<unsigned>(num_maps < kMaxGridY ? num_maps : kMaxGridY), 1);
    config.blockDim = dim3(kThreads, 1, 1);
    config.dynamicSmemBytes = bytes;
    config.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attribute[1];
    attribute[0].id = cudaLaunchAttributeClusterDimension;
    attribute[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attribute[0].val.clusterDim.y = 1;
    attribute[0].val.clusterDim.z = 1;
    config.attrs = attribute;
    config.numAttrs = 1;

    // Checked before the first launch of each shape: a cluster the card cannot
    // place would otherwise fail only at launch, or hang a cluster.sync().
    static int checked_cluster = 0;
    static size_t checked_bytes = 0;
    if (cluster != checked_cluster || bytes != checked_bytes) {
        int active = 0;
        status = cudaOccupancyMaxActiveClusters(&active, cluster_accumulate_kernel, &config);
        if (status != cudaSuccess) return static_cast<int>(status);
        if (active == 0) return kNoActiveCluster;
        checked_cluster = cluster;
        checked_bytes = bytes;
    }
    const int64_t rays_per_cluster = (rays_per_map + clusters_per_map - 1) / clusters_per_map;
    status = cudaLaunchKernelEx(&config, cluster_accumulate_kernel, e, u, w, out, num_maps, rays_per_map,
                                height, width, rays_per_cluster, rows_per_block);
    if (status != cudaSuccess) return static_cast<int>(status);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_scatter_error_string(int code) {
    if (code == kNoActiveCluster) return "no thread-block cluster of this size and shared memory fits the card";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
