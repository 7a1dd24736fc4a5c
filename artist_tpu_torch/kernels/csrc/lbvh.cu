// Per-ray traversal of a linear bounding volume hierarchy (LBVH) over the
// blocking primitives' axis-aligned boxes: hand-written CUDA for Hopper
// (sm_90a).
//
// Not a TPU kernel's counterpart: the JAX package traverses its LBVH with a
// vmap-ed lax.while_loop (artist_tpu/raytracing/lbvh.py:
// lbvh_filter_blocking_planes, :337-380), which keeps a [rays, B] array of
// flags, 40 GB at one plant chunk (10 M rays against 4,000 primitives). Here
// each ray ORs its hits straight into one [B] array.
//
// Semantics (those of the flat route's cull, blocking.cu's cull_hit): a ray
// of heliostat m, ray i of it, starts at surface point p = i mod P, with
// inverse direction 1 / (d + 1e-12) and target-hit distance t_target. It hits
// a box when its slab interval is not empty, ends beyond 1e-6 and starts no
// later than t_target; the slab test is cull_hit's, in the same order of
// operations, NaN propagating through every minimum and maximum. Primitive
// b is kept (keep[b] = 1) when some ray of a heliostat that does not own b
// hits b's box. A node's box holds its children's, and the rounded slab
// interval of a box holds that of every box inside it, so a ray that hits a
// leaf hits every node above it: the traversal keeps exactly what the dense
// cull keeps, provided no push is dropped.
//
// Design: one thread a ray, a stack of kStackSize node indices in local
// memory; the root is node 0; an internal node that is hit pushes its left
// and then its right child, a push that finds the stack full is dropped (as
// the JAX traversal's stack_size = 64; a Karras tree over distinct 30-bit
// Morton codes and their indices is at most 30 + log2(B) + 1 deep, so a
// depth-first walk never holds more than that). A leaf that is hit and not
// the ray's own stores keep[b] = 1.0: every writer stores the same value, so
// the race is benign and needs no atomic. A node is two float4: min xyz and
// the left child, max xyz and the right child (a leaf: left -1, right its
// primitive); the tree (32 B a node, 256 KB at B = 4,000) stays in L1 and L2.
//
// Bound on the H100: a visited node costs one box test, 25 fp32 operations
// (six subtractions, six products, ten minima and maxima, three comparisons),
// against 36 bytes read a ray (its direction, target distance and origin)
// and 4 written a primitive. chip_smoke.py counts the visits of
// each run's rays (from the plain version) for the bound.
//
// Interface: plain C, loaded with ctypes; the caller allocates keep (zeroed)
// and passes PyTorch's current stream; the function returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStackSize = 64;

// min and max that return NaN when either operand is NaN (PTX .NaN, sm_80+).
__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// One axis of the slab test: narrows [t_entry, t_exit] to the slab [low, high].
__device__ __forceinline__ void slab(float low, float high, float origin, float inverse,
                                     float& t_entry, float& t_exit) {
    const float t_low = __fmul_rn(__fsub_rn(low, origin), inverse);
    const float t_high = __fmul_rn(__fsub_rn(high, origin), inverse);
    t_entry = max_nan(t_entry, min_nan(t_low, t_high));
    t_exit = min_nan(t_exit, max_nan(t_low, t_high));
}

// Whether the ray enters the box (lo.xyz, hi.xyz) before t_target. The x axis
// starts the running entry and exit, as cull_hit's.
__device__ __forceinline__ bool box_hit(float ox, float oy, float oz, float ix, float iy, float iz,
                                        float t_target, const float4& lo, const float4& hi) {
    const float x_low = __fmul_rn(__fsub_rn(lo.x, ox), ix);
    const float x_high = __fmul_rn(__fsub_rn(hi.x, ox), ix);
    float t_entry = min_nan(x_low, x_high);
    float t_exit = max_nan(x_low, x_high);
    slab(lo.y, hi.y, oy, iy, t_entry, t_exit);
    slab(lo.z, hi.z, oz, iz, t_entry, t_exit);
    return (t_exit >= t_entry) & (t_exit > 1e-6f) & (t_entry <= t_target);
}

__global__ void __launch_bounds__(kThreads)
lbvh_traverse_kernel(const float4* __restrict__ origins, const float4* __restrict__ directions,
                     const float* __restrict__ t_target, const int64_t* __restrict__ own,
                     const float4* __restrict__ nodes, float* __restrict__ keep,
                     int64_t total, int64_t rays, int points) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (row >= total) return;
    const int64_t m = row / rays;
    const int64_t p = (row - m * rays) % points;
    const float4 o = origins[m * points + p];
    const float4 d = directions[row];
    const float ix = __frcp_rn(__fadd_rn(d.x, 1e-12f));
    const float iy = __frcp_rn(__fadd_rn(d.y, 1e-12f));
    const float iz = __frcp_rn(__fadd_rn(d.z, 1e-12f));
    const float t = t_target[row];
    const int owner = static_cast<int>(own[m]);

    int stack[kStackSize];
    int top = 0;
    stack[top++] = 0;
    while (top > 0) {
        const int node = stack[--top];
        const float4 lo = __ldg(&nodes[2 * node]);
        const float4 hi = __ldg(&nodes[2 * node + 1]);
        if (!box_hit(o.x, o.y, o.z, ix, iy, iz, t, lo, hi)) continue;
        const int left = __float_as_int(lo.w);
        const int right = __float_as_int(hi.w);
        if (left < 0) {
            if (right != owner && keep[right] == 0.0f) keep[right] = 1.0f;
        } else {
            if (top < kStackSize) stack[top++] = left;
            if (top < kStackSize) stack[top++] = right;
        }
    }
}

}  // namespace

extern "C" int lbvh_traverse(const float* origins, const float* directions, const float* t_target,
                             const int64_t* own, const float* nodes, float* keep,
                             int64_t num_heliostats, int64_t rays, int points, int device, void* stream) {
    cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return static_cast<int>(status);
    const int64_t total = num_heliostats * rays;
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    lbvh_traverse_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(origins), reinterpret_cast<const float4*>(directions), t_target, own,
        reinterpret_cast<const float4*>(nodes), keep, total, rays, points);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int lbvh_stack_size() { return kStackSize; }

extern "C" const char* lbvh_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
