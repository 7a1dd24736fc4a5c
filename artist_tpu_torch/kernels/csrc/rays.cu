// The per-ray geometry chain from the sun's scatter angles to the splat's
// inputs, and its vector-Jacobian product: hand-written CUDA for Hopper
// (sm_90a).
//
// Not a TPU kernel's counterpart: the JAX package leaves this chain to XLA,
// which fuses it on the TPU (artist_tpu/geometry/transforms.py:
// apply_distortion_rotation, artist_tpu/raytracing/geometry.py:
// line_plane_intersections, the reflectivity product of
// artist_tpu/raytracing/render.py). In PyTorch every step of it is its own
// kernel over all the rays of a chunk, and autograd saves most of them: at the
// flux-driven kinematics batch (1,500 maps x 19 rays x 10,000 points, 285 M
// rays) each step reads and writes 1.1-4.6 GB, and the chain took 175 of 184
// busy ms an epoch on an H100. Here the chain is one forward and one backward
// kernel, and no per-ray intermediate reaches device memory.
//
// Semantics (those of the plain versions in rays.py, step for step the
// PyTorch chain's, in its order of operations, fp32): heliostat m's ray i at
// point p turns the point's preferred direction d by the distortion angles
// (e, u) = (angles_e[m, i, p], angles_u[m, i, p]) (up, then east); meets the
// heliostat's planar target (normal n, centre c, width W, height H) at t =
// ((c - o) . n) / (d' . n) from its origin o where d' . n < 0 (the front
// face), t = 0 elsewhere; maps the hit to bitmap coordinates be = (hit_e +
// W / 2 - c_e) / W (res_e - 1), bu likewise; is valid on the front face with
// 0 <= be <= res_e - 1 and 0 <= bu <= res_u - 1; and gives the splat
// e = (res_e - 1) - be v, u = bu v and w = magnitude (-(d' . n)) v (1 -
// extinction) reflectivity, v = 1 where valid and 0 elsewhere (invalid rays
// are zeroed before the e-flip, so they arrive at e = res_e - 1, which the
// splat's strict bound rejects). The forward also counts, per heliostat, the
// rays with magnitude (-(d' . n)) v > 0 (on target) and w > 0 (intercepted).
// Both kernels trace a ray with one __device__ function (trace), written with
// the round-to-nearest intrinsics, which the compiler never contracts into an
// FMA: the backward's recomputed valid bits are the forward's, and each
// product and sum rounds as PyTorch's kernels round it. The angles' sines and
// cosines come from sincosf (IEEE, no --use_fast_math).
//
// The backward takes the splat's cotangents of e, u and w and returns the
// gradients of the preferred directions and of the origins, [M, P, 4], their
// homogeneous component 0. Invalid rays contribute nothing: their outputs do
// not depend on d or o (where autograd through the PyTorch chain could meet 0
// times an infinite distance, it gives NaN; no such ray reaches the splat).
// With v = 1, g_te = -g_e (res_e - 1) / W and g_tu = g_u (res_u - 1) / H are
// the hit's gradient along e and u; g_t = g_te d'_e + g_tu d'_u; g_a = -g_t t
// / a - g_w magnitude (1 - extinction) reflectivity for a = d' . n; the ray's
// direction takes (g_te t, 0, g_tu t) + g_a n, turned back by the rotation's
// transpose, and its origin (g_te, 0, g_tu) - (g_t / a) n.
//
// Bound on the H100: bytes. The forward reads 8 bytes of angles a ray and 32
// a point (the preferred direction and the origin), and writes 12 a ray (e, u
// and w): 20 bytes a ray and 32 a point, 6.02 GB or 1.80 ms at [1500, 19,
// 10000]. The backward reads the angles and the three cotangents, 20 bytes a
// ray, and per point the direction and the origin and writes their two
// gradients, 64 bytes: 6.66 GB or 1.99 ms there. A ray costs ~130 (forward)
// and ~200 (backward) instructions with the two sincosf, so the
// instruction rate lies close behind the bytes. Measured by chip_smoke.py
// phase 19 on an H100 80GB HBM3 (700 W limit), replayed from a CUDA graph, at
// [36, 12, 10000] / [500, 19, 10000] / [1500, 19, 10000]: forward 0.0445 /
// 0.790 / 2.348 ms (66 / 78 / 79% of the bound), backward 0.0554 / 0.969 /
// 2.882 ms (59 / 68 / 69%); the PyTorch chain took most of 175 ms an epoch at
// the last shape. ptxas: 70 registers (forward) and 60 (backward), no spills
// (a 32-byte stack frame: sincosf's reduction of large arguments). Tried and
// dropped, in turns at [1500, 19, 10000]: batches of 8 rays (forward 2.57,
// backward 3.40 ms; 102 registers), of 2 (2.77, 2.77), 4 blocks an SM forced
// on the forward (2.52), and on both with batches of 8 (2.52, 5.17).
//
// Design: one thread owns one (heliostat m, point p) and loops over the
// chunk's r rays; a block takes 256 consecutive points of one heliostat, so
// every warp-wide access of the [M, r, P] streams covers 32 consecutive
// points. The point's direction, origin and (c - o) . n are read and formed
// once, and the heliostat's target once a block. The angles are read in place
// through their strides (the [M, R, P, 2] sample that Sun.get_distortions
// draws, sliced to a chunk of rays), with no copy. The rays go in batches of
// kBatch: every load of a batch is issued before one is used. The forward
// adds its counts in a warp reduction and one 64-bit integer atomic a block,
// exact in any order. The backward sums a point's gradients over its rays in
// registers and writes each once: no atomics, so two launches give the same
// bits.
//
// Interface: plain C, loaded with ctypes. The caller allocates every buffer
// (the counts zeroed) and passes PyTorch's current stream; each function
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

// The inputs both kernels read. rays.py's RayArgs mirrors this layout.
struct RayArgs {
    const float* preferred;   // [M, P, 4], contiguous
    const float* origins;     // [M, P, 4], contiguous
    const float* angles_u;    // [M, r, P] through u_strides (elements)
    const float* angles_e;    // [M, r, P] through e_strides (elements)
    int64_t u_strides[3];
    int64_t e_strides[3];
    const float* normals;     // [T, 4] planar target normals
    const float* centers;     // [T, 4] planar target centres
    const float* dimensions;  // [T, 2] width, height
    const int64_t* targets;   // [M] planar target index
    int64_t num_targets;
    const float* magnitudes;  // null: magnitude for every ray; else magnitudes[m * magnitude_stride]
    int64_t magnitude_stride;
    float magnitude;
    float last_e, last_u;     // res_e - 1, res_u - 1
    float keep;               // 1 - extinction, rounded to fp32
    float reflectivity;
    int64_t num_maps, rays, points;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Target {
    float nx, ny, nz;      // the plane's normal
    float ce, cn, cu;      // its centre
    float width, height;
    float half_width, half_height;
};

struct Point {
    float pe, pn, pu;  // the preferred direction
    float oe, on, ou;  // the origin
    float b;           // (c - o) . n
};

struct Ray {
    float sin_e, cos_e, sin_u, cos_u;
    float de, dn, du;      // the turned direction
    float a;               // d . n, negative on the front face
    float t;               // the distance to the plane, 0 off the front face
    float be, bu;          // bitmap coordinates before the mask and the flip
    bool valid;
};

__device__ __forceinline__ Target load_target(const RayArgs& args, int64_t m) {
    const int64_t index = args.targets[m];
    // An index out of range is a caller's fault, as PyTorch's device-side index check makes it.
    if (index < 0 || index >= args.num_targets) __trap();
    const float* normal = args.normals + 4 * index;
    const float* centre = args.centers + 4 * index;
    Target target;
    target.nx = normal[0];
    target.ny = normal[1];
    target.nz = normal[2];
    target.ce = centre[0];
    target.cn = centre[1];
    target.cu = centre[2];
    target.width = args.dimensions[2 * index];
    target.height = args.dimensions[2 * index + 1];
    target.half_width = __fdiv_rn(target.width, 2.0f);
    target.half_height = __fdiv_rn(target.height, 2.0f);
    return target;
}

// The point at flat offset ``offset`` of the [M, P, 4] inputs.
__device__ __forceinline__ Point load_point(const RayArgs& args, const Target& target, int64_t offset) {
    const float* d = args.preferred + offset;
    const float* o = args.origins + offset;
    Point point;
    point.pe = d[0];
    point.pn = d[1];
    point.pu = d[2];
    point.oe = o[0];
    point.on = o[1];
    point.ou = o[2];
    point.b = add(add(mul(sub(target.ce, point.oe), target.nx), mul(sub(target.cn, point.on), target.ny)),
                  mul(sub(target.cu, point.ou), target.nz));
    return point;
}

// One ray from its angles to its bitmap coordinates and validity, as the plain chain computes it.
__device__ __forceinline__ Ray trace(float angle_e, float angle_u, const Point& p, const Target& g,
                                     float last_e, float last_u) {
    Ray r;
    sincosf(angle_e, &r.sin_e, &r.cos_e);
    sincosf(angle_u, &r.sin_u, &r.cos_u);
    r.de = sub(mul(r.cos_u, p.pe), mul(r.sin_u, p.pn));
    r.dn = sub(add(mul(mul(r.cos_e, r.sin_u), p.pe), mul(mul(r.cos_e, r.cos_u), p.pn)), mul(r.sin_e, p.pu));
    r.du = add(add(mul(mul(r.sin_e, r.sin_u), p.pe), mul(mul(r.sin_e, r.cos_u), p.pn)), mul(r.cos_e, p.pu));
    r.a = add(add(mul(r.de, g.nx), mul(r.dn, g.ny)), mul(r.du, g.nz));
    const bool front = r.a < 0.0f;
    r.t = mul(__fdiv_rn(p.b, front ? r.a : 1.0f), front ? 1.0f : 0.0f);
    const float hit_e = add(p.oe, mul(r.de, r.t));
    const float hit_u = add(p.ou, mul(r.du, r.t));
    r.be = mul(__fdiv_rn(sub(add(hit_e, g.half_width), g.ce), g.width), last_e);
    r.bu = mul(__fdiv_rn(sub(add(hit_u, g.half_height), g.cu), g.height), last_u);
    r.valid = (0.0f <= r.be) && (r.be <= last_e) && (0.0f <= r.bu) && (r.bu <= last_u) && front;
    return r;
}

__device__ __forceinline__ float magnitude_of(const RayArgs& args, int64_t m) {
    return args.magnitudes == nullptr ? args.magnitude : args.magnitudes[m * args.magnitude_stride];
}

__global__ void __launch_bounds__(kThreads) ray_forward_kernel(
    const RayArgs args, float* __restrict__ out_e, float* __restrict__ out_u, float* __restrict__ out_w,
    unsigned long long* __restrict__ counts) {
    const int64_t tiles = (args.points + kThreads - 1) / kThreads;
    const int64_t m = blockIdx.x / tiles;
    const int64_t p = (blockIdx.x - m * tiles) * kThreads + threadIdx.x;
    unsigned on_target = 0, intercepted = 0;
    if (p < args.points) {
        const Target target = load_target(args, m);
        const Point point = load_point(args, target, 4 * (m * args.points + p));
        const float magnitude = magnitude_of(args, m);
        const float* angle_u = args.angles_u + m * args.u_strides[0] + p * args.u_strides[2];
        const float* angle_e = args.angles_e + m * args.e_strides[0] + p * args.e_strides[2];
        const int64_t rays = args.rays;
        const int64_t out = m * rays * args.points + p;
        for (int64_t first = 0; first < rays; first += kBatch) {
            float au[kBatch], ae[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                const int64_t i = first + k;
                au[k] = i < rays ? angle_u[i * args.u_strides[1]] : 0.0f;
                ae[k] = i < rays ? angle_e[i * args.e_strides[1]] : 0.0f;
            }
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                const int64_t i = first + k;
                if (i >= rays) break;
                const Ray r = trace(ae[k], au[k], point, target, args.last_e, args.last_u);
                const float v = r.valid ? 1.0f : 0.0f;
                const float intensity = mul(mul(magnitude, -r.a), v);
                const float w = mul(mul(intensity, args.keep), args.reflectivity);
                const int64_t at = out + i * args.points;
                out_e[at] = sub(args.last_e, mul(r.be, v));
                out_u[at] = mul(r.bu, v);
                out_w[at] = w;
                on_target += intensity > 0.0f;
                intercepted += w > 0.0f;
            }
        }
    }
    on_target = __reduce_add_sync(0xffffffffu, on_target);
    intercepted = __reduce_add_sync(0xffffffffu, intercepted);
    __shared__ unsigned warp_counts[2][kWarps];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
        warp_counts[0][warp] = on_target;
        warp_counts[1][warp] = intercepted;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
        unsigned long long total = 0;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) total += warp_counts[threadIdx.x][k];
        if (total) atomicAdd(counts + threadIdx.x * args.num_maps + m, total);
    }
}

__global__ void __launch_bounds__(kThreads) ray_backward_kernel(
    const RayArgs args, const float* __restrict__ grad_e, const float* __restrict__ grad_u,
    const float* __restrict__ grad_w, float* __restrict__ grad_preferred, float* __restrict__ grad_origins) {
    const int64_t tiles = (args.points + kThreads - 1) / kThreads;
    const int64_t m = blockIdx.x / tiles;
    const int64_t p = (blockIdx.x - m * tiles) * kThreads + threadIdx.x;
    if (p >= args.points) return;
    const Target g = load_target(args, m);
    const int64_t point_offset = 4 * (m * args.points + p);
    const Point point = load_point(args, g, point_offset);
    const float intensity_factor = magnitude_of(args, m) * args.keep * args.reflectivity;
    const float scale_e = args.last_e / g.width;
    const float scale_u = args.last_u / g.height;
    const float* angle_u = args.angles_u + m * args.u_strides[0] + p * args.u_strides[2];
    const float* angle_e = args.angles_e + m * args.e_strides[0] + p * args.e_strides[2];
    const int64_t rays = args.rays;
    const int64_t in = m * rays * args.points + p;
    float gp_e = 0.0f, gp_n = 0.0f, gp_u = 0.0f;
    float go_e = 0.0f, go_n = 0.0f, go_u = 0.0f;
    for (int64_t first = 0; first < rays; first += kBatch) {
        float au[kBatch], ae[kBatch], ge[kBatch], gu[kBatch], gw[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            const int64_t i = first + k;
            const bool here = i < rays;
            au[k] = here ? angle_u[i * args.u_strides[1]] : 0.0f;
            ae[k] = here ? angle_e[i * args.e_strides[1]] : 0.0f;
            ge[k] = here ? grad_e[in + i * args.points] : 0.0f;
            gu[k] = here ? grad_u[in + i * args.points] : 0.0f;
            gw[k] = here ? grad_w[in + i * args.points] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (first + k >= rays) break;
            const Ray r = trace(ae[k], au[k], point, g, args.last_e, args.last_u);
            if (!r.valid) continue;
            const float g_te = -ge[k] * scale_e;
            const float g_tu = gu[k] * scale_u;
            const float g_t = g_te * r.de + g_tu * r.du;
            const float g_b = g_t / r.a;
            const float g_a = -g_b * r.t - gw[k] * intensity_factor;
            const float gd_e = g_te * r.t + g_a * g.nx;
            const float gd_n = g_a * g.ny;
            const float gd_u = g_tu * r.t + g_a * g.nz;
            gp_e += r.cos_u * gd_e + r.cos_e * r.sin_u * gd_n + r.sin_e * r.sin_u * gd_u;
            gp_n += -r.sin_u * gd_e + r.cos_e * r.cos_u * gd_n + r.sin_e * r.cos_u * gd_u;
            gp_u += -r.sin_e * gd_n + r.cos_e * gd_u;
            go_e += g_te - g_b * g.nx;
            go_n -= g_b * g.ny;
            go_u += g_tu - g_b * g.nz;
        }
    }
    reinterpret_cast<float4*>(grad_preferred + point_offset)[0] = make_float4(gp_e, gp_n, gp_u, 0.0f);
    reinterpret_cast<float4*>(grad_origins + point_offset)[0] = make_float4(go_e, go_n, go_u, 0.0f);
}

cudaError_t prepare(const RayArgs& args, int device, int64_t* blocks) {
    const cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return status;
    *blocks = args.num_maps * ((args.points + kThreads - 1) / kThreads);
    if (*blocks > 0x7fffffff) return cudaErrorInvalidValue;
    return cudaSuccess;
}

}  // namespace

extern "C" int ray_forward(RayArgs args, float* out_e, float* out_u, float* out_w, unsigned long long* counts,
                           int device, void* stream) {
    int64_t blocks = 0;
    const cudaError_t status = prepare(args, device, &blocks);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (blocks == 0 || args.rays == 0) return cudaSuccess;
    ray_forward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        args, out_e, out_u, out_w, counts);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_backward(RayArgs args, const float* grad_e, const float* grad_u, const float* grad_w,
                            float* grad_preferred, float* grad_origins, int device, void* stream) {
    int64_t blocks = 0;
    const cudaError_t status = prepare(args, device, &blocks);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (blocks == 0) return cudaSuccess;
    ray_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        args, grad_e, grad_u, grad_w, grad_preferred, grad_origins);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_args_size() { return static_cast<int>(sizeof(RayArgs)); }

extern "C" const char* ray_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
