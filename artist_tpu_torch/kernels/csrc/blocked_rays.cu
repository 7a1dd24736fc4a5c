// The per-ray chain of the compacted blocking route on planar targets, from the
// sun's scatter angles to the splat's inputs, around the blocking sigma pair of
// blocking.cu, and its vector-Jacobian product: hand-written CUDA for Hopper
// (sm_90a).
//
// Not a TPU kernel's counterpart: the JAX package leaves this chain to XLA,
// which fuses it on the TPU (artist_tpu/geometry/transforms.py:
// apply_distortion_rotation, artist_tpu/raytracing/geometry.py:
// line_plane_intersections, the corridor statistics of
// artist_tpu/raytracing/blocking.py:select_blocking_candidates, the mask
// 1 - exp(-alpha sigma) and the intensity products of
// artist_tpu/raytracing/render.py). In PyTorch each step of it is its own
// kernel over every ray of a chunk, and autograd keeps most of them: on a
// 1,000-heliostat aim-point field in chunks of 250 heliostats x 30 rays x
// 10,000 points (75 M rays) the chain took ~333 ms of device time an epoch on
// an H100. rays.cu holds the same chain for the route without blocking; this
// file carries its own copy of the trace (the device functions up to trace())
// so that the two routes share no code: blocking needs outputs that the route
// without blocking has no reason to make (each ray's direction and target
// distance for sigma, the corridor statistics, sigma's cotangent of the
// directions in the backward).
//
// Semantics (those of the plain versions in blocked_rays.py, step for step the
// PyTorch chain's, in its order of operations, fp32). Heliostat m's ray i at
// point p turns the point's preferred direction d by the distortion angles (e,
// u) = (angles_e[m, i, p], angles_u[m, i, p]) (up, then east); meets the
// heliostat's planar target (normal n, centre c, width W, height H) at t =
// ((c - o) . n) / (d' . n) from its origin o where a = d' . n < 0 (the front
// face), t = 0 elsewhere; maps the hit to bitmap coordinates be = (hit_e + W /
// 2 - c_e) / W (res_e - 1), bu likewise; is valid (v = 1) on the front face
// with 0 <= be <= res_e - 1 and 0 <= bu <= res_u - 1. The forward writes the
// direction (d'_e, d'_n, d'_u, d_w) [M, r P, 4] and the target distance t v
// [M, r P] that the sigma pair reads, the splat's e = (res_e - 1) - be v and u
// = bu v, and the intensity I = magnitude (-a) v [M, r, P]; it counts each
// heliostat's rays with I > 0. The corridor statistics of a heliostat are the
// mean of its rays' directions (normalised, eps 1e-9), the least cosine of a
// ray to it, the largest t v, and its points' centre and the largest distance
// of a point from it (select_blocking_candidates' reductions). Given sigma,
// the epilogue writes w = I (1 - blocked) (1 - extinction) reflectivity with
// blocked = 1 - exp(-alpha sigma), and counts each heliostat's rays with w > 0
// and with blocked < 1e-3. The trace is written with the round-to-nearest
// intrinsics, which the compiler never contracts into an FMA: the backward's
// recomputed rays are the forward's and round as PyTorch's kernels round them.
// The angles' sines and cosines come from sincosf (IEEE, no --use_fast_math).
//
// The backward takes the splat's cotangents of e, u and w. The epilogue's
// backward gives those of I and of sigma; the sigma pair's backward (unchanged)
// gives sigma's cotangent of the directions; the ray backward recomputes each
// ray from its angles and returns the gradients of the preferred directions
// and of the origins, [M, P, 4], their homogeneous component 0. A valid ray's
// direction takes (g_te t, 0, g_tu t) + g_a n, with g_te = -g_e (res_e - 1) /
// W, g_tu = g_u (res_u - 1) / H, g_t = g_te d'_e + g_tu d'_u and g_a = -g_t t
// / a - g_I magnitude, and its origin (g_te, 0, g_tu) - (g_t / a) n; every ray,
// valid or not, adds sigma's direction cotangent; the sum is turned back by
// the rotation's transpose. Invalid rays' e, u and I do not depend on d or o.
// The target distance and the statistics carry no gradient (the candidates and
// sigma's behind-target gate are stop-gradient).
//
// Bounds on the H100: bytes, at 3.35 TB/s. At the aim-point chunk [250, 30,
// 10000] (75 M rays, 2.5 M points) with K = 16: the ray forward reads 8 bytes
// of angles a ray and writes 32 (direction 16, distance, e, u, I), and reads 32
// a point: 40 bytes a ray, 3.08 GB or 0.92 ms. The statistics read the angles
// again, 8 bytes a ray and 32 a point (the least cosine needs the mean first;
// the forward adds the sums and the largest distance into per-block partials):
// 0.68 GB or 0.20 ms. The epilogue reads I and sigma and writes w, 12 bytes a
// ray, 0.27 ms. Its backward reads the cotangent of w, I and sigma and writes
// the cotangents of I and sigma, 20 bytes a ray, 0.45 ms. The ray backward
// reads the angles, the cotangents of e, u and I and sigma's direction
// cotangent, 36 bytes a ray, and 64 a point (the direction and the origin
// read, their gradients written): 2.86 GB or 0.85 ms. A checkpointed chunk
// runs the three forwards twice and the two backwards once: 60 bytes a ray
// forward, 56 backward, 4.1 ms a chunk and 16.3 ms an epoch of 4 chunks,
// besides the sigma pair (about 1.5 ms a forward and 2.4 ms a backward at this
// chunk on an H100). Measured by chip_smoke.py phase 20 on an H100 80GB HBM3
// (700 W limit), replayed from a CUDA graph at that chunk: 1.173 / 0.363 /
// 0.296 / 0.495 / 0.963 ms (ray forward, statistics, epilogue, its backward,
// ray backward), 78 / 56 / 91 / 90 / 89% of their bounds. ptxas: 74 / 56 / 24 /
// 26 / 80 registers, no spills (the two ray kernels keep a 32-byte stack frame:
// sincosf's reduction of large arguments).
//
// Design: the ray kernels and the statistics give one thread one (heliostat m,
// point p) and loop over the chunk's r rays, as rays.cu does: every warp-wide
// access of the [M, r, P] streams covers 32 consecutive points, a point's
// direction, origin and (c - o) . n are read and formed once, and the angles
// are read in place through their strides. The rays go in batches of kBatch:
// every load of a batch starts before one is used. The forward blocks take
// 256 consecutive points of one heliostat; each writes its rays' direction
// sums, its points' origin sums and its largest distance to a partials row of
// its own, reduced in a fixed order, so that two launches give the same bits.
// The statistics run one block of 512 threads a heliostat: it sums the
// heliostat's partials in a fixed order (in double), forms the mean direction
// and the centre, loops over the heliostat's points, and reduces the least
// cosine and the largest radius in the block. Minimum and maximum propagate
// NaN, as torch.amin and amax do. The epilogue and its backward go through
// the [M, r P] streams 4 rays a thread, coalesced; the forward kernels add
// their counts in a warp reduction and one 64-bit integer atomic a block,
// exact in any order. The ray backward sums a point's gradients over its rays
// in registers and writes each once: no atomics.
//
// Interface: plain C, loaded with ctypes. The caller allocates every buffer
// (the counts zeroed) and passes PyTorch's current stream; each function
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

// The inputs of the ray kernels and the statistics. blocked_rays.py's
// BlockedArgs mirrors this layout.
struct BlockedArgs {
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
    int64_t num_maps, rays, points;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;
constexpr int kStatisticsThreads = 512;
constexpr int kStatisticsWarps = kStatisticsThreads / 32;
constexpr int kItems = 4;  // rays a thread of the epilogue and its backward
// A partials row: the sums of d'_e, d'_n, d'_u over the block's rays and of
// o_e, o_n, o_u over its points, the largest t v, and one float of padding.
constexpr int kPartials = 8;
constexpr int kSums = 6;
// A statistics row: centre (3), radius, mean direction (3), least cosine,
// largest target distance.
constexpr int kStatistics = 9;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float negative_infinity() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float positive_infinity() { return __int_as_float(0x7f800000); }

// Maximum and minimum that keep a NaN, as torch.amax and torch.amin do.
__device__ __forceinline__ float nan_max(float a, float b) { return (isnan(a) || a > b) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (isnan(a) || a < b) ? a : b; }

// Warp reductions in a fixed order; lane 0 holds the result.
__device__ __forceinline__ float warp_sum(float x) {
    for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_down_sync(kFullMask, x, offset);
    return x;
}
__device__ __forceinline__ float warp_max(float x) {
    for (int offset = 16; offset > 0; offset >>= 1) x = nan_max(x, __shfl_down_sync(kFullMask, x, offset));
    return x;
}
__device__ __forceinline__ float warp_min(float x) {
    for (int offset = 16; offset > 0; offset >>= 1) x = nan_min(x, __shfl_down_sync(kFullMask, x, offset));
    return x;
}

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

__device__ __forceinline__ Target load_target(const BlockedArgs& args, int64_t m) {
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
__device__ __forceinline__ Point load_point(const BlockedArgs& args, const Target& target, int64_t offset) {
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

// The ray's direction from its angles, as apply_distortion_rotation turns it.
__device__ __forceinline__ void turn(float angle_e, float angle_u, float pe, float pn, float pu, Ray& r) {
    sincosf(angle_e, &r.sin_e, &r.cos_e);
    sincosf(angle_u, &r.sin_u, &r.cos_u);
    r.de = sub(mul(r.cos_u, pe), mul(r.sin_u, pn));
    r.dn = sub(add(mul(mul(r.cos_e, r.sin_u), pe), mul(mul(r.cos_e, r.cos_u), pn)), mul(r.sin_e, pu));
    r.du = add(add(mul(mul(r.sin_e, r.sin_u), pe), mul(mul(r.sin_e, r.cos_u), pn)), mul(r.cos_e, pu));
}

// One ray from its angles to its bitmap coordinates and validity, as the plain chain computes it.
__device__ __forceinline__ Ray trace(float angle_e, float angle_u, const Point& p, const Target& g,
                                     float last_e, float last_u) {
    Ray r;
    turn(angle_e, angle_u, p.pe, p.pn, p.pu, r);
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

__device__ __forceinline__ float magnitude_of(const BlockedArgs& args, int64_t m) {
    return args.magnitudes == nullptr ? args.magnitude : args.magnitudes[m * args.magnitude_stride];
}

// Adds a block's counts, one a thread: counts[k * num_maps + m] += the block's sum of values[k], one
// atomic each.
template <int Count>
__device__ __forceinline__ void add_counts(unsigned (&values)[Count], unsigned long long* counts, int64_t num_maps,
                                           int64_t m) {
    __shared__ unsigned warp_counts[Count][kWarps];
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int k = 0; k < Count; ++k) {
        const unsigned total = __reduce_add_sync(kFullMask, values[k]);
        if (threadIdx.x % 32 == 0) warp_counts[k][warp] = total;
    }
    __syncthreads();
    if (threadIdx.x < Count) {
        unsigned long long total = 0;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) total += warp_counts[threadIdx.x][k];
        if (total) atomicAdd(counts + threadIdx.x * num_maps + m, total);
    }
}

__global__ void __launch_bounds__(kThreads) blocked_trace_forward_kernel(
    const BlockedArgs args, float4* __restrict__ directions, float* __restrict__ distances,
    float* __restrict__ out_e, float* __restrict__ out_u, float* __restrict__ intensities,
    float* __restrict__ partials, unsigned long long* __restrict__ on_target_counts) {
    const int64_t tiles = (args.points + kThreads - 1) / kThreads;
    const int64_t m = blockIdx.x / tiles;
    const int64_t tile = blockIdx.x - m * tiles;
    const int64_t p = tile * kThreads + threadIdx.x;
    unsigned on_target = 0;
    float sums[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float farthest = negative_infinity();
    if (p < args.points) {
        const Target target = load_target(args, m);
        const int64_t point_offset = 4 * (m * args.points + p);
        const Point point = load_point(args, target, point_offset);
        const float homogeneous = args.preferred[point_offset + 3];
        sums[3] = point.oe;
        sums[4] = point.on;
        sums[5] = point.ou;
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
                const float distance = mul(r.t, v);
                const int64_t at = out + i * args.points;
                directions[at] = make_float4(r.de, r.dn, r.du, homogeneous);
                distances[at] = distance;
                out_e[at] = sub(args.last_e, mul(r.be, v));
                out_u[at] = mul(r.bu, v);
                intensities[at] = intensity;
                on_target += intensity > 0.0f;
                sums[0] += r.de;
                sums[1] += r.dn;
                sums[2] += r.du;
                farthest = nan_max(farthest, distance);
            }
        }
    }
    __shared__ float warp_values[kWarps][kSums + 1];
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int k = 0; k < kSums; ++k) sums[k] = warp_sum(sums[k]);
    farthest = warp_max(farthest);
    if (threadIdx.x % 32 == 0) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) warp_values[warp][k] = sums[k];
        warp_values[warp][kSums] = farthest;
    }
    __syncthreads();
    if (threadIdx.x <= kSums) {
        float total = warp_values[0][threadIdx.x];
        for (int k = 1; k < kWarps; ++k) {
            const float value = warp_values[k][threadIdx.x];
            total = threadIdx.x < kSums ? total + value : nan_max(total, value);
        }
        partials[(m * tiles + tile) * kPartials + threadIdx.x] = total;
    } else if (threadIdx.x < kPartials) {
        partials[(m * tiles + tile) * kPartials + threadIdx.x] = 0.0f;  // the padding, so that a row is defined
    }
    unsigned counted[1] = {on_target};
    add_counts(counted, on_target_counts, args.num_maps, m);
}

__global__ void __launch_bounds__(kStatisticsThreads) corridor_statistics_kernel(
    const BlockedArgs args, const float* __restrict__ partials, float* __restrict__ statistics) {
    const int64_t m = blockIdx.x;
    const int64_t tiles = (args.points + kThreads - 1) / kThreads;
    __shared__ float reduced[kSums + 1];
    if (threadIdx.x <= kSums) {
        const float* row = partials + m * tiles * kPartials + threadIdx.x;
        if (threadIdx.x < kSums) {
            double total = 0.0;
            for (int64_t t = 0; t < tiles; ++t) total += row[t * kPartials];
            const double count = threadIdx.x < 3 ? double(args.rays) * double(args.points) : double(args.points);
            reduced[threadIdx.x] = float(total / count);
        } else {
            float top = negative_infinity();
            for (int64_t t = 0; t < tiles; ++t) top = nan_max(top, row[t * kPartials]);
            reduced[kSums] = top;
        }
    }
    __syncthreads();
    // The mean direction over max(|mean|, 1e-9), a NaN kept as torch.clamp keeps it.
    const float norm = sqrtf(reduced[0] * reduced[0] + reduced[1] * reduced[1] + reduced[2] * reduced[2]);
    const float scale = norm < 1e-9f ? 1e-9f : norm;
    const float me = reduced[0] / scale, mn = reduced[1] / scale, mu = reduced[2] / scale;
    const float ce = reduced[3], cn = reduced[4], cu = reduced[5];
    float least = positive_infinity(), radius_sq = negative_infinity();
    const int64_t rays = args.rays;
    for (int64_t p = threadIdx.x; p < args.points; p += kStatisticsThreads) {
        const int64_t point_offset = 4 * (m * args.points + p);
        const float4 origin = reinterpret_cast<const float4*>(args.origins + point_offset)[0];
        const float4 preferred = reinterpret_cast<const float4*>(args.preferred + point_offset)[0];
        const float oe = origin.x - ce, on = origin.y - cn, ou = origin.z - cu;
        radius_sq = nan_max(radius_sq, oe * oe + on * on + ou * ou);
        const float* angle_u = args.angles_u + m * args.u_strides[0] + p * args.u_strides[2];
        const float* angle_e = args.angles_e + m * args.e_strides[0] + p * args.e_strides[2];
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
                if (first + k >= rays) break;
                Ray r;
                turn(ae[k], au[k], preferred.x, preferred.y, preferred.z, r);
                least = nan_min(least, r.de * me + r.dn * mn + r.du * mu);
            }
        }
    }
    least = warp_min(least);
    radius_sq = warp_max(radius_sq);
    __shared__ float warp_values[2][kStatisticsWarps];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
        warp_values[0][warp] = least;
        warp_values[1][warp] = radius_sq;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int k = 1; k < kStatisticsWarps; ++k) {
            least = nan_min(least, warp_values[0][k]);
            radius_sq = nan_max(radius_sq, warp_values[1][k]);
        }
        float* row = statistics + m * kStatistics;
        row[0] = ce;
        row[1] = cn;
        row[2] = cu;
        row[3] = sqrtf(radius_sq);
        row[4] = me;
        row[5] = mn;
        row[6] = mu;
        row[7] = least;
        row[8] = reduced[kSums];
    }
}

// 1 - exp(-alpha sigma), as the mask rounds it.
__device__ __forceinline__ float blocked_of(float sigma, float alpha) {
    return sub(1.0f, expf(mul(sigma, -alpha)));
}

__global__ void __launch_bounds__(kThreads) blocked_epilogue_kernel(
    const float* __restrict__ intensities, const float* __restrict__ sigma, float* __restrict__ out_w,
    unsigned long long* __restrict__ counts, int64_t num_maps, int64_t rays_per_map, float alpha, float keep,
    float reflectivity) {
    const int64_t m = blockIdx.y;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * (kThreads * kItems) + threadIdx.x;
    const int64_t base = m * rays_per_map;
    float intensity[kItems], depth[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int64_t i = first + k * kThreads;
        intensity[k] = i < rays_per_map ? intensities[base + i] : 0.0f;
        depth[k] = i < rays_per_map ? sigma[base + i] : 0.0f;
    }
    unsigned intercepted = 0, unblocked = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int64_t i = first + k * kThreads;
        if (i >= rays_per_map) break;
        const float blocked = blocked_of(depth[k], alpha);
        const float w = mul(mul(mul(intensity[k], sub(1.0f, blocked)), keep), reflectivity);
        out_w[base + i] = w;
        intercepted += w > 0.0f;
        unblocked += blocked < 1e-3f;
    }
    unsigned counted[2] = {intercepted, unblocked};
    add_counts(counted, counts, num_maps, m);
}

__global__ void __launch_bounds__(kThreads) blocked_epilogue_backward_kernel(
    const float* __restrict__ grad_w, const float* __restrict__ intensities, const float* __restrict__ sigma,
    float* __restrict__ grad_intensities, float* __restrict__ grad_sigma, int64_t rays_per_map, float alpha,
    float keep, float reflectivity) {
    const int64_t m = blockIdx.y;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * (kThreads * kItems) + threadIdx.x;
    const int64_t base = m * rays_per_map;
    float gw[kItems], intensity[kItems], depth[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int64_t i = first + k * kThreads;
        const bool here = i < rays_per_map;
        gw[k] = here ? grad_w[base + i] : 0.0f;
        intensity[k] = here ? intensities[base + i] : 0.0f;
        depth[k] = here ? sigma[base + i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int64_t i = first + k * kThreads;
        if (i >= rays_per_map) break;
        const float transmitted = expf(mul(depth[k], -alpha));
        const float open = sub(1.0f, sub(1.0f, transmitted));
        const float g = gw[k] * reflectivity * keep;
        grad_intensities[base + i] = g * open;
        grad_sigma[base + i] = -alpha * (g * intensity[k] * transmitted);
    }
}

__global__ void __launch_bounds__(kThreads) blocked_trace_backward_kernel(
    const BlockedArgs args, const float4* __restrict__ grad_directions, const float* __restrict__ grad_e,
    const float* __restrict__ grad_u, const float* __restrict__ grad_intensities,
    float* __restrict__ grad_preferred, float* __restrict__ grad_origins) {
    const int64_t tiles = (args.points + kThreads - 1) / kThreads;
    const int64_t m = blockIdx.x / tiles;
    const int64_t p = (blockIdx.x - m * tiles) * kThreads + threadIdx.x;
    if (p >= args.points) return;
    const Target g = load_target(args, m);
    const int64_t point_offset = 4 * (m * args.points + p);
    const Point point = load_point(args, g, point_offset);
    const float magnitude = magnitude_of(args, m);
    const float scale_e = args.last_e / g.width;
    const float scale_u = args.last_u / g.height;
    const float* angle_u = args.angles_u + m * args.u_strides[0] + p * args.u_strides[2];
    const float* angle_e = args.angles_e + m * args.e_strides[0] + p * args.e_strides[2];
    const int64_t rays = args.rays;
    const int64_t in = m * rays * args.points + p;
    float gp_e = 0.0f, gp_n = 0.0f, gp_u = 0.0f;
    float go_e = 0.0f, go_n = 0.0f, go_u = 0.0f;
    for (int64_t first = 0; first < rays; first += kBatch) {
        float au[kBatch], ae[kBatch], ge[kBatch], gu[kBatch], gi[kBatch];
        float4 gd[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            const int64_t i = first + k;
            const bool here = i < rays;
            const int64_t at = in + i * args.points;
            au[k] = here ? angle_u[i * args.u_strides[1]] : 0.0f;
            ae[k] = here ? angle_e[i * args.e_strides[1]] : 0.0f;
            ge[k] = here ? grad_e[at] : 0.0f;
            gu[k] = here ? grad_u[at] : 0.0f;
            gi[k] = here ? grad_intensities[at] : 0.0f;
            gd[k] = here ? grad_directions[at] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (first + k >= rays) break;
            const Ray r = trace(ae[k], au[k], point, g, args.last_e, args.last_u);
            float gd_e = gd[k].x, gd_n = gd[k].y, gd_u = gd[k].z;
            if (r.valid) {
                const float g_te = -ge[k] * scale_e;
                const float g_tu = gu[k] * scale_u;
                const float g_t = g_te * r.de + g_tu * r.du;
                const float g_b = g_t / r.a;
                const float g_a = -g_b * r.t - gi[k] * magnitude;
                gd_e += g_te * r.t + g_a * g.nx;
                gd_n += g_a * g.ny;
                gd_u += g_tu * r.t + g_a * g.nz;
                go_e += g_te - g_b * g.nx;
                go_n -= g_b * g.ny;
                go_u += g_tu - g_b * g.nz;
            }
            gp_e += r.cos_u * gd_e + r.cos_e * r.sin_u * gd_n + r.sin_e * r.sin_u * gd_u;
            gp_n += -r.sin_u * gd_e + r.cos_e * r.cos_u * gd_n + r.sin_e * r.cos_u * gd_u;
            gp_u += -r.sin_e * gd_n + r.cos_e * gd_u;
        }
    }
    reinterpret_cast<float4*>(grad_preferred + point_offset)[0] = make_float4(gp_e, gp_n, gp_u, 0.0f);
    reinterpret_cast<float4*>(grad_origins + point_offset)[0] = make_float4(go_e, go_n, go_u, 0.0f);
}

cudaError_t prepare(const BlockedArgs& args, int device, int64_t* blocks) {
    const cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return status;
    *blocks = args.num_maps * ((args.points + kThreads - 1) / kThreads);
    if (*blocks > 0x7fffffff) return cudaErrorInvalidValue;
    return cudaSuccess;
}

// The epilogue's grid: blocks of kThreads * kItems rays along x, the heliostats along y.
cudaError_t prepare_epilogue(int64_t num_maps, int64_t rays_per_map, int device, dim3* grid) {
    const cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return status;
    const int64_t tiles = (rays_per_map + kThreads * kItems - 1) / (kThreads * kItems);
    if (tiles > 0x7fffffff || num_maps > 65535) return cudaErrorInvalidValue;
    *grid = dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(num_maps));
    return cudaSuccess;
}

}  // namespace

extern "C" int blocked_trace_forward(BlockedArgs args, float* directions, float* distances, float* out_e,
                                     float* out_u, float* intensities, float* partials,
                                     unsigned long long* on_target_counts, int device, void* stream) {
    int64_t blocks = 0;
    const cudaError_t status = prepare(args, device, &blocks);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (blocks == 0 || args.rays == 0) return cudaSuccess;
    blocked_trace_forward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        args, reinterpret_cast<float4*>(directions), distances, out_e, out_u, intensities, partials,
        on_target_counts);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int corridor_statistics(BlockedArgs args, const float* partials, float* statistics, int device,
                                   void* stream) {
    const cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (args.num_maps > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    if (args.num_maps == 0 || args.points == 0 || args.rays == 0) return cudaSuccess;
    corridor_statistics_kernel<<<static_cast<unsigned>(args.num_maps), kStatisticsThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(args, partials, statistics);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int blocked_epilogue(const float* intensities, const float* sigma, float* out_w,
                                unsigned long long* counts, int64_t num_maps, int64_t rays_per_map, float alpha,
                                float keep, float reflectivity, int device, void* stream) {
    dim3 grid;
    const cudaError_t status = prepare_epilogue(num_maps, rays_per_map, device, &grid);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (num_maps == 0 || rays_per_map == 0) return cudaSuccess;
    blocked_epilogue_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        intensities, sigma, out_w, counts, num_maps, rays_per_map, alpha, keep, reflectivity);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int blocked_epilogue_backward(const float* grad_w, const float* intensities, const float* sigma,
                                         float* grad_intensities, float* grad_sigma, int64_t num_maps,
                                         int64_t rays_per_map, float alpha, float keep, float reflectivity,
                                         int device, void* stream) {
    dim3 grid;
    const cudaError_t status = prepare_epilogue(num_maps, rays_per_map, device, &grid);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (num_maps == 0 || rays_per_map == 0) return cudaSuccess;
    blocked_epilogue_backward_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        grad_w, intensities, sigma, grad_intensities, grad_sigma, rays_per_map, alpha, keep, reflectivity);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int blocked_trace_backward(BlockedArgs args, const float* grad_directions, const float* grad_e,
                                      const float* grad_u, const float* grad_intensities, float* grad_preferred,
                                      float* grad_origins, int device, void* stream) {
    int64_t blocks = 0;
    const cudaError_t status = prepare(args, device, &blocks);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (blocks == 0) return cudaSuccess;
    blocked_trace_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        args, reinterpret_cast<const float4*>(grad_directions), grad_e, grad_u, grad_intensities, grad_preferred,
        grad_origins);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int blocked_args_size() { return static_cast<int>(sizeof(BlockedArgs)); }

extern "C" const char* blocked_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
