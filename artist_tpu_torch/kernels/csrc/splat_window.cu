// Dynamic-window bilinear splat forward, and the 2-D window forward of the
// splat-formulation tool: hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   band_accumulate_kernel<kRowWindows>  <- _dyn_fwd_kernel
//       (artist_tpu/kernels/splat_pallas.py, via _dyn_forward,
//        bilinear_splat_dynamic_window)
//   band_accumulate_kernel<kTileWindows> <- _dyn2d_fwd_kernel
//       (tools/splat_formulation_bench.py, via dyn2d_forward)
// Both kernels are the full splat's forward, in splat_band.cuh. The VJP of
// the dynamic window (_dyn_bwd_kernel, via _dyn_bwd) is splat.cu's
// splat_backward_kernel, launched through splat.cu's library.
//
// Semantics: the 4-tap splat of splat.cu (strict bounds tested in float
// before any int cast, so NaN, +-inf and 1e30 are invalid; the (-1, +1)
// one-hot derivative factors; dw independent of w; zeros for invalid rays).
// The rays of each heliostat, in the point-major sequence that splat_band.cuh
// describes, are cut into blocks of `block` rays; each block has a window:
// rows [ou, ou + window_u) and, for the 2-D variant, columns
// [oe, oe + window_e). ou is floor(min u) over the block's valid rays, rounded
// down to a multiple of 8 and clamped to [0, H - window_u]; oe likewise to a
// multiple of 128 in [0, W - window_e]. The block fits when
// max u <= ou + window_u - 2 (and max e <= oe + window_e - 2), which covers
// the deposit rows floor(u) and floor(u) + 1. A block with no valid ray fits
// at offset 0. Validity is the in-bounds test, not w > 0: a zero-weight ray
// still gets dw and so must lie inside its window. These are the TPU
// kernels' offsets (_dyn_offsets, and the tool's dyn2d_forward) exactly.
//
// Why the window changes no output. On the TPU the window exists only to cut
// each block's one-hot matmul to 96 rows (the heliostat's map stays in VMEM
// across its blocks); a block that does not fit takes all rows in
// ownership-masked sub-windows. A fitting block's rays have all four taps
// inside its window, by the fit test, and a fallback block's sub-windows own
// each row once. So every deposit lands on its own pixel of the map, and every
// ray's (de, du, dw) reads its own four pixels of the cotangent: the forward
// is the full splat and the VJP is the full splat's gather, for every input.
// Here a heliostat's map is held on chip in bands of rows (splat.cu), where
// a per-tap scatter has no matmul for the window to cut, so the forward
// deposits every ray into the map and only plans the windows, to count the
// fitting blocks on the device; and the VJP gathers from the cotangent in
// device memory (L2-resident: a chunk's maps are 26 MB against a 50 MB L2),
// where staging a window in shared memory saved nothing (below).
//
// The rays are read where the render step makes them: `[M, r, P]` streams,
// r rays of each of P surface points, and the sequence that cuts the ray
// blocks takes the points in `order` (point_tile_order's spatial tiles, so a
// block's deposits are compact). The accumulate and the gather read the
// streams in their own layout, coalesced; only the plan reads them through
// the order (splat_band.cuh). So the render step copies no ray stream.
//
// Bound on the H100: bytes, as splat.cu's kernels: per ray 12 bytes read
// (forward) against 14 fp32 operations. Measured by chip_smoke.py and
// tools/window_turns.py on an H100 80GB HBM3 (700 W limit), replayed from a
// CUDA graph: at the block-window step's first chunk ([100, 4, 10000] rays)
// row 3 0.101 ms (row 1's kernel 0.095 on the same rays: the plan pass is the
// rest; bound 0.022) and row 4 0.041 ms (row 2's kernel, tools/backward_turns.py;
// 0.047 before its redesign; bound 0.030); at the
// formulation tool's 32 M rays row 13 0.625 ms (row 14 0.580; bound 0.123;
// PERF.md's kernel table). Before, the rays came as a point-major copy that the
// render step made with three index_selects a chunk (113 device events and
// 2.0 ms a step), row 3 planned its blocks inside the accumulate, row 4
// staged each fitting block's touched rows of the cotangent into 96 KB of
// shared memory with cp.async (two blocks an SM, 0.100-0.106 ms against the
// gather's 0.048 on the same rays), and row 13 accumulated each ray block in
// a 96 x 128 shared tile flushed with global atomics (0.72 ms at 32 M rays
// against the band kernel's 0.58).
//
// Interface: plain C, loaded with ctypes. The caller allocates every buffer
// (`fitting`: an int for each thread block, bands x min(M, 65535), which the
// kernel writes; the count is their sum) and passes PyTorch's current stream;
// each launch function returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue when the band does not fit shared memory or the sizes
// are refused.

#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_band.cuh"

extern "C" int splat_window_shared_limit(int device, int* bytes) {
    return static_cast<int>(cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Row 3: `order` holds P = rays_per_map / rays_per_point point indices, or is null.
extern "C" int splat_window_band_forward(const float* e, const float* u, const float* w, float* out, int* fitting,
                                         int64_t num_maps, int64_t rays_per_map, int height, int width,
                                         int band_rows, int block, int window, const int* order, int rays_per_point,
                                         int device, void* stream) {
    cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return static_cast<int>(status);
    return static_cast<int>(launch_band_accumulate<kRowWindows>(
        e, u, w, out, fitting, num_maps, rays_per_map, height, width, band_rows, block, window, order,
        rays_per_point, 0, device, static_cast<cudaStream_t>(stream)));
}

// Row 13: [M, N] rays, blocks of consecutive rays, windows of window_u x window_e.
extern "C" int splat_window_2d_band_forward(const float* e, const float* u, const float* w, float* out,
                                            int* fitting, int64_t num_maps, int64_t rays_per_map, int height,
                                            int width, int band_rows, int block, int window_u, int window_e,
                                            int device, void* stream) {
    cudaError_t status = cudaSetDevice(device);
    if (status != cudaSuccess) return static_cast<int>(status);
    return static_cast<int>(launch_band_accumulate<kTileWindows>(
        e, u, w, out, fitting, num_maps, rays_per_map, height, width, band_rows, block, window_u, nullptr, 1,
        window_e, device, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* splat_window_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
