// Voxel tracer for Hopper: each ray's first voxel-face crossing.
//
// Replaces the TPU tracer wavefront_tpu/kernels/window_trace.py::_kernel
// (called by window_trace()).  That kernel tiles the grid into 32^3
// windows and extracts voxel bits with one-hot matrix products because the
// TPU has no in-kernel gather; the semantics it computes are the DDA of
// wavefront_tpu/render/intersect.py::dda_trace with its empty-space skip
// (the TPU kernel's band and window skip fields), and that is what this
// kernel does, one thread per ray, with ordinary loads.
//
// What bounds it on this card: the grid and its aux grid (160x32x160 bytes
// each at the headline, 819 KB) stay in L2, so device memory sees only each
// ray's 24 bytes in and 12 bytes out.  The work is a dependent chain of
// steps, one byte load each, and the kernel is bound by instruction issue
// (measured: tools/event_lab.py), so the design spends as few instructions
// a step as the semantics allow:
//   * one load a step: the aux byte holds the class bits and the distance
//     to the nearest solid (bits 2-6), so there is no class table;
//   * from a voxel at distance d >= 2 the ray jumps to 1e-4 before the
//     exit of the radius-(d-1) cube, where no face can lie (dda_trace's
//     skip, in its float order): most of a primary ray's air is crossed
//     in a few skips;
//   * a fine crossing recomputes only the stepped axis's crossing time
//     (the other two are the same expression of unchanged values, so the
//     same floats), moves the flat index by +-gy*gz, +-gz or +-1, and
//     range-checks only the stepped axis (the others are held in flags,
//     set in full at the start and after a skip: the pre-entry voxel may
//     lie outside on more than one axis at a corner).
// Crossing times are recomputed from the voxel index, never accumulated
// (`t += |inv|` drifts an ulp and flips ties, dda_trace:400-404).
//
// Arithmetic mirrors render/intersect.py::trace_plain operation for
// operation (build with -fmad=false): slab entry, 1e-4 nudge, pre-entry
// voxel for rays that start outside, x-before-y-before-z ties,
// enter-beats-exit, a skip counting as one step of the budget.

#include <cuda_runtime.h>
#include <stdint.h>

#define INF_T 3.0e38f
#define NUDGE 1e-4f
#define SKIP_NUDGE 1e-4f
#define AIR_ID 255
#define C_TRANSPARENT 1
#define C_TRANSLUCENT 2
#define C_AIR (C_TRANSPARENT | C_TRANSLUCENT)

namespace {

struct Grid {
    const uint8_t* ids;
    const uint8_t* aux;
    int gx, gy, gz;
};

__device__ __forceinline__ float safe_inv(float d) {
    float tiny = d >= 0.0f ? 1e-30f : -1e-30f;
    return 1.0f / (fabsf(d) < 1e-30f ? tiny : d);
}

__device__ __forceinline__ int sgn(float d) {
    return (d > 0.0f) - (d < 0.0f);
}

__device__ __forceinline__ float cross_time(int v, float p, float inv,
                                            int s, bool moving) {
    float bound = (float)v + (s > 0 ? 1.0f : 0.0f);
    return moving ? (bound - p) * inv : INF_T;
}

// where the ray leaves the radius-r cube around voxel v along one axis
__device__ __forceinline__ float cube_exit(int v, float p, float inv, int s,
                                           bool moving, float r) {
    float bound = (float)v + (s > 0 ? r + 1.0f : -r);
    return moving ? (bound - p) * inv : INF_T;
}

__device__ __forceinline__ bool in_range(int v, int n) {
    return (unsigned)v < (unsigned)n;
}

__global__ void __launch_bounds__(256) trace_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dxs,
    const float* __restrict__ dys, const float* __restrict__ dzs,
    Grid g, float gox, float goy, float goz, int n, int max_events,
    float t_min, float t_max,
    int* __restrict__ pa_out, int* __restrict__ pb_out,
    float* __restrict__ t_out)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    const float px = ox[i] - gox, py = oy[i] - goy, pz = oz[i] - goz;
    const float dx = dxs[i], dy = dys[i], dz = dzs[i];
    const bool valid = dx != 0.0f || dy != 0.0f || dz != 0.0f;
    const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
    const bool mx = fabsf(dx) > 1e-30f, my = fabsf(dy) > 1e-30f,
               mz = fabsf(dz) > 1e-30f;

    float lo, hi;
    lo = (0.0f - px) * ivx; hi = ((float)g.gx - px) * ivx;
    const float nx = mx ? fminf(lo, hi) : -INF_T, fx = mx ? fmaxf(lo, hi) : INF_T;
    lo = (0.0f - py) * ivy; hi = ((float)g.gy - py) * ivy;
    const float ny = my ? fminf(lo, hi) : -INF_T, fy = my ? fmaxf(lo, hi) : INF_T;
    lo = (0.0f - pz) * ivz; hi = ((float)g.gz - pz) * ivz;
    const float nz = mz ? fminf(lo, hi) : -INF_T, fz = mz ? fmaxf(lo, hi) : INF_T;
    const float t_near = fmaxf(nx, fmaxf(ny, nz));
    const float t_far = fminf(fx, fminf(fy, fz));
    const float t_entry = fmaxf(t_near, t_min);
    const float limit = fminf(t_far, t_max);
    bool active = valid && t_entry <= limit;

    int hit = 0, face = 0, ovx = 0, ovy = 0, ovz = 0, entered = 0, oidx = 0;
    float ot = INF_T;
    if (active) {
        const int sx = sgn(dx), sy = sgn(dy), sz = sgn(dz);
        const int gyz = g.gy * g.gz;
        // flat-index moves of a fine step along each axis
        const int dix = sx * gyz, diy = sy * g.gz, diz = sz;
        const float tn = t_entry + NUDGE;
        int vx = (int)floorf(px + dx * tn);
        int vy = (int)floorf(py + dy * tn);
        int vz = (int)floorf(pz + dz * tn);
        if (t_near > t_min) {             // starts outside: pre-entry voxel
            if (nx >= ny && nx >= nz) vx -= sx;
            else if (ny >= nz) vy -= sy;
            else vz -= sz;
        }
        bool okx = in_range(vx, g.gx), oky = in_range(vy, g.gy),
             okz = in_range(vz, g.gz);
        int idx = (vx * g.gy + vy) * g.gz + vz;
        int cur = (okx && oky && okz) ? (int)__ldg(g.aux + idx) : C_AIR;
        float tx = cross_time(vx, px, ivx, sx, mx);
        float ty = cross_time(vy, py, ivy, sy, my);
        float tz = cross_time(vz, pz, ivz, sz, mz);
        for (int step = 0; step < max_events; ++step) {
            const int dist = cur >> 2;
            if (dist >= 2) {
                // empty-space skip: no face inside the radius-(dist-1) cube
                const float r = (float)(dist - 1);
                const float t_exit = fminf(
                    cube_exit(vx, px, ivx, sx, mx, r),
                    fminf(cube_exit(vy, py, ivy, sy, my, r),
                          cube_exit(vz, pz, ivz, sz, mz, r)));
                const float t_land = t_exit - SKIP_NUDGE;
                vx = (int)floorf(px + dx * t_land);
                vy = (int)floorf(py + dy * t_land);
                vz = (int)floorf(pz + dz * t_land);
                okx = in_range(vx, g.gx);
                oky = in_range(vy, g.gy);
                okz = in_range(vz, g.gz);
                if (!(okx && oky && okz) || t_land > limit) {
                    active = false;
                    break;
                }
                idx = (vx * g.gy + vy) * g.gz + vz;
                cur = (int)__ldg(g.aux + idx);
                tx = cross_time(vx, px, ivx, sx, mx);
                ty = cross_time(vy, py, ivy, sy, my);
                tz = cross_time(vz, pz, ivz, sz, mz);
                continue;
            }
            // fine crossing: only the stepped axis changes
            const bool use_x = tx <= ty && tx <= tz;
            const bool use_y = !use_x && ty <= tz;
            const float tc = use_x ? tx : (use_y ? ty : tz);
            int nidx;
            bool inside;
            if (use_x) {
                vx += sx; okx = in_range(vx, g.gx); nidx = idx + dix;
            } else if (use_y) {
                vy += sy; oky = in_range(vy, g.gy); nidx = idx + diy;
            } else {
                vz += sz; okz = in_range(vz, g.gz); nidx = idx + diz;
            }
            inside = okx && oky && okz;
            const int nxt = inside ? (int)__ldg(g.aux + nidx) : C_AIR;
            const bool enter = (nxt & C_TRANSPARENT) == 0 &&
                               (cur & C_TRANSLUCENT) != 0;
            const bool leave = (cur & C_TRANSPARENT) == 0 &&
                               (nxt & C_TRANSLUCENT) != 0;
            if (tc <= limit && tc >= t_min && (enter || leave)) {
                const int ax_step = use_x ? sx : (use_y ? sy : sz);
                const int axis = use_x ? 0 : (use_y ? 1 : 2);
                const int nsign = enter ? -ax_step : ax_step;
                hit = 1;
                ot = tc;
                face = axis * 2 + (nsign > 0 ? 1 : 0);
                entered = enter ? 1 : 0;
                // the owner is the voxel entered, or the one left
                ovx = vx - (enter || !use_x ? 0 : sx);
                ovy = vy - (enter || !use_y ? 0 : sy);
                ovz = vz - (enter || use_x || use_y ? 0 : sz);
                oidx = enter ? nidx : idx;
                active = false;
                break;
            }
            active = inside && !(tc > limit);
            if (!active) break;
            idx = nidx;
            if (use_x) tx = cross_time(vx, px, ivx, sx, mx);
            else if (use_y) ty = cross_time(vy, py, ivy, sy, my);
            else tz = cross_time(vz, pz, ivz, sz, mz);
            cur = nxt;
        }
    }
    // a face's owner is never transparent, so it lies inside the grid
    const int owner = hit ? (int)g.ids[oidx] : AIR_ID;
    const int truncated = active ? 1 : 0;   // still marching: budget spent
    pa_out[i] = hit | (entered << 1) | (face << 2)
        | (min(max(ovy + 2, 0), 511) << 5) | ((owner & 255) << 14)
        | (truncated << 22);
    pb_out[i] = min(max(ovx + 2, 0), 1023)
        | (min(max(ovz + 2, 0), (1 << 20) - 1) << 10);
    t_out[i] = ot;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `aux` is
// the (gx, gy, gz) uint8 aux grid of render/intersect.py::make_aux_grid.
extern "C" int wt_trace(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const uint8_t* grid, const uint8_t* aux, int gx, int gy, int gz,
    float gox, float goy, float goz, int n, int max_events,
    float t_min, float t_max, int* pa, int* pb, float* t, void* stream)
{
    if (n <= 0) return 0;
    const int block = 256;
    const int blocks = (n + block - 1) / block;
    Grid g{grid, aux, gx, gy, gz};
    trace_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, g, gox, goy, goz, n, max_events,
        t_min, t_max, pa, pb, t);
    return (int)cudaGetLastError();
}
