// Voxel tracer for Hopper: each ray's first voxel-face crossing.
//
// Replaces the TPU tracer wavefront_tpu/kernels/window_trace.py::_kernel
// (called by window_trace()).  That kernel tiles the grid into 32^3
// windows and extracts voxel bits with one-hot matrix products because the
// TPU has no in-kernel gather; the semantics it computes are the DDA of
// wavefront_tpu/render/intersect.py::dda_trace, and that is what this
// kernel does, one thread per ray, with ordinary loads.
//
// What bounds it on this card: the grid (160x32x160 bytes at the headline,
// 819 KB) and the 256-byte class table stay in L2 and shared memory, so
// device memory sees only each ray's 24 bytes in and 12 bytes out.  The
// work is a dependent chain of one byte load per voxel boundary crossed
// (up to gx+gy+gz per ray), so the kernel is bound by load latency and
// warp divergence (rays of one warp march different lengths), not by
// bytes.  The design keeps the per-step state in registers, reads the
// class bits from shared memory, and leaves the ray order to the caller's
// coherence sort, which groups rays of one warp by window and direction.
//
// Arithmetic mirrors render/intersect.py::trace_plain operation for
// operation (build with -fmad=false): slab entry, 1e-4 nudge, pre-entry
// voxel for rays that start outside, crossing times recomputed from the
// voxel index every step, x-before-y-before-z ties, enter-beats-exit.

#include <cuda_runtime.h>
#include <stdint.h>

#define INF_T 3.0e38f
#define NUDGE 1e-4f
#define AIR_ID 255
#define C_TRANSPARENT 1
#define C_TRANSLUCENT 2

namespace {

struct Grid {
    const uint8_t* ids;
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

__device__ __forceinline__ bool in_grid(const Grid& g, int x, int y, int z) {
    return x >= 0 && x < g.gx && y >= 0 && y < g.gy && z >= 0 && z < g.gz;
}

__device__ __forceinline__ int flat_index(const Grid& g, int x, int y, int z) {
    x = min(max(x, 0), g.gx - 1);
    y = min(max(y, 0), g.gy - 1);
    z = min(max(z, 0), g.gz - 1);
    return (x * g.gy + y) * g.gz + z;
}

__global__ void __launch_bounds__(256) trace_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dxs,
    const float* __restrict__ dys, const float* __restrict__ dzs,
    Grid g, const uint8_t* __restrict__ cls_table,
    float gox, float goy, float goz, int n, int max_events,
    float t_min, float t_max,
    int* __restrict__ pa_out, int* __restrict__ pb_out,
    float* __restrict__ t_out)
{
    __shared__ uint8_t cls[256];
    for (int k = threadIdx.x; k < 256; k += blockDim.x) cls[k] = cls_table[k];
    __syncthreads();
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

    int hit = 0, face = 0, ovx = 0, ovy = 0, ovz = 0, entered = 0;
    float ot = INF_T;
    if (active) {
        const int sx = sgn(dx), sy = sgn(dy), sz = sgn(dz);
        const float tn = t_entry + NUDGE;
        int vx = (int)floorf(px + dx * tn);
        int vy = (int)floorf(py + dy * tn);
        int vz = (int)floorf(pz + dz * tn);
        if (t_near > t_min) {             // starts outside: pre-entry voxel
            if (nx >= ny && nx >= nz) vx -= sx;
            else if (ny >= nz) vy -= sy;
            else vz -= sz;
        }
        int cur = in_grid(g, vx, vy, vz)
            ? cls[g.ids[flat_index(g, vx, vy, vz)]]
            : (C_TRANSPARENT | C_TRANSLUCENT);
        float tx = cross_time(vx, px, ivx, sx, mx);
        float ty = cross_time(vy, py, ivy, sy, my);
        float tz = cross_time(vz, pz, ivz, sz, mz);
        for (int step = 0; step < max_events; ++step) {
            const bool use_x = tx <= ty && tx <= tz;
            const bool use_y = !use_x && ty <= tz;
            const bool use_z = !use_x && !use_y;
            const float tc = use_x ? tx : (use_y ? ty : tz);
            const int nvx = vx + (use_x ? sx : 0);
            const int nvy = vy + (use_y ? sy : 0);
            const int nvz = vz + (use_z ? sz : 0);
            const bool inside = in_grid(g, nvx, nvy, nvz);
            const int nxt = inside ? cls[g.ids[flat_index(g, nvx, nvy, nvz)]]
                                   : (C_TRANSPARENT | C_TRANSLUCENT);
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
                ovx = enter ? nvx : vx;
                ovy = enter ? nvy : vy;
                ovz = enter ? nvz : vz;
                active = false;
                break;
            }
            active = inside && !(tc > limit);
            if (!active) break;
            vx = nvx; vy = nvy; vz = nvz;
            tx = cross_time(vx, px, ivx, sx, mx);
            ty = cross_time(vy, py, ivy, sy, my);
            tz = cross_time(vz, pz, ivz, sz, mz);
            cur = nxt;
        }
    }
    const int owner = hit ? (int)g.ids[flat_index(g, ovx, ovy, ovz)] : AIR_ID;
    const int truncated = active ? 1 : 0;   // still marching: budget spent
    pa_out[i] = hit | (entered << 1) | (face << 2)
        | (min(max(ovy + 2, 0), 511) << 5) | ((owner & 255) << 14)
        | (truncated << 22);
    pb_out[i] = min(max(ovx + 2, 0), 1023)
        | (min(max(ovz + 2, 0), (1 << 20) - 1) << 10);
    t_out[i] = ot;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int wt_trace(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const uint8_t* grid, int gx, int gy, int gz, const uint8_t* cls_table,
    float gox, float goy, float goz, int n, int max_events,
    float t_min, float t_max, int* pa, int* pb, float* t, void* stream)
{
    if (n <= 0) return 0;
    const int block = 256;
    const int blocks = (n + block - 1) / block;
    Grid g{grid, gx, gy, gz};
    trace_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, g, cls_table, gox, goy, goz, n, max_events,
        t_min, t_max, pa, pb, t);
    return (int)cudaGetLastError();
}
