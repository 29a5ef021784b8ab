// The sparse NEE pdf sweep for Hopper: for each ray, the sum over the light
// prims its outgoing direction crosses of walk * t^2 / (cos_theta * area)
// (reference nee_pdf.rs:264-334), with the first `max_hits` crossings in
// prim order summed and every crossing counted.
//
// Replaces no TPU kernel: the JAX package's sparse sweep
// (wavefront_tpu/render/wavefront.py::nee_pdf_sweep) is jnp code that XLA
// fuses, not a Pallas kernel.  In PyTorch's eager mode the same sweep
// (render/wavefront.py::nee_sweep_plain) builds (rays x 64) float32
// temporaries a prim tile, gathers its crossings with `torch.nonzero`
// and boolean masks, and walks the light BVH level by level: host syncs
// and hundreds of launches a bounce for a test whose inputs are ~40 B a
// ray.
//
// What bounds it on this card: operations.  Each ray is tested against
// every prim: the plane test, 17 float32 operations (no fused
// multiply-adds), then an IEEE divide and ~38 more for the hit point and
// its place in the prim; each crossing kept in a slot adds a reverse walk
// of the light BVH, two 8-corner box importances a level.  Bytes are ~44
// a ray.  The design spends little but those operations:
//   * one thread a ray, in a persistent grid that strides over the rays;
//     the ray's pdf and crossing count stay in registers;
//   * the prims' constants (p0, e1, e2, nv, d11, d22, d12, inv_det, the
//     triangle flag) are computed once per block into shared memory, a
//     tile of TILE prims at a time, five float4 a prim; every thread of a
//     warp reads the same prim, so each read is a broadcast.  A set of at
//     most TILE prims is staged once per block; a larger one is staged
//     tile by tile for each block of rays;
//   * every test runs whole, without a branch: a warp's rays (neighbours
//     after the bounce sort, aimed at different lamps) disagree on which
//     planes lie ahead, and skipping the divide and the rest where no lane
//     had one ahead measured slower (the prim loop 3.43 ms against 3.00 a
//     bounce of the lamp-lit window, PERF.md);
//   * a kept crossing's prim and t wait in shared memory (SLOTS a thread,
//     walked in slot order whenever SLOTS are held, so any max_hits
//     works), and the walks run after the prim loop: the lanes of a warp
//     cross different prims, and a walk taken at its crossing ran alone
//     while the other 31 lanes waited (6.36 ms against 3.50 a bounce);
//   * the node table (1,024 rows at the lamp-lit window) is read through
//     the read-only cache;
//   * crossings and overflowing rays: one block reduction and one 64-bit
//     atomic each, into a device counter the renderer reads with its
//     frame's audit.
//
// The arithmetic repeats nee_sweep_plain's float32 operations one for one
// (_prim_tile_hits, reverse_walk_prob, aabb_importance; build with
// -fmad=false), so crossings, slots and walks are the plain version's.
// The prims' normals nv come in from the wrapper, made by the plain
// version's own op (torch.linalg.cross on the same device), whose CUDA
// build may contract a product into a fused multiply-add.  Only the sum
// of a ray's slots runs in another order than PyTorch's reduction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "light_bvh.cuh"

namespace {

constexpr int BLOCK = 256;
// prims a shared-memory tile: 5 float4 each, 20 KB a block
constexpr int TILE = 256;
// kept crossings a thread holds before it walks them: 16 KB a block
constexpr int SLOTS = 8;
// PyTorch compares a float32 tensor with a Python float as float32: each
// threshold is the float32 nearest its double
constexpr float EPS_NEE = (float)1e-4;   // core/config.py EPSILON_NEE
constexpr float T_MAX = (float)1000.0;   // core/config.py T_MAX
constexpr float PARALLEL = (float)1e-12;
constexpr float SINGULAR = (float)1e-20;
constexpr float TINY = (float)1e-30;

struct Rays {
    const float *px, *py, *pz, *nx, *ny, *nz, *dx, *dy, *dz, *mis;
};

struct Prims {
    const float *p0, *e1, *e2, *nv, *area;   // (P, 3) x 4, (P,)
    const uint8_t* is_tri;                   // (P,) bool
    const long long* leaf;                   // (P,) leaf node
    int num_prims;
};

// uint32 fields carried as int64, 0xFFFFFFFF (or a negative) for none
struct Nodes {
    const long long *left, *right, *parent;  // (M,)
    const float *mn, *mx, *power;            // (M, 3), (M, 3), (M,)
};

// reverse_walk_prob of one leaf: the descent's probability of reaching
// it, rebuilt bottom-up through the parent pointers (nee_pdf.rs:154-228)
__device__ __forceinline__ float reverse_walk(
    const Nodes& nd, int node, int max_depth,
                              float px, float py, float pz, float nx,
                              float ny, float nz)
{
    float walk = 1.0f;
    for (int level = 0; level < max_depth; ++level) {
        const int parent = node_index(nd.parent, node);
        if (parent < 0) break;
        const int li = max(node_index(nd.left, parent), 0);
        const int ri = max(node_index(nd.right, parent), 0);
        const float il = box_importance(nd.mn, nd.mx, nd.power, li, px, py,
                                        pz, nx, ny, nz, EPS_NEE);
        const float ir = box_importance(nd.mn, nd.mx, nd.power, ri, px, py,
                                        pz, nx, ny, nz, EPS_NEE);
        const float total = il + ir;
        // total > 0 is false for a NaN, which gives the branch 0, as the
        // plain version's select does
        const float branch = total > 0.0f
            ? (node == li ? il : ir) / fmaxf(total, TINY) : 0.0f;
        walk = walk * branch;
        node = parent;
    }
    return walk;
}

// prim j's constants, _prim_tile_hits' formulas, into its five float4:
// (p0, nv.x) (nv.y, nv.z, e1.x, e1.y) (e1.z, e2) (d11, d22, d12, inv_det)
// (0, triangle flag, 0, 0)
__device__ __forceinline__ void stage_prim(const Prims& pr, int j,
                                           float4* s)
{
    const float* p0 = pr.p0 + 3 * j;
    const float* e1 = pr.e1 + 3 * j;
    const float* e2 = pr.e2 + 3 * j;
    const float* nv = pr.nv + 3 * j;
    const float ax = e1[0], ay = e1[1], az = e1[2];
    const float bx = e2[0], by = e2[1], bz = e2[2];
    const float d11 = (ax * ax + ay * ay) + az * az;
    const float d22 = (bx * bx + by * by) + bz * bz;
    const float d12 = (ax * bx + ay * by) + az * bz;
    const float det = d11 * d22 - d12 * d12;
    const float inv_det = fabsf(det) > SINGULAR ? 1.0f / det : 0.0f;
    s[0] = make_float4(p0[0], p0[1], p0[2], nv[0]);
    s[1] = make_float4(nv[1], nv[2], ax, ay);
    s[2] = make_float4(az, bx, by, bz);
    s[3] = make_float4(d11, d22, d12, inv_det);
    s[4] = make_float4(0.0f, pr.is_tri[j] ? 1.0f : 0.0f, 0.0f, 0.0f);
}

// the kept crossings (prim, t) held by a thread until they are walked:
// a warp's lanes find theirs at different prims, and a walk taken at its
// crossing runs alone while the warp's other lanes wait; walked together
// after the prim loop, the lanes' walks overlap
__device__ __forceinline__ void walk_slots(
    const Prims& pr, const Nodes& nd, const int* s_prim, const float* s_t,
    int kept, int max_depth, float px, float py, float pz, float nx,
    float ny, float nz, float cos_theta, float& pdf)
{
    for (int k = 0; k < kept; ++k) {
        const int j = s_prim[k * BLOCK];
        const float t = s_t[k * BLOCK];
        const float walk = reverse_walk(nd, (int)__ldg(pr.leaf + j),
                                        max_depth, px, py, pz, nx, ny, nz);
        pdf += walk * (t * t / (cos_theta * __ldg(pr.area + j)));
    }
}

__global__ void __launch_bounds__(BLOCK) nee_sweep_kernel(
    Rays r, Prims pr, Nodes nd, int max_depth, int max_hits,
    float* __restrict__ pdf_out, unsigned long long* __restrict__ counts,
    int n)
{
    __shared__ float4 s_prims[TILE][5];
    __shared__ int s_slot_prim[SLOTS * BLOCK];
    __shared__ float s_slot_t[SLOTS * BLOCK];
    __shared__ long long s_red[2][BLOCK / 32];
    int* my_prim = s_slot_prim + threadIdx.x;
    float* my_t = s_slot_t + threadIdx.x;
    const int np = pr.num_prims;
    const bool one_tile = np <= TILE;
    if (one_tile) {
        for (int j = threadIdx.x; j < np; j += BLOCK)
            stage_prim(pr, j, s_prims[j]);
        __syncthreads();
    }
    long long crossings = 0, overflow = 0;
    // the block's rays advance together, so every thread reaches the
    // tiles' barriers
    for (int base = blockIdx.x * BLOCK; base < n; base += gridDim.x * BLOCK) {
        const int i = base + threadIdx.x;
        float px = 0.0f, py = 0.0f, pz = 0.0f, nx = 0.0f, ny = 0.0f,
              nz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
        bool active = false;
        if (i < n) {
            dx = r.dx[i]; dy = r.dy[i]; dz = r.dz[i];
            active = r.mis[i] > 0.0f
                     && (dx != 0.0f || dy != 0.0f || dz != 0.0f);
            if (active) {
                px = r.px[i]; py = r.py[i]; pz = r.pz[i];
                nx = r.nx[i]; ny = r.ny[i]; nz = r.nz[i];
            }
        }
        const float cos_theta = (nx * dx + ny * dy) + nz * dz;
        float pdf = 0.0f;
        int count = 0, held = 0;
        for (int t0 = 0; t0 < np; t0 += TILE) {
            const int tn = min(TILE, np - t0);
            if (!one_tile) {
                __syncthreads();
                for (int j = threadIdx.x; j < tn; j += BLOCK)
                    stage_prim(pr, t0 + j, s_prims[j]);
                __syncthreads();
            }
            if (!active) continue;
            // the whole test on every prim, without branches: the lanes of
            // a warp disagree on which planes lie ahead, so a branch saved
            // nothing and cost its own instructions (PERF.md)
            for (int q = 0; q < tn; ++q) {
                const float4 a = s_prims[q][0], b = s_prims[q][1];
                const float4 c = s_prims[q][2], d = s_prims[q][3];
                // a = (p0, nv.x), b = (nv.y, nv.z, e1.x, e1.y),
                // c = (e1.z, e2), d = (d11, d22, d12, inv_det)
                const float denom = (dx * a.w + dy * b.x) + dz * b.y;
                const bool safe = fabsf(denom) > PARALLEL;
                const float t = (((a.x - px) * a.w + (a.y - py) * b.x)
                                 + (a.z - pz) * b.y)
                                / (safe ? denom : 1.0f);
                const float hx = px + dx * t - a.x;
                const float hy = py + dy * t - a.y;
                const float hz = pz + dz * t - a.z;
                const float r1 = (hx * b.z + hy * b.w) + hz * c.x;
                const float r2 = (hx * c.y + hy * c.z) + hz * c.w;
                const float u = (r1 * d.y - r2 * d.z) * d.w;
                const float v = (r2 * d.x - r1 * d.z) * d.w;
                const bool inside = s_prims[q][4].y > 0.5f
                    ? (u >= 0.0f && v >= 0.0f && u + v <= 1.0f)
                    : (u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f);
                if (!(safe && inside && t >= EPS_NEE && t <= T_MAX))
                    continue;
                if (count < max_hits) {
                    my_prim[held * BLOCK] = t0 + q;
                    my_t[held * BLOCK] = t;
                    if (++held == SLOTS) {
                        walk_slots(pr, nd, my_prim, my_t, held, max_depth,
                                   px, py, pz, nx, ny, nz, cos_theta, pdf);
                        held = 0;
                    }
                }
                ++count;
            }
        }
        walk_slots(pr, nd, my_prim, my_t, held, max_depth, px, py, pz, nx,
                   ny, nz, cos_theta, pdf);
        if (i < n) pdf_out[i] = pdf;
        crossings += count;
        overflow += count > max_hits;
    }
    // the block's sums, then one atomic each
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        crossings += __shfl_down_sync(0xffffffffu, crossings, off);
        overflow += __shfl_down_sync(0xffffffffu, overflow, off);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        s_red[0][warp] = crossings;
        s_red[1][warp] = overflow;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        long long c = 0, o = 0;
        for (int w = 0; w < BLOCK / 32; ++w) {
            c += s_red[0][w];
            o += s_red[1][w];
        }
        if (c) atomicAdd(counts, (unsigned long long)c);
        if (o) atomicAdd(counts + 1, (unsigned long long)o);
    }
}

}  // namespace

// rays: 10 device pointers of (n,) float32 (point xyz, normal xyz,
// direction xyz, MIS weight); prims: p0, e1, e2, nv (P, 3) float32, area
// (P,) float32, is_tri (P,) bool, leaf_node (P,) int64, of which the first
// num_prims are lights; nodes: left, right, parent (M,) int64 (0xFFFFFFFF
// for none), min, max (M, 3) and power (M,) float32.  pdf: (n,) float32
// out; counts: (2,) int64 that the crossings and the rays with more than
// max_hits of them are added to.  Returns cudaGetLastError().
extern "C" int ns_sweep(
    const float* px, const float* py, const float* pz, const float* nx,
    const float* ny, const float* nz, const float* dx, const float* dy,
    const float* dz, const float* mis,
    const float* p0, const float* e1, const float* e2, const float* nv,
    const float* area, const uint8_t* is_tri, const long long* leaf,
    int num_prims,
    const long long* left, const long long* right, const long long* parent,
    const float* mn, const float* mx, const float* power,
    int max_depth, int max_hits, float* pdf, long long* counts, int n,
    void* stream)
{
    if (num_prims < 0 || max_depth < 0 || max_hits < 0)
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const Rays r{px, py, pz, nx, ny, nz, dx, dy, dz, mis};
    const Prims pr{p0, e1, e2, nv, area, is_tri, leaf, num_prims};
    const Nodes nd{left, right, parent, mn, mx, power};
    // as many blocks as are resident at once, each looping over rays
    int resident = 0;
    const cudaError_t e =
        resident_blocks<nee_sweep_kernel, BLOCK>(&resident);
    if (e != cudaSuccess) return (int)e;
    const int blocks = min((n + BLOCK - 1) / BLOCK, resident);
    nee_sweep_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        r, pr, nd, max_depth, max_hits, pdf,
        reinterpret_cast<unsigned long long*>(counts), n);
    return (int)cudaGetLastError();
}
