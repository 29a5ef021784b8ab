// The forward light-BVH walk for Hopper (S4): for each ray, the stochastic
// top-down descent of a sparse light set's BVH, importance-proportional at
// every split (reference raytrace.rs:230-293), with one murmur3 uniform a
// level: the picked leaf's prim, the product of the branch probabilities
// and the leaf's importance.
//
// Replaces no TPU kernel: the JAX package's walk
// (wavefront_tpu/render/wavefront.py::traverse_light_bvh) is jnp code that
// XLA fuses, not a Pallas kernel.  In PyTorch's eager mode the same walk
// (render/wavefront.py::light_walk_plain) steps every ray one level at a
// time: a level gathers int64 node indices and two (N, 7) box rows, runs
// two box importances of ~80 elementwise launches each over the bounce's
// rays, draws with the int64-carried murmur3 and asks the host whether a
// walk still runs (a host sync) -- ~190 launches and a sync a level, ~13
// levels a bounce, for work of ~200 operations a ray-level.
//
// What bounds it on this card: operations.  A level of a ray is two
// 8-corner box importances, the branch probability (an IEEE divide) and
// the draw; its inputs are ~33 B a ray and its outputs ~17.  The design
// spends little but those operations:
//   * one thread a ray, in a persistent grid that strides over the rays;
//     the ray's node, probability, importance and seed stay in registers,
//     and the levels run in a loop: one launch a bounce, no host sync;
//   * the node table (1,024 rows, ~45 KB, at the lamp-lit window) is read
//     from the raw LightArrays tensors through the read-only cache, where
//     it stays: a level reads the two children's rows and the chosen
//     child's two index fields.  One form for every table size: the walk
//     is ~0.7 ms of a ~48 ms lamp-lit frame (PERF.md), so a second,
//     shared-memory form of the table could move the frame by little;
//   * the lanes of a warp descend in lock-step, one level per iteration,
//     and differ only in which rows they read; a ray that reaches its leaf
//     early idles for the few levels by which the warp's depths differ.
//
// The arithmetic repeats light_walk_plain's float32 operations one for one
// (light_bvh.cuh's box_importance, which S3 shares, with the BVH epsilon;
// the branch probability and its 0/0 rule; the draw; build with
// -fmad=false), and the murmur3 is core/rng.py's on uint32 (light_bvh.cuh):
// success, prim, probability and importance are the plain version's bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "light_bvh.cuh"

namespace {

constexpr int BLOCK = 512;
// PyTorch compares a float32 tensor with a Python float as float32: each
// threshold is the float32 nearest its double
constexpr float EPS_BLOCK = (float)1e-3;   // core/config.py EPSILON_BLOCK
constexpr float TINY = (float)1e-30;

struct Rays {
    const float *px, *py, *pz, *nx, *ny, *nz;
    const long long* seed;    // (N,) uint32 values carried as int64
    const uint8_t* active;    // (N,) bool
};

// uint32 fields carried as int64, 0xFFFFFFFF (or a negative) for none
struct Nodes {
    const long long *left, *right;      // (M,)
    const float *mn, *mx, *power;       // (M, 3), (M, 3), (M,)
};

struct Out {
    uint8_t* success;
    long long* prim;
    float *prob, *imp;
};

// light_walk_plain's descent of rays i = first, first + stride, ...
__global__ void __launch_bounds__(BLOCK) light_walk_kernel(
    Rays r, Nodes nd, int max_depth, Out out, int n)
{
    // the dummy-root check (reference raytrace.rs:235-243)
    const int root_left = node_index(nd.left, 0);
    const bool root_leaf = root_left < 0;
    const bool have_lights = !(root_leaf && node_index(nd.right, 0) < 0);
    for (int i = blockIdx.x * BLOCK + threadIdx.x; i < n;
         i += gridDim.x * BLOCK) {
        const float px = r.px[i], py = r.py[i], pz = r.pz[i];
        const float nx = r.nx[i], ny = r.ny[i], nz = r.nz[i];
        const bool active = r.active[i] != 0;
        int node = 0, left = root_left;
        float prob = 1.0f;
        float imp = root_leaf
            ? box_importance(nd.mn, nd.mx, nd.power, 0, px, py, pz, nx, ny,
                             nz, EPS_BLOCK)
            : 0.0f;
        if (active && have_lights) {
            uint32_t s = (uint32_t)r.seed[i];
            for (int level = 0; level < max_depth && left >= 0; ++level) {
                const int li = left, ri = max(node_index(nd.right, node), 0);
                const float il = box_importance(nd.mn, nd.mx, nd.power, li,
                                                px, py, pz, nx, ny, nz,
                                                EPS_BLOCK);
                const float ir = box_importance(nd.mn, nd.mx, nd.power, ri,
                                                px, py, pz, nx, ny, nz,
                                                EPS_BLOCK);
                const float total = il + ir;
                // the reference divides blindly (raytrace.rs:279-280); its
                // 0/0 NaN sends the walk right with importance 0.  total > 0
                // is false for a NaN, as the plain version's select is
                const float norm_l = total > 0.0f
                    ? il / fmaxf(total, TINY) : 0.0f;
                const bool go_left = m3_finalizef(s) < norm_l;
                node = go_left ? li : ri;
                prob = prob * (go_left ? norm_l : 1.0f - norm_l);
                imp = go_left ? il : ir;
                left = node_index(nd.left, node);
                s = m3_combine(s, 0u);
            }
        }
        const bool success = active && have_lights && left < 0;
        out.success[i] = success;
        out.prim[i] = success ? max(node_index(nd.right, node), 0) : 0;
        out.prob[i] = prob;
        out.imp[i] = imp;
    }
}

}  // namespace

// rays: 6 device pointers of (n,) float32 (point xyz, normal xyz), seed (n,)
// int64 holding uint32 values, active (n,) bool; nodes: left, right (m,)
// int64 (0xFFFFFFFF for none), min, max (m, 3) and power (m,) float32.
// Out: success (n,) bool, prim (n,) int64, probability and importance (n,)
// float32.  Returns cudaGetLastError().
extern "C" int lw_walk(
    const float* px, const float* py, const float* pz, const float* nx,
    const float* ny, const float* nz, const long long* seed,
    const uint8_t* active,
    const long long* left, const long long* right, const float* mn,
    const float* mx, const float* power, int m, int max_depth,
    uint8_t* success, long long* prim, float* prob, float* imp, int n,
    void* stream)
{
    if (m < 1 || max_depth < 0) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const Rays r{px, py, pz, nx, ny, nz, seed, active};
    const Nodes nd{left, right, mn, mx, power};
    const Out out{success, prim, prob, imp};
    // as many blocks as are resident at once, each looping over rays
    int resident = 0;
    const cudaError_t e =
        resident_blocks<light_walk_kernel, BLOCK>(&resident);
    if (e != cudaSuccess) return (int)e;
    light_walk_kernel<<<min((n + BLOCK - 1) / BLOCK, resident), BLOCK, 0,
                        (cudaStream_t)stream>>>(r, nd, max_depth, out, n);
    return (int)cudaGetLastError();
}
