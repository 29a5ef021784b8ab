// The entity triangle sweep for Hopper (S5): for each ray, the closest-hit
// Moller-Trumbore test over the active triangles of the scene's entity
// pool (the port's stand-in for the reference's per-entity BLAS,
// scene.rs:150-202): hit, t, the winning pool slot and its barycentrics.
//
// Replaces no TPU kernel: the JAX package's sweep
// (wavefront_tpu/render/intersect.py::triangle_sweep) is jnp code that XLA
// fuses, not a Pallas kernel.  In PyTorch's eager mode the same sweep
// (render/intersect.py::triangle_sweep_plain) gathers the active slots
// with `nonzero` (a host sync) and runs ~40 elementwise launches over
// (rays x triangles) temporaries for each of the bounce's eight chunks of
// 2^18 rays -- ~330 launches and a sync a bounce, for work of ~60
// operations a ray-triangle test.
//
// What bounds it on this card: operations, at the game's 12 triangles
// (the ego cube) 12 tests of ~64 operations a ray against 24 bytes in and
// 21 out (84 a ray in the fused shade's form); the pool (64 slots of 37
// bytes) is read once a block.  The
// design spends little but those operations:
//   * one thread a ray; each block stages the pool's active triangles in
//     shared memory in slot order (a ballot over the active mask, read on
//     the device: no host sync), v0 and the edges e1 = v1 - v0, e2 = v2 -
//     v0 as the plain version computes them, a tile of BLOCK slots at a
//     time, so any pool size works;
//   * a ray tests the staged triangles in slot order and keeps a strictly
//     smaller t, so the first slot wins a tie, as `argmin` does;
//   * block 0 adds the number of active triangles to the caller's counter
//     (the renderer reads it with the frame's audit), so the count costs
//     no launch and no sync;
//   * the fused shade's form (STREAM) also merges the hit into the
//     tracer's (pa, t) and writes K2's 12-word entity stream
//     (renderer.py::entity_attrs_plain): the merged t, the winning
//     triangle's normal, tangent, bitangent and uv from its slot's
//     vertices and barycentrics, and texture | use << 16.  On the ~1% of
//     rays an entity wins that is ~70 more operations; the stream's ~30
//     eager launches a bounce (gathers of (N, 3, 3) rows, crosses, norms)
//     are gone.
//
// The arithmetic repeats triangle_sweep_plain's float32 operations one for
// one in its order, with __fmul_rn / __fadd_rn / __fsub_rn so that nothing
// contracts into a fused multiply-add (the build also has -fmad=false):
// pvec = d x e2, det = (p . e1) left to right, |det| > 1e-12, inv_det =
// 1 / det (IEEE), u, qvec = tvec x e1, v, t, the u/v/t range tests and the
// zero-direction test.  hit, t and the slot are the plain version's bit for
// bit on every ray, and u and v on every hit ray; a miss writes t 3e38,
// slot 0 and barycentrics 0.  The stream's frame repeats _entity_frame's
// operations the same way (IEEE square root and division, clamp_min
// keeping a NaN): the merged t and the flag word equal
// entity_attrs_plain's on every ray and the other 11 words on every ray an
// entity wins, the only rays whose words K2 reads; elsewhere they are 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
// PyTorch compares a float32 tensor with a Python float as float32
constexpr float DET_EPS = (float)1e-12;
constexpr float INF_T = 3.0e38f;          // render/intersect.py INF_T
constexpr float NORM_MIN = (float)1e-20;  // _entity_frame's clamp_min

struct Rays {
    const float *ox, *oy, *oz, *dx, *dy, *dz;
};

struct Out {
    uint8_t* hit;
    float* t;
    long long* tri;
    float *u, *v;
};

// the fused shade's form: the tracer's hits in, K2's entity stream out
struct Stream {
    const int* pa;            // (N,) int32 packed hit word (bit 0: hit)
    const float* t;           // (N,) float32 the tracer's t
    const float* uv;          // (cap, 3, 2) float32
    const int* tex;           // (cap,) int32 texture slots
    int n_tex;                // the atlas's texture count
    float* t_out;             // (N,) merged t
    float* w[11];             // normal, tangent, bitangent xyz, u, v
    int* flag;                // (N,) texture | use << 16
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// PyTorch's clamp_min: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float a, float lo)
{
    return a < lo ? lo : a;
}

// a / max(|a|, 1e-20) of a 3-vector, as vec3's norm and division
__device__ __forceinline__ void unit(float& x, float& y, float& z)
{
    const float n = clamp_min(
        __fsqrt_rn(add(add(mul(x, x), mul(y, y)), mul(z, z))), NORM_MIN);
    x = __fdiv_rn(x, n);
    y = __fdiv_rn(y, n);
    z = __fdiv_rn(z, n);
}

// a x b, as vec3.cross
__device__ __forceinline__ void cross(float ax, float ay, float az,
                                      float bx, float by, float bz,
                                      float& x, float& y, float& z)
{
    x = sub(mul(ay, bz), mul(az, by));
    y = sub(mul(az, bx), mul(ax, bz));
    z = sub(mul(ax, by), mul(ay, bx));
}

// entity_attrs_plain's stream of ray i, whose sweep found slot `best`
// (-1: none) at best_t with barycentrics (bu, bv)
__device__ __forceinline__ void write_stream(
    const Stream& st, const float* verts, int i, bool moving, int best,
    float best_t, float bu, float bv)
{
    const float t_in = st.t[i];
    const bool hit = best >= 0;
    const bool use = hit && moving
        && ((st.pa[i] & 1) == 0 || best_t < t_in);
    const int slot = hit ? best : 0;
    const int tex = min(max(st.tex[slot], 0), st.n_tex - 1);
    st.t_out[i] = use ? best_t : t_in;
    st.flag[i] = tex | ((int)use << 16);
    float w[11] = {};
    if (use) {
        const float* p = verts + 9LL * slot;
        const float e1x = sub(p[3], p[0]), e1y = sub(p[4], p[1]),
                    e1z = sub(p[5], p[2]);
        const float e2x = sub(p[6], p[0]), e2y = sub(p[7], p[1]),
                    e2z = sub(p[8], p[2]);
        float nx, ny, nz;
        cross(e1x, e1y, e1z, e2x, e2y, e2z, nx, ny, nz);
        unit(nx, ny, nz);
        float tx = e1x, ty = e1y, tz = e1z;
        unit(tx, ty, tz);
        float bx, by, bz;
        cross(nx, ny, nz, tx, ty, tz, bx, by, bz);
        unit(bx, by, bz);
        const float* q = st.uv + 6LL * slot;
        const float b0 = sub(sub(1.0f, bu), bv);
        w[0] = nx; w[1] = ny; w[2] = nz;
        w[3] = tx; w[4] = ty; w[5] = tz;
        w[6] = bx; w[7] = by; w[8] = bz;
        w[9] = add(add(mul(q[0], b0), mul(q[2], bu)), mul(q[4], bv));
        w[10] = add(add(mul(q[1], b0), mul(q[3], bu)), mul(q[5], bv));
    }
#pragma unroll
    for (int k = 0; k < 11; ++k) st.w[k][i] = w[k];
}

// triangle_sweep_plain over rays blockIdx.x * BLOCK + threadIdx.x; with
// STREAM, entity_attrs_plain's merge and stream in place of its outputs
template <bool STREAM>
__global__ void __launch_bounds__(BLOCK) tri_sweep_kernel(
    Rays r, const float* verts, const uint8_t* active, int cap, float t_min,
    float t_max, Out out, Stream st, unsigned long long* count, int n)
{
    // the tile's active triangles in slot order: v0, e1, e2 and the slot
    __shared__ float s_tri[9][BLOCK];
    __shared__ int s_slot[BLOCK];
    __shared__ int s_warp[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    const bool live = i < n;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
    if (live) {
        ox = r.ox[i]; oy = r.oy[i]; oz = r.oz[i];
        dx = r.dx[i]; dy = r.dy[i]; dz = r.dz[i];
    }
    const bool moving = dx != 0.0f || dy != 0.0f || dz != 0.0f;
    float best_t = INF_T, best_u = 0.0f, best_v = 0.0f;
    int best = -1;
    long long swept = 0;
    for (int base = 0; base < cap; base += BLOCK) {
        const int slot = base + threadIdx.x;
        const bool on = slot < cap && active[slot] != 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, on);
        if (lane == 0) s_warp[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, staged = 0;
        for (int w = 0; w < WARPS; ++w) {
            before += w < warp ? s_warp[w] : 0;
            staged += s_warp[w];
        }
        if (on) {
            const int k = before + __popc(ballot & ((1u << lane) - 1u));
            const float* p = verts + 9LL * slot;
            const float v0x = p[0], v0y = p[1], v0z = p[2];
            s_tri[0][k] = v0x;
            s_tri[1][k] = v0y;
            s_tri[2][k] = v0z;
            s_tri[3][k] = sub(p[3], v0x);
            s_tri[4][k] = sub(p[4], v0y);
            s_tri[5][k] = sub(p[5], v0z);
            s_tri[6][k] = sub(p[6], v0x);
            s_tri[7][k] = sub(p[7], v0y);
            s_tri[8][k] = sub(p[8], v0z);
            s_slot[k] = slot;
        }
        __syncthreads();
        if (live) {
            for (int k = 0; k < staged; ++k) {
                const float v0x = s_tri[0][k], v0y = s_tri[1][k],
                            v0z = s_tri[2][k];
                const float e1x = s_tri[3][k], e1y = s_tri[4][k],
                            e1z = s_tri[5][k];
                const float e2x = s_tri[6][k], e2y = s_tri[7][k],
                            e2z = s_tri[8][k];
                // pvec = d x e2
                const float px = sub(mul(dy, e2z), mul(dz, e2y));
                const float py = sub(mul(dz, e2x), mul(dx, e2z));
                const float pz = sub(mul(dx, e2y), mul(dy, e2x));
                const float det = add(add(mul(px, e1x), mul(py, e1y)),
                                      mul(pz, e1z));
                const bool ok = fabsf(det) > DET_EPS;
                const float inv_det = ok ? __fdiv_rn(1.0f, det) : 0.0f;
                const float tx = sub(ox, v0x), ty = sub(oy, v0y),
                            tz = sub(oz, v0z);
                const float u = mul(add(add(mul(tx, px), mul(ty, py)),
                                        mul(tz, pz)), inv_det);
                // qvec = tvec x e1
                const float qx = sub(mul(ty, e1z), mul(tz, e1y));
                const float qy = sub(mul(tz, e1x), mul(tx, e1z));
                const float qz = sub(mul(tx, e1y), mul(ty, e1x));
                const float v = mul(add(add(mul(dx, qx), mul(dy, qy)),
                                        mul(dz, qz)), inv_det);
                const float t = mul(add(add(mul(e2x, qx), mul(e2y, qy)),
                                        mul(e2z, qz)), inv_det);
                const bool hit = ok && u >= 0.0f && v >= 0.0f
                    && add(u, v) <= 1.0f && t >= t_min && t <= t_max
                    && moving;
                // a strictly smaller t: the first slot wins a tie
                if (hit && t < best_t) {
                    best_t = t;
                    best_u = u;
                    best_v = v;
                    best = s_slot[k];
                }
            }
        }
        swept += staged;
        __syncthreads();
    }
    if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
        atomicAdd(count, (unsigned long long)swept);
    if (!live) return;
    if (STREAM) {
        write_stream(st, verts, i, moving, best, best_t, best_u, best_v);
        return;
    }
    const bool hit = best >= 0;
    out.hit[i] = hit;
    out.t[i] = best_t;
    out.tri[i] = hit ? best : 0;
    out.u[i] = hit ? best_u : 0.0f;
    out.v[i] = hit ? best_v : 0.0f;
}

}  // namespace

// rays: 6 device pointers of (n,) float32 (origin xyz, direction xyz);
// verts (cap, 3, 3) float32 and active (cap,) bool: the entity pool;
// t_min, t_max: the hit range; out: hit (n,) bool, t (n,) float32, tri
// (n,) int64, bary u, v (n,) float32; count: an int64 the number of active
// triangles is added to, or null.  Returns cudaGetLastError().
extern "C" int ts_sweep(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* verts,
    const uint8_t* active, int cap, float t_min, float t_max, uint8_t* hit,
    float* t, long long* tri, float* u, float* v, long long* count, int n,
    void* stream)
{
    if (cap < 0) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const Rays r{ox, oy, oz, dx, dy, dz};
    const Out out{hit, t, tri, u, v};
    tri_sweep_kernel<false><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                              (cudaStream_t)stream>>>(
        r, verts, active, cap, t_min, t_max, out, Stream{},
        (unsigned long long*)count, n);
    return (int)cudaGetLastError();
}

// The fused shade's form.  rays, pool, t_min, t_max, count: as ts_sweep;
// pa (n,) int32 and t_in (n,) float32: the tracer's hits; uv (cap, 3, 2)
// float32 and tex (cap,) int32: the pool's; n_tex: the atlas's textures
// (at least 1).  Out: t_out (n,) float32, words: 11 device pointers of
// (n,) float32, flag (n,) int32.  Returns cudaGetLastError().
extern "C" int ts_stream(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* verts,
    const uint8_t* active, int cap, float t_min, float t_max,
    const int* pa, const float* t_in, const float* uv, const int* tex,
    int n_tex, float* t_out, float* const* words, int* flag,
    long long* count, int n, void* stream)
{
    if (cap < 0 || n_tex < 1) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const Rays r{ox, oy, oz, dx, dy, dz};
    Stream st{pa, t_in, uv, tex, n_tex, t_out, {}, flag};
    for (int k = 0; k < 11; ++k) st.w[k] = words[k];
    tri_sweep_kernel<true><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                             (cudaStream_t)stream>>>(
        r, verts, active, cap, t_min, t_max, Out{}, st,
        (unsigned long long*)count, n);
    return (int)cudaGetLastError();
}
