// Fused shade for Hopper: the whole per-ray shade of one bounce.
//
// Replaces the TPU kernel wavefront_tpu/kernels/shade.py::_kernel (called
// by shade_pass()).  Per ray: unpack the tracer's hit words, build the face
// frame and uv, load 8 atlas channels, apply emission, make the murmur3
// 3-way scatter choice, pick a light prim from the dense light BVH, take the
// MIS-0.3 light/hemisphere direction, apply the sky on a miss, sweep the
// NEE pdf over every light prim, and fold throughput and radiance.  The TPU
// kernel's one-hot texel contraction, 3-term bf16 split and ancestor matrix
// product exist because a TPU kernel cannot gather; here a texel is a
// direct load and a prim's descent probability is a walk up node_parent.
//
// What bounds it on this card: each ray reads 64 bytes (16 words) and
// writes 48 (12 words), and those are the only device-memory bytes that
// scale with the ray count; the atlas (T x 16 x 16 x 12 floats) stays in
// L2 and the light tables sit in shared memory.  Beside the bytes, a ray
// that takes NEE evaluates the light BVH: the kernel is bound by the issue
// of those operations (IEEE divides, precise logf/expf, no fused
// multiply-adds), so the design does each node's work once per ray:
//   * the light-node table: every live node's importance once, each
//     sibling pair's two branch probabilities from one sum, one logf per
//     node; then each prim's log probability is the sum of its path's
//     entries, leaf first, as the plain version sums them
//     (kernels/shade.py), so the floats are those of a walk that evaluates
//     each path node where it meets it.  The table is an array of 2P
//     floats a thread in local memory (the card's per-thread, interleaved
//     slice of device memory, cached in L1 and L2): a path node is a
//     runtime index, which registers cannot take, and a table in shared
//     memory holds too few threads at large sets (PERF.md);
//   * the light tables are staged once per resident block: the grid holds
//     as many blocks as fit on the card at once and strides over the rays.
// The prim count is a template parameter, so each ray's probability array
// has a compile-time size and the prim loops unroll up to 16 prims.
//
// Dynamic entities: the closest-hit merge against the entity triangles is
// plain PyTorch in the renderer (as it is XLA in the TPU version); the
// kernel receives the merged t and an optional 12-array attribute stream;
// it reads the flag word on every ray (4 more bytes) and, on lanes whose
// flag word has bit 16 set, the other 11 words (44 more bytes), and shades
// those lanes with the triangle's frame, uv and texture instead of the
// voxel face's.  Whether the stream is present is a template parameter, so the
// entity-free kernel is the one it was.
//
// Arithmetic mirrors kernels/shade.py::shade_plain operation for operation
// (build with -fmad=false), so the two differ only where CUDA's and
// PyTorch's cos/sin/log/exp round differently.
//
// The bf16 color build (BF16, the reference kernel's color_bf16) reads and
// writes the throughput tp as __nv_bfloat16: 6 bytes in and 6 out a ray
// instead of 12 and 12, so the byte count falls to 100 a ray.  Its colors
// are computed in float32 and rounded to bf16 (to nearest even) at each
// point where the reference holds a bf16 value: the reflectivity and
// emission texels, cos_in, each product of the emission and of the
// throughput fold, and the MIS weight, taken in float32 and rounded once.
// A product of two bf16 values is exact in float32, so one rounding after
// it is the bf16 product PyTorch computes.  Alpha, metal, geometry and the
// radiance sum stay float32.  With BF16 false every rounding is the
// identity and each instantiation is the float32 kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// m3_combine, m3_finalizef
#include "light_bvh.cuh"

namespace {

constexpr float EPS_BLOCK = 1e-3f;
constexpr float EPS15 = (float)(1e-3 * 1.5);
constexpr float EPS_NEE = 1e-4f;
constexpr float T_MAX = 1000.0f;
constexpr float MISS_DISTANCE = 5000.0f;
constexpr float SKY_EMISSION = 50.0f;
constexpr float SKY_COS_CUTOFF = 0.9f;
constexpr float EMISSION_SCALE = 1000.0f;
constexpr float MIS_WEIGHT = 0.3f;
constexpr float TWO_PI = (float)(2.0 * 3.14159265358979323846);
constexpr float INV_PI = (float)(1.0 / 3.14159265358979323846);
constexpr int NCH = 8;
__constant__ int CHANNELS[NCH] = {0, 1, 2, 3, 4, 5, 6, 8};

// tpx, tpy, tpz (in and out) hold __nv_bfloat16 in the BF16 build
struct ShadeIn {
    const float *ox, *oy, *oz, *dx, *dy, *dz;
    const int *pa, *pb;
    const float *t;
    const float *tpx, *tpy, *tpz, *rax, *ray, *raz;
    const int *rid;
};

// winning entity triangle per ray: normal, tangent, bitangent, uv, and
// tf = texture | use_tri << 16
struct TriIn {
    const float *nx, *ny, *nz, *tx, *ty, *tz, *bx, *by, *bz, *u, *v;
    const int* tf;
};

struct ShadeOut {
    float *ox, *oy, *oz, *dx, *dy, *dz, *tpx, *tpy, *tpz, *rax, *ray, *raz;
};

struct Tables {
    const float* atlas;     // (T, S, S, 12)
    int size, n_tex;
    const float* nodes;     // (M, 8): min xyz, max xyz, power, 0
    const int* parent;      // (M,), -1 at the root
    const float* prims;     // (P, 32), column layout of prep_shade_tables
    const int* leaf;        // (P,) leaf node of each prim
    int m_nodes, num_prims;
    int live;               // node-table rows: 1..live-1 in sibling pairs
    float g0, g1, g2;       // grid origin
};

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// A color value as the BF16 build holds it: rounded to bf16 and widened
// back.  A conditional on the template flag, not a function call: the
// compiler folds it to the bare expression in the float32 build, which
// then compiles to the code it had before the bf16 build (a call in a
// conditional operator changed the order of its selects).
#define COLOR(x) (BF16 ? bf16_round(x) : (x))

template <bool BF16>
__device__ __forceinline__ float load_tp(const float* p, int i) {
    if constexpr (BF16)
        return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
    else return p[i];
}

template <bool BF16>
__device__ __forceinline__ void store_tp(float* p, int i, float x) {
    if constexpr (BF16)
        reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
    else p[i] = x;
}

// nodeImportance (reference raytrace.rs:193-220); b = min xyz, max xyz
__device__ __forceinline__ float aabb_importance(
    const float* b, float power, float px, float py, float pz,
    float nx, float ny, float nz, bool guard)
{
    const float d0x = (b[0] - px) * nx, d1x = (b[3] - px) * nx;
    const float d0y = (b[1] - py) * ny, d1y = (b[4] - py) * ny;
    const float d0z = (b[2] - pz) * nz, d1z = (b[5] - pz) * nz;
    float visible = 0.0f;
#pragma unroll
    for (int ix = 0; ix < 2; ++ix) {
#pragma unroll
        for (int iy = 0; iy < 2; ++iy) {
            const float sxy = (ix ? d1x : d0x) + (iy ? d1y : d0y);
            visible += (sxy + d0z >= EPS_BLOCK) ? 1.0f : 0.0f;
            visible += (sxy + d1z >= EPS_BLOCK) ? 1.0f : 0.0f;
        }
    }
    const float ex = b[3] - b[0], ey = b[4] - b[1], ez = b[5] - b[2];
    const float diag_sq = (ex * ex + ey * ey) + ez * ez;
    const float cx = 0.5f * (b[0] + b[3]) - px;
    const float cy = 0.5f * (b[1] + b[4]) - py;
    const float cz = 0.5f * (b[2] + b[5]) - pz;
    float dist_sq = fmaxf(diag_sq, (cx * cx + cy * cy) + cz * cz);
    if (guard) dist_sq = fmaxf(dist_sq, 1e-30f);
    return power / dist_sq * (visible * 0.125f);
}

// The light tables of one block in shared memory.
struct LightSmem {
    const float* nodes;
    const float* prims;
    const int* parent;
    const int* leaf;
};

template <int P, bool TRI, bool BF16>
__device__ __forceinline__ void shade_ray(
    int i, const ShadeIn& in, const TriIn& tri, const ShadeOut& out,
    const Tables& tb, const LightSmem& ls, uint32_t inv_seed, int bounce,
    int nee_type)
{
    const bool nee = nee_type != 0;
    const int m = tb.m_nodes;
    const float* s_nodes = ls.nodes;
    const float* s_prims = ls.prims;
    const int* s_parent = ls.parent;
    const int* s_leaf = ls.leaf;

    const float ox = in.ox[i], oy = in.oy[i], oz = in.oz[i];
    const float dx = in.dx[i], dy = in.dy[i], dz = in.dz[i];
    const float tpx = load_tp<BF16>(in.tpx, i), tpy = load_tp<BF16>(in.tpy, i),
                tpz = load_tp<BF16>(in.tpz, i);
    const float rax = in.rax[i], ray_ = in.ray[i], raz = in.raz[i];
    const bool alive = dx != 0.0f || dy != 0.0f || dz != 0.0f;
    if (!alive) {
        // terminal passthrough (raytrace.rs:484-494): no emission, the
        // direction stays zero, and the throughput factor is 0
        out.ox[i] = ox; out.oy[i] = oy; out.oz[i] = oz;
        out.dx[i] = 0.0f; out.dy[i] = 0.0f; out.dz[i] = 0.0f;
        store_tp<BF16>(out.tpx, i, tpx * 0.0f);
        store_tp<BF16>(out.tpy, i, tpy * 0.0f);
        store_tp<BF16>(out.tpz, i, tpz * 0.0f);
        out.rax[i] = rax + tpx * 0.0f; out.ray[i] = ray_ + tpy * 0.0f;
        out.raz[i] = raz + tpz * 0.0f;
        return;
    }

    // ---- hit record (intersect.py pack_hits layout) ----
    const int pa = in.pa[i], pb = in.pb[i];
    const float t_hit = in.t[i];
    bool hit = (pa & 1) != 0;
    const int face = (pa >> 2) & 7;
    const int owner = (pa >> 14) & 255;
    const int vx = (pb & 1023) - 2;
    const int vy = ((pa >> 5) & 511) - 2;
    const int vz = (pb >> 10) - 2;
    const float hpx = ox + dx * t_hit, hpy = oy + dy * t_hit,
                hpz = oz + dz * t_hit;

    // ---- face frame and uv (renderer._shade) ----
    const int axis = face >> 1;
    const float signf = (float)((face & 1) * 2 - 1);
    float n_x = axis == 0 ? signf : 0.0f;
    float n_y = axis == 1 ? signf : 0.0f;
    float n_z = axis == 2 ? signf : 0.0f;
    float tg_x = axis == 2 ? 1.0f : 0.0f;
    float tg_y = axis == 0 ? 1.0f : 0.0f;
    float tg_z = axis == 1 ? 1.0f : 0.0f;
    float bt_x = n_y * tg_z - n_z * tg_y;
    float bt_y = n_z * tg_x - n_x * tg_z;
    float bt_z = n_x * tg_y - n_y * tg_x;
    const float lx = hpx - ((float)vx + tb.g0);
    const float ly = hpy - ((float)vy + tb.g1);
    const float lz = hpz - ((float)vz + tb.g2);
    float u = face == 0 ? 1.0f - lz : face == 1 ? lz : face == 2 ? lx
            : face == 3 ? 1.0f - lx : face == 4 ? lx : 1.0f - lx;
    float v = (face == 2 || face == 3) ? lz : 1.0f - ly;
    int tex = owner * 6 + face;
    if (TRI) {
        // entity hit wins (merge done by the renderer): its frame, uv and
        // texture replace the voxel face's
        const int tf = tri.tf[i];
        if ((tf >> 16) & 1) {
            hit = true;
            n_x = tri.nx[i]; n_y = tri.ny[i]; n_z = tri.nz[i];
            tg_x = tri.tx[i]; tg_y = tri.ty[i]; tg_z = tri.tz[i];
            bt_x = tri.bx[i]; bt_y = tri.by[i]; bt_z = tri.bz[i];
            u = tri.u[i]; v = tri.v[i];
            tex = tf & 0xFFFF;
        }
    }

    // ---- texels: refl rgb, alpha, emis rgb, metal (CHANNELS) ----
    float ch[NCH];
    if (hit) {
        const int size = tb.size;
        tex = min(max(tex, 0), tb.n_tex - 1);
        const int ti = min(max((int)(u * (float)size), 0), size - 1);
        const int tj = min(max((int)(v * (float)size), 0), size - 1);
        const float* texel = tb.atlas + ((size_t)(tex * size + tj) * size + ti) * 12;
#pragma unroll
        for (int c = 0; c < NCH; ++c) ch[c] = __ldg(texel + CHANNELS[c]);
    } else {
#pragma unroll
        for (int c = 0; c < NCH; ++c) ch[c] = 0.0f;
    }
    // colors: reflectivity (ch 0-2) and emission in the color type
#pragma unroll
    for (int c = 0; c < 3; ++c) ch[c] = COLOR(ch[c]);
    const float cos_in = COLOR(-((dx * n_x + dy * n_y) + dz * n_z));
    const float emx =
        COLOR(COLOR(EMISSION_SCALE * COLOR(ch[4])) * cos_in);
    const float emy =
        COLOR(COLOR(EMISSION_SCALE * COLOR(ch[5])) * cos_in);
    const float emz =
        COLOR(COLOR(EMISSION_SCALE * COLOR(ch[6])) * cos_in);
    const float alpha = ch[3], metal = ch[7];

    // ---- scatter decision (raytrace.rs:588-603) ----
    const uint32_t seed = m3_combine(inv_seed, (uint32_t)in.rid[i]);
    const float scatter_rand = m3_finalizef(m3_combine(seed, 0u));
    const bool is_mirror = scatter_rand < metal;
    const bool is_trans = !is_mirror && scatter_rand < metal + (1.0f - alpha);
    const bool is_lamb = hit && !is_mirror && !is_trans;
    const float lox = hpx + EPS15 * n_x, loy = hpy + EPS15 * n_y,
                loz = hpz + EPS15 * n_z;
    const bool do_nee = nee_type == 1 ? is_lamb
                      : nee_type == 2 ? (is_lamb && bounce == 0) : false;

    // ---- dense light pick (wavefront.dense_sample_light); the loops over
    // the prims unroll up to 16 prims ----
    float probs[P];
    bool ok = false;
    float imp = 0.0f;
    const float* prow = nullptr;
    if (do_nee) {
        // the light-node table, once per ray: each live node's branch
        // probability imp(j) / (imp(j) + imp(sibling)) and its log,
        // siblings (j, j+1) for odd j computed together (imp(j) + imp(s) =
        // imp(s) + imp(j)); a padded tail row (j + 1 = M) has probability 0
        float row[2 * P];
        for (int j = 1; j < tb.live; j += 2) {
            if (j + 1 >= m) {
                row[j] = logf(fmaxf(0.0f, 1e-35f));
                break;
            }
            const float ij = aabb_importance(
                s_nodes + 8 * j, s_nodes[8 * j + 6], lox, loy, loz,
                n_x, n_y, n_z, false);
            const float ik = aabb_importance(
                s_nodes + 8 * (j + 1), s_nodes[8 * (j + 1) + 6], lox, loy,
                loz, n_x, n_y, n_z, false);
            const float tot = ij + ik;
            row[j] = logf(fmaxf(
                tot > 0.0f ? ij / fmaxf(tot, 1e-30f) : 0.0f, 1e-35f));
            row[j + 1] = logf(fmaxf(
                tot > 0.0f ? ik / fmaxf(tot, 1e-30f) : 0.0f, 1e-35f));
        }
        float total = 0.0f;
#pragma unroll (P <= 16 ? P : 1)
        for (int q = 0; q < P; ++q) {
            float p = 0.0f;
            if (q < tb.num_prims) {
                // descent probability: the logs of the non-root ancestors
                // of the prim's leaf, summed leaf first
                float logp = 0.0f;
                for (int a = s_leaf[q]; a > 0; a = s_parent[a])
                    logp += row[a];
                p = expf(logp);
            }
            probs[q] = p;
            total += p;
        }
        const float uu = m3_finalizef(m3_combine(seed, 2u)) * total;
        float cum = 0.0f;
        int cnt = 0;
#pragma unroll (P <= 16 ? P : 1)
        for (int q = 0; q < P; ++q) {
            cum += probs[q];
            cnt += cum < uu ? 1 : 0;
        }
        const int idx = min(cnt, P - 1);
        float prob = 0.0f;
#pragma unroll (P <= 16 ? P : 1)
        for (int q = 0; q < P; ++q) prob = q == idx ? probs[q] : prob;
        prow = s_prims + 32 * idx;
        imp = aabb_importance(prow + 12, prow[11], lox, loy, loz,
                              n_x, n_y, n_z, true);
        ok = total > 0.0f && prob > 0.0f;
    }
    const float mis = (ok && imp > 0.0f) ? MIS_WEIGHT : 0.0f;
    const bool pick_light = m3_finalizef(m3_combine(seed, 3u)) < mis;
    const float u4 = m3_finalizef(m3_combine(seed, 4u));
    const float u5 = m3_finalizef(m3_combine(seed, 5u));

    // direction to the light point, with the triangle fold (raytrace.rs:317-323)
    float ldx = 0.0f, ldy = 0.0f, ldz = 0.0f;
    if (pick_light) {
        const bool fold = prow[9] > 0.5f && u4 + u5 > 1.0f;
        const float lu = fold ? 1.0f - u4 : u4;
        const float lv = fold ? 1.0f - u5 : u5;
        const float tlx = ((prow[0] + lu * prow[3]) + lv * prow[6]) - lox;
        const float tly = ((prow[1] + lu * prow[4]) + lv * prow[7]) - loy;
        const float tlz = ((prow[2] + lu * prow[5]) + lv * prow[8]) - loz;
        const float tl_n = fmaxf(sqrtf((tlx * tlx + tly * tly) + tlz * tlz),
                                 1e-20f);
        ldx = tlx / tl_n; ldy = tly / tl_n; ldz = tlz / tl_n;
    }
    // cosine hemisphere sample (raytrace.rs:308-313,354-357)
    const float theta = TWO_PI * u4;
    const float r_ = sqrtf(fmaxf(0.0f, 1.0f - u5));
    const float hx = r_ * cosf(theta), hy = sqrtf(u5), hz = r_ * sinf(theta);
    float hdx = (hx * tg_x + hy * n_x) + hz * bt_x;
    float hdy = (hx * tg_y + hy * n_y) + hz * bt_y;
    float hdz = (hx * tg_z + hy * n_z) + hz * bt_z;
    const float hn = sqrtf((hdx * hdx + hdy * hdy) + hdz * hdz);
    hdx = hdx / hn; hdy = hdy / hn; hdz = hdz / hn;
    const float lamdx = pick_light ? ldx : hdx;
    const float lamdy = pick_light ? ldy : hdy;
    const float lamdz = pick_light ? ldz : hdz;
    const float lam_cos = (lamdx * n_x + lamdy * n_y) + lamdz * n_z;
    const float lam_bsdf = lam_cos * INV_PI;

    // ---- merge branches ----
    float nox = is_lamb ? lox : hpx, noy = is_lamb ? loy : hpy,
          noz = is_lamb ? loz : hpz;
    const float k2 = 2.0f * ((dx * n_x + dy * n_y) + dz * n_z);
    float ndx = is_mirror ? dx - k2 * n_x : (is_trans ? dx : lamdx);
    float ndy = is_mirror ? dy - k2 * n_y : (is_trans ? dy : lamdy);
    float ndz = is_mirror ? dz - k2 * n_z : (is_trans ? dz : lamdz);
    float orx = is_mirror ? ch[0] : (is_trans ? 1.0f : COLOR(ch[0] * INV_PI));
    float ory = is_mirror ? ch[1] : (is_trans ? 1.0f : COLOR(ch[1] * INV_PI));
    float orz = is_mirror ? ch[2] : (is_trans ? 1.0f : COLOR(ch[2] * INV_PI));
    float bsdf = is_lamb ? lam_bsdf : 1.0f;
    float mis_o = is_lamb ? mis : 0.0f;
    float ex = emx, ey = emy, ez = emz;
    float nmx = n_x, nmy = n_y, nmz = n_z;

    // ---- miss: directional sky (raytrace.rs:528-538) ----
    if (!hit) {
        const float sky = dy > SKY_COS_CUTOFF ? SKY_EMISSION : 0.0f;
        nox = ox + dx * MISS_DISTANCE;
        noy = oy + dy * MISS_DISTANCE;
        noz = oz + dz * MISS_DISTANCE;
        ndx = 0.0f; ndy = 0.0f; ndz = 0.0f;
        nmx = 0.0f; nmy = 0.0f; nmz = 0.0f;
        ex = sky; ey = sky; ez = sky;
        orx = 0.0f; ory = 0.0f; orz = 0.0f;
        mis_o = 0.0f;
        bsdf = 1.0f;
    }

    // ---- dense NEE pdf sweep (nee_pdf.rs:302-334): every prim crossing
    // of the outgoing ray adds walk_prob * t^2 / (cos_theta * area) ----
    float pdf = 0.0f;
    if (nee && mis_o > 0.0f && (ndx != 0.0f || ndy != 0.0f || ndz != 0.0f)) {
        const float cos_r = (nmx * ndx + nmy * ndy) + nmz * ndz;
#pragma unroll (P <= 16 ? P : 1)
        for (int q = 0; q < P; ++q) {
            if (q >= tb.num_prims) continue;
            const float* c = s_prims + 32 * q;
            const float nvd = (c[18] * ndx + c[19] * ndy) + c[20] * ndz;
            const float nvo = (c[18] * nox + c[19] * noy) + c[20] * noz;
            const bool safe = fabsf(nvd) > 1e-12f;
            const float tt = (c[25] - nvo) / (safe ? nvd : 1.0f);
            const float r1 = (((c[3] * nox + c[4] * noy) + c[5] * noz)
                + tt * ((c[3] * ndx + c[4] * ndy) + c[5] * ndz)) - c[26];
            const float r2 = (((c[6] * nox + c[7] * noy) + c[8] * noz)
                + tt * ((c[6] * ndx + c[7] * ndy) + c[8] * ndz)) - c[27];
            const float uq = (r1 * c[22] - r2 * c[23]) * c[24];
            const float vq = (r2 * c[21] - r1 * c[23]) * c[24];
            const bool in_quad = uq >= 0.0f && uq <= 1.0f && vq >= 0.0f &&
                                 vq <= 1.0f;
            const bool in_tri = uq >= 0.0f && vq >= 0.0f && uq + vq <= 1.0f;
            const bool inside = c[9] > 0.5f ? in_tri : in_quad;
            if (safe && inside && tt >= EPS_NEE && tt <= T_MAX)
                pdf += probs[q] * tt * tt / (cos_r * c[10]);
        }
    }

    // ---- forward-folded throughput update (outgoing_radiance.rs:77-87) ----
    const float valid = (ndx != 0.0f || ndy != 0.0f || ndz != 0.0f) ? 1.0f : 0.0f;
    const float qq = pdf * mis_o + (1.0f - mis_o) * bsdf;
    const float w = qq > 0.0f ? bsdf / fmaxf(qq, 1e-35f) : 0.0f;
    const float wv = COLOR(w * valid);
    out.ox[i] = nox; out.oy[i] = noy; out.oz[i] = noz;
    out.dx[i] = ndx; out.dy[i] = ndy; out.dz[i] = ndz;
    out.rax[i] = rax + COLOR(tpx * ex);
    out.ray[i] = ray_ + COLOR(tpy * ey);
    out.raz[i] = raz + COLOR(tpz * ez);
    store_tp<BF16>(out.tpx, i, tpx * COLOR(orx * wv));
    store_tp<BF16>(out.tpy, i, tpy * COLOR(ory * wv));
    store_tp<BF16>(out.tpz, i, tpz * COLOR(orz * wv));
}

constexpr int BLOCK = 128;

template <int P, bool TRI, bool BF16>
__global__ void __launch_bounds__(BLOCK) shade_kernel(
    ShadeIn in, TriIn tri, ShadeOut out, Tables tb, int n, uint32_t inv_seed,
    int bounce, int nee_type)
{
    extern __shared__ float smem[];
    const int m = tb.m_nodes;
    float* s_nodes = smem;                         // M * 8
    float* s_prims = s_nodes + 8 * m;              // P * 32
    int* s_parent = (int*)(s_prims + 32 * P);      // M
    int* s_leaf = s_parent + m;                    // P
    LightSmem ls{s_nodes, s_prims, s_parent, s_leaf};
    if (nee_type != 0) {
        // staged once per resident block: the grid strides over the rays
        for (int k = threadIdx.x; k < 8 * m; k += blockDim.x)
            s_nodes[k] = tb.nodes[k];
        for (int k = threadIdx.x; k < 32 * P; k += blockDim.x)
            s_prims[k] = tb.prims[k];
        for (int k = threadIdx.x; k < m; k += blockDim.x)
            s_parent[k] = tb.parent[k];
        for (int k = threadIdx.x; k < P; k += blockDim.x)
            s_leaf[k] = tb.leaf[k];
        __syncthreads();
    }
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        shade_ray<P, TRI, BF16>(i, in, tri, out, tb, ls, inv_seed, bounce,
                                nee_type);
}

template <int P, bool TRI, bool BF16>
int launch(const ShadeIn& in, const TriIn& tri, const ShadeOut& out,
           const Tables& tb, int n, uint32_t inv_seed, int bounce,
           int nee_type, cudaStream_t stream)
{
    const size_t smem = nee_type != 0
        ? (size_t)(8 * tb.m_nodes + 32 * P) * sizeof(float)
          + (size_t)(tb.m_nodes + P) * sizeof(int)
        : 0;
    cudaError_t e;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            shade_kernel<P, TRI, BF16>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // as many blocks as are resident at once, each looping over rays; the
    // count is read for the device that launches (the caller makes it
    // current: _build.Launcher) and kept per device with its shared-memory
    // size
    constexpr int MAX_DEVICES = 64;
    static int resident[MAX_DEVICES] = {};
    static size_t resident_smem[MAX_DEVICES] = {};
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (resident[dev] == 0 || resident_smem[dev] != smem) {
        int sms = 0, per_sm = 0;
        if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess)
            return (int)e;
        if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, shade_kernel<P, TRI, BF16>, BLOCK, smem))
            != cudaSuccess)
            return (int)e;
        resident[dev] = max(sms * per_sm, 1);
        resident_smem[dev] = smem;
    }
    const int blocks = min((n + BLOCK - 1) / BLOCK, resident[dev]);
    shade_kernel<P, TRI, BF16><<<blocks, BLOCK, smem, stream>>>(
        in, tri, out, tb, n, inv_seed, bounce, nee_type);
    return (int)cudaGetLastError();
}

template <int P, bool BF16>
int launch_t(const ShadeIn& in, const TriIn* tri, const ShadeOut& out,
             const Tables& tb, int n, uint32_t inv_seed, int bounce,
             int nee_type, cudaStream_t stream)
{
    if (tri)
        return launch<P, true, BF16>(in, *tri, out, tb, n, inv_seed, bounce,
                                     nee_type, stream);
    return launch<P, false, BF16>(in, TriIn{}, out, tb, n, inv_seed, bounce,
                                  nee_type, stream);
}

template <int P>
int launch_p(const ShadeIn& in, const TriIn* tri, const ShadeOut& out,
             const Tables& tb, int n, uint32_t inv_seed, int bounce,
             int nee_type, bool bf16, cudaStream_t stream)
{
    if (bf16)
        return launch_t<P, true>(in, tri, out, tb, n, inv_seed, bounce,
                                 nee_type, stream);
    return launch_t<P, false>(in, tri, out, tb, n, inv_seed, bounce,
                              nee_type, stream);
}

}  // namespace

// ins: 16 device pointers (ox oy oz dx dy dz pa pb t tpx tpy tpz rax ray raz
// rid); outs: 12 (ox oy oz dx dy dz tpx tpy tpz rax ray raz); tris: null, or
// 12 (normal xyz, tangent xyz, bitangent xyz, u, v, tf).  p_prims must be
// one of 8..256 (powers of two); live_nodes (at most 2 p_prims) bounds the
// nodes on the prims' paths and their siblings (prep_shade_tables).
// color_bf16: tpx tpy tpz in and out are __nv_bfloat16 (the BF16 build).
// Returns cudaGetLastError().
extern "C" int shade_launch(
    void* const* ins, void* const* outs, void* const* tris, int n,
    const float* atlas, int size, int n_tex,
    const float* nodes, const int* parent, int m_nodes,
    const float* prims, const int* leaf, int p_prims, int num_prims,
    int live_nodes, float g0, float g1, float g2, unsigned int inv_seed,
    int bounce,
    int nee_type, int color_bf16, void* stream)
{
    if (n <= 0) return 0;
    ShadeIn in{(const float*)ins[0], (const float*)ins[1], (const float*)ins[2],
               (const float*)ins[3], (const float*)ins[4], (const float*)ins[5],
               (const int*)ins[6], (const int*)ins[7], (const float*)ins[8],
               (const float*)ins[9], (const float*)ins[10], (const float*)ins[11],
               (const float*)ins[12], (const float*)ins[13], (const float*)ins[14],
               (const int*)ins[15]};
    ShadeOut out{(float*)outs[0], (float*)outs[1], (float*)outs[2],
                 (float*)outs[3], (float*)outs[4], (float*)outs[5],
                 (float*)outs[6], (float*)outs[7], (float*)outs[8],
                 (float*)outs[9], (float*)outs[10], (float*)outs[11]};
    Tables tb{atlas, size, n_tex, nodes, parent, prims, leaf, m_nodes,
              num_prims, live_nodes, g0, g1, g2};
    TriIn tri_in{};
    if (tris)
        tri_in = TriIn{
            (const float*)tris[0], (const float*)tris[1], (const float*)tris[2],
            (const float*)tris[3], (const float*)tris[4], (const float*)tris[5],
            (const float*)tris[6], (const float*)tris[7], (const float*)tris[8],
            (const float*)tris[9], (const float*)tris[10], (const int*)tris[11]};
    const TriIn* tri = tris ? &tri_in : nullptr;
    cudaStream_t s = (cudaStream_t)stream;
    const bool bf16 = color_bf16 != 0;
    switch (p_prims) {
        case 8: return launch_p<8>(in, tri, out, tb, n, inv_seed, bounce, nee_type, bf16, s);
        case 16: return launch_p<16>(in, tri, out, tb, n, inv_seed, bounce, nee_type, bf16, s);
        case 32: return launch_p<32>(in, tri, out, tb, n, inv_seed, bounce, nee_type, bf16, s);
        case 64: return launch_p<64>(in, tri, out, tb, n, inv_seed, bounce, nee_type, bf16, s);
        case 128: return launch_p<128>(in, tri, out, tb, n, inv_seed, bounce, nee_type, bf16, s);
        case 256: return launch_p<256>(in, tri, out, tb, n, inv_seed, bounce, nee_type, bf16, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
