// Native chunk worldgen: seeded 3-D gradient noise + terrain rule.
//
// The reference generates chunks on a 15-thread Rust pool with OpenSimplex
// noise (reference chunk.rs:55-110, chunk_manager.rs:202-253) — worldgen is
// the host-side hot path of the streaming system.  This C++ implementation
// mirrors wavefront_tpu_torch/world/worldgen.py exactly (same permutation
// table construction, same gradients, same quintic fade) so the native and
// NumPy paths produce identical chunks.  It is the port's copy of the JAX
// package's native/worldgen.cpp.
//
// Built by wavefront_tpu_torch/kernels/_build.py (`load_host`) with the host
// C++ compiler at first use (-O3 -std=c++17 -ffp-contract=off, no
// -march=native), loaded via ctypes.

#include <cstdint>
#include <cmath>
#include <cstring>

namespace {

const double GRADS[12][3] = {
    {1, 1, 0},  {-1, 1, 0},  {1, -1, 0},  {-1, -1, 0},
    {1, 0, 1},  {-1, 0, 1},  {1, 0, -1},  {-1, 0, -1},
    {0, 1, 1},  {0, -1, 1},  {0, 1, -1},  {0, -1, -1},
};

struct Noise {
    int32_t perm[512];
};

// numpy MT19937 permutation of arange(256), matching
// np.random.RandomState(seed).permutation(256) — reimplemented here:
// RandomState.permutation uses Fisher-Yates driven by randint via
// random_interval (Lemire-free masked rejection).  To avoid relying on
// numpy internals, the Python side passes the permutation in explicitly.
void noise_init(Noise* n, const int32_t* perm256) {
    for (int i = 0; i < 256; i++) {
        n->perm[i] = perm256[i];
        n->perm[i + 256] = perm256[i];
    }
}

inline int grad_index(const Noise* n, int xi, int yi, int zi) {
    const int32_t* p = n->perm;
    return p[p[p[xi & 255] + (yi & 255)] + (zi & 255)] % 12;
}

inline double fade(double t) { return t * t * t * (t * (t * 6.0 - 15.0) + 10.0); }
inline double lerp(double a, double b, double t) { return a + t * (b - a); }

double noise_sample(const Noise* n, double x, double y, double z) {
    double fx = std::floor(x), fy = std::floor(y), fz = std::floor(z);
    int xi = (int)fx, yi = (int)fy, zi = (int)fz;
    double xf = x - fx, yf = y - fy, zf = z - fz;
    double u = fade(xf), v = fade(yf), w = fade(zf);

    double c[2][2][2];
    for (int dx = 0; dx < 2; dx++)
        for (int dy = 0; dy < 2; dy++)
            for (int dz = 0; dz < 2; dz++) {
                const double* g = GRADS[grad_index(n, xi + dx, yi + dy, zi + dz)];
                c[dx][dy][dz] = g[0] * (xf - dx) + g[1] * (yf - dy) + g[2] * (zf - dz);
            }

    double x00 = lerp(c[0][0][0], c[1][0][0], u);
    double x10 = lerp(c[0][1][0], c[1][1][0], u);
    double x01 = lerp(c[0][0][1], c[1][0][1], u);
    double x11 = lerp(c[0][1][1], c[1][1][1], u);
    double y0 = lerp(x00, x10, v);
    double y1 = lerp(x01, x11, v);
    return lerp(y0, y1, w);
}

}  // namespace

extern "C" {

// Generate one chunk of block ids, indexed [x][y][z] C-contiguous.
// Terrain rule mirrors the reference (chunk.rs:79-104): density = noise - y
// depth gradient thresholded; stone below grass; optional central lamp cube.
void generate_chunk(
    const int32_t* perm256,
    int32_t chunk_size,
    int64_t cx, int64_t cy, int64_t cz,        // chunk coords
    double noise_scale, double threshold, double depth_gradient,
    uint8_t air_id, uint8_t grass_id, uint8_t stone_id, uint8_t lamp_id,
    int32_t central_lamp,
    uint8_t* out) {
    Noise n;
    noise_init(&n, perm256);
    const int cs = chunk_size;
    const double ox = (double)(cx * cs), oy = (double)(cy * cs), oz = (double)(cz * cs);

    for (int x = 0; x < cs; x++) {
        double wx = ox + x;
        for (int y = 0; y < cs; y++) {
            double wy = oy + y;
            double here_y = wy, above_y = wy + 1.0;
            for (int z = 0; z < cs; z++) {
                double wz = oz + z;
                double val_here =
                    noise_sample(&n, wx / noise_scale, here_y / noise_scale, wz / noise_scale)
                    - here_y / depth_gradient;
                double val_above =
                    noise_sample(&n, wx / noise_scale, above_y / noise_scale, wz / noise_scale)
                    - above_y / depth_gradient;

                uint8_t b = air_id;
                if (val_here > threshold)
                    b = (val_above > threshold) ? stone_id : grass_id;
                if (central_lamp && wx > -3.0 && wx < 3.0 && wy > -3.0 && wy < 3.0 &&
                    wz > -3.0 && wz < 3.0)
                    b = lamp_id;
                out[(int64_t)x * cs * cs + (int64_t)y * cs + z] = b;
            }
        }
    }
}

// Raw noise sampler (for tests / tooling).
void sample_noise(
    const int32_t* perm256,
    const double* xs, const double* ys, const double* zs,
    int64_t count, double* out) {
    Noise n;
    noise_init(&n, perm256);
    for (int64_t i = 0; i < count; i++)
        out[i] = noise_sample(&n, xs[i], ys[i], zs[i]);
}

}  // extern "C"
