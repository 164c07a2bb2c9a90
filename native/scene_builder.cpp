// Native scene-builder kernels for sph_jax.
//
// The reference's scene generator is native C++ (owHelper.cpp:104-1429);
// this library is its counterpart here: the O(N)-heavy emission loops
// (boundary box, swimming pool, inner worm liquid) and the O(Ne * local)
// spring-graph search, exposed through a C ABI consumed via ctypes
// (sph_jax/scene/native.py). Float semantics deliberately mirror the
// reference's single-precision accumulation loops (build with
// -ffp-contract=off so results match the NumPy float32 fallback bitwise).
//
// Muscle-window assignment stays in Python (vectorized over the spring list)
// so the atlas tables exist in exactly one place.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Swimming pool (owHelper.cpp:673-691): lattice below y_max * fill.
// Returns the number of particles written (x,y,z triples into out,
// capacity cap particles); pass out = nullptr to count only.
// ---------------------------------------------------------------------
int64_t sph_pool_liquid(float r0, float x_max, float y_max, float z_max,
                        float fill, float* out, int64_t cap) {
    int64_t n = 0;
    const double x_hi = (double)x_max - 3.0 * (double)r0;
    const double y_hi = (double)y_max * (double)fill;
    const double z_hi = (double)z_max - 3.0 * (double)r0;
    for (float x = 3.0f * r0; x < x_hi; x += r0) {
        for (float y = 3.0f * r0; y < y_hi; y += r0) {
            for (float z = 3.0f * r0; z < z_hi; z += r0) {
                if (out && n < cap) {
                    out[3 * n + 0] = x;
                    out[3 * n + 1] = y;
                    out[3 * n + 2] = z;
                }
                ++n;
            }
        }
    }
    return n;
}

// ---------------------------------------------------------------------
// Boundary box walls with outward normals (owHelper.cpp:775-928).
// pos/nrm each hold cap particles (x,y,z triples); returns count.
// ---------------------------------------------------------------------
int64_t sph_boundary_box(float r0, float x_max, float y_max, float z_max,
                         float* pos, float* nrm, int64_t cap) {
    const int64_t nx = (int64_t)((double)x_max / (double)r0);
    const int64_t ny = (int64_t)((double)y_max / (double)r0);
    const int64_t nz = (int64_t)((double)z_max / (double)r0);
    const float s2 = 1.0f / std::sqrt(2.0f);
    const float s3 = 1.0f / std::sqrt(3.0f);
    int64_t n = 0;

    auto emit = [&](int64_t ix, int64_t iy, int64_t iz,
                    float a, float b, float c) {
        if (pos && n < cap) {
            // match the Python fallback: double arithmetic, one rounding
            pos[3 * n + 0] = (float)((double)ix * r0 + (double)r0 / 2.0);
            pos[3 * n + 1] = (float)((double)iy * r0 + (double)r0 / 2.0);
            pos[3 * n + 2] = (float)((double)iz * r0 + (double)r0 / 2.0);
            nrm[3 * n + 0] = a;
            nrm[3 * n + 1] = b;
            nrm[3 * n + 2] = c;
        }
        ++n;
    };

    for (int64_t ix = 0; ix < nx; ++ix) {
        for (int64_t iy = 0; iy < ny; ++iy) {
            const bool xe = (ix == 0) || (ix == nx - 1);
            const bool ye = (iy == 0) || (iy == ny - 1);
            const float sx = (float)((ix == 0) - (ix == nx - 1));
            const float sy = (float)((iy == 0) - (iy == ny - 1));
            if (xe && ye) {
                emit(ix, iy, 0, sx * s3, sy * s3, s3);
                emit(ix, iy, nz - 1, sx * s3, sy * s3, -s3);
            } else if (xe || ye) {
                emit(ix, iy, 0, sx * s2, sy * s2, s2);
                emit(ix, iy, nz - 1, sx * s2, sy * s2, -s2);
            } else {
                emit(ix, iy, 0, 0.f, 0.f, 1.f);
                emit(ix, iy, nz - 1, 0.f, 0.f, -1.f);
            }
        }
    }
    for (int64_t ix = 0; ix < nx; ++ix) {
        for (int64_t iz = 1; iz < nz - 1; ++iz) {
            if (ix == 0 || ix == nx - 1) {
                emit(ix, 0, iz, 0.f, s2, 0.f);
                emit(ix, ny - 1, iz, 0.f, -s2, 0.f);
            } else {
                emit(ix, 0, iz, 0.f, 1.f, 0.f);
                emit(ix, ny - 1, iz, 0.f, -1.f, 0.f);
            }
        }
    }
    for (int64_t iy = 1; iy < ny - 1; ++iy) {
        for (int64_t iz = 1; iz < nz - 1; ++iz) {
            emit(0, iy, iz, 1.f, 0.f, 0.f);
            emit(nx - 1, iy, iz, -1.f, 0.f, 0.f);
        }
    }
    return n;
}

// ---------------------------------------------------------------------
// Inner worm liquid rings (owHelper.cpp:547-670). Returns count.
// ---------------------------------------------------------------------
int64_t sph_inner_worm_liquid(float r0, float x_max, float y_max,
                              float z_max, float* out, int64_t cap) {
    const float xc = x_max * 0.5f;
    const float yc = y_max * 0.3f;
    const float zc = z_max * 0.5f;
    const float pi_f = 3.1415926536f;
    int64_t n = 0;

    auto emit = [&](float x, float y, float z) {
        if (out && n < cap) {
            out[3 * n + 0] = x;
            out[3 * n + 1] = y;
            out[3 * n + 2] = z;
        }
        ++n;
    };

    for (float j = -100.0f; j <= 100.0f; j += 0.85f) {
        float radius = (float)(6.0f * r0
            * std::sqrt(std::max(1.0f - 1.0e-4f * j * j, 0.0f))
            - (double)r0 * (1.0 + 0.85));
        const float zj = zc + r0 * j;
        while (true) {
            if (!(radius > 0.707 * (double)r0)) break;
            emit(xc, yc + radius, zj);
            emit(xc, yc - radius, zj);
            const float alpha =
                (float)(2.0 * std::asin(0.5 * (double)r0 / (double)radius));
            float angle = 0.0f;
            const float nma = pi_f - 2.0f * angle;
            const int n_nm =
                (int)std::floor(nma / (alpha * 0.85f)) - 1;
            const float beta = nma / (float)(n_nm + 1);
            for (int i = 0; i < n_nm; ++i) {
                angle += beta;
                const double sa = (double)radius * std::sin((double)angle);
                const double ca = (double)radius * std::cos((double)angle);
                emit((float)(xc + sa), (float)(yc + ca), zj);
                emit((float)(xc - sa), (float)(yc + ca), zj);
            }
            radius = (float)((double)radius - (double)r0 * 0.85);
        }
    }
    return n;
}

// ---------------------------------------------------------------------
// Spring graph (owHelper.cpp:973-1001): for each of the first n_elastic
// particles, connect to elastic/boundary particles within r0*sqrt(2.7),
// ascending candidate id, capped at max_n per particle. Liquid block
// [n_elastic, n_elastic + n_liquid) is skipped. Cell-binned O(N).
// idx: [n_elastic, max_n] (-1 pad); rest: same shape (scaled rest length).
// Returns total springs.
// ---------------------------------------------------------------------
int64_t sph_spring_graph(const float* pos, int64_t n, int64_t n_elastic,
                         int64_t n_liquid, float r0, float scale,
                         int32_t max_n, int32_t* idx, float* rest) {
    const double cutoff = (double)r0 * std::sqrt(2.7);
    const float cut_f = (float)cutoff;
    const double cell = cutoff * 1.0001;

    // candidates: elastic block + boundary block
    std::vector<int64_t> cand;
    cand.reserve(n - n_liquid);
    for (int64_t i = 0; i < n_elastic; ++i) cand.push_back(i);
    for (int64_t i = n_elastic + n_liquid; i < n; ++i) cand.push_back(i);

    // bounding box of candidates
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t c : cand) {
        for (int k = 0; k < 3; ++k) {
            lo[k] = std::min(lo[k], pos[3 * c + k]);
            hi[k] = std::max(hi[k], pos[3 * c + k]);
        }
    }
    int64_t dims[3];
    for (int k = 0; k < 3; ++k) {
        dims[k] = std::max<int64_t>(
            1, (int64_t)(((double)hi[k] - lo[k]) / cell) + 1);
    }
    auto cell_of = [&](int64_t p, int64_t* cc) {
        for (int k = 0; k < 3; ++k) {
            int64_t v = (int64_t)(((double)pos[3 * p + k] - lo[k]) / cell);
            cc[k] = std::min(std::max<int64_t>(v, 0), dims[k] - 1);
        }
    };

    const int64_t ncells = dims[0] * dims[1] * dims[2];
    std::vector<int64_t> count(ncells + 1, 0);
    std::vector<int64_t> cc(3);
    for (int64_t c : cand) {
        int64_t q[3];
        cell_of(c, q);
        ++count[q[0] + dims[0] * (q[1] + dims[1] * q[2]) + 1];
    }
    for (int64_t i = 0; i < ncells; ++i) count[i + 1] += count[i];
    std::vector<int64_t> bucket(cand.size());
    {
        std::vector<int64_t> cursor(count.begin(), count.end() - 1);
        for (int64_t c : cand) {
            int64_t q[3];
            cell_of(c, q);
            bucket[cursor[q[0] + dims[0] * (q[1] + dims[1] * q[2])]++] = c;
        }
    }
    // buckets hold candidates in ascending id per cell (stable fill order)

    int64_t total = 0;
    std::vector<int64_t> found;
    for (int64_t i = 0; i < n_elastic; ++i) {
        found.clear();
        int64_t q[3];
        cell_of(i, q);
        for (int64_t dz = -1; dz <= 1; ++dz)
            for (int64_t dy = -1; dy <= 1; ++dy)
                for (int64_t dx = -1; dx <= 1; ++dx) {
                    const int64_t cx = q[0] + dx, cy = q[1] + dy,
                                  cz = q[2] + dz;
                    if (cx < 0 || cy < 0 || cz < 0 || cx >= dims[0]
                        || cy >= dims[1] || cz >= dims[2]) continue;
                    const int64_t ci = cx + dims[0] * (cy + dims[1] * cz);
                    for (int64_t s = count[ci]; s < count[ci + 1]; ++s) {
                        const int64_t j = bucket[s];
                        if (j == i) continue;
                        // reference comparison: float32 r <= cutoff
                        // (owHelper.cpp:993-996)
                        float dx2 = pos[3 * i] - pos[3 * j];
                        dx2 *= dx2;
                        float dy2 = pos[3 * i + 1] - pos[3 * j + 1];
                        dy2 *= dy2;
                        float dz2 = pos[3 * i + 2] - pos[3 * j + 2];
                        dz2 *= dz2;
                        const float r = std::sqrt(dx2 + dy2 + dz2);
                        if (r <= cut_f) found.push_back(j);
                    }
                }
        std::sort(found.begin(), found.end());
        const int32_t k = (int32_t)std::min<int64_t>(found.size(), max_n);
        for (int32_t s = 0; s < k; ++s) {
            const int64_t j = found[s];
            float dxf = pos[3 * i] - pos[3 * j];
            float dyf = pos[3 * i + 1] - pos[3 * j + 1];
            float dzf = pos[3 * i + 2] - pos[3 * j + 2];
            const float r =
                std::sqrt(dxf * dxf + dyf * dyf + dzf * dzf);
            idx[i * max_n + s] = (int32_t)j;
            rest[i * max_n + s] = r * scale * 0.95f;
        }
        total += k;
    }
    return total;
}

}  // extern "C"
