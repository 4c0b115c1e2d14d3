// Native host kernels for symmer-tpu.
//
// The reference leans on two compiled accelerators for its host hot loops:
//   - numba-jitted GF(2) matmul                (symmer operators/utils.py:28-78)
//   - qiskit's Rust unordered_unique row dedup (symmer operators/utils.py:271-279)
// Here both are replaced by C++ operating directly on the bit-packed uint64
// planes (64 qubits per word), exposed through ctypes (see __init__.py).
//
// Build: g++ -O3 -ffp-contract=off -march=native -shared -fPIC gf2core.cpp -o libgf2core-<cpu-key>.so

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Row-reduced echelon form over GF(2), packed rows, no row reordering.
// Matches symmer _rref_binary semantics (operators/utils.py:292-315):
// iterate rows in order, pivot on the first set bit, XOR the pivot row into
// every other row with that bit set.
void rref_inplace(uint64_t* M, int64_t rows, int64_t words) {
    for (int64_t i = 0; i < rows; ++i) {
        uint64_t* row_i = M + i * words;
        int64_t w = -1;
        uint64_t pivot_bit = 0;
        for (int64_t k = 0; k < words; ++k) {
            if (row_i[k]) {
                w = k;
                pivot_bit = row_i[k] & (~row_i[k] + 1ULL);  // lowest set bit
                break;
            }
        }
        if (w < 0) continue;
        for (int64_t j = 0; j < rows; ++j) {
            if (j == i) continue;
            uint64_t* row_j = M + j * words;
            if (row_j[w] & pivot_bit) {
                for (int64_t k = 0; k < words; ++k) row_j[k] ^= row_i[k];
            }
        }
    }
}

// FNV-1a over a packed row.
static inline uint64_t row_hash(const uint64_t* row, int64_t words) {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t k = 0; k < words; ++k) {
        h ^= row[k];
        h *= 1099511628211ULL;
        h ^= h >> 29;
    }
    return h;
}

// Unordered-unique over packed rows: open-addressing hash table keyed on the
// full row contents.  Writes the index of the first occurrence of each unique
// row to first_idx (length >= n) and the unique-row id of every input row to
// inverse (length n).  Returns the number of unique rows.
int64_t unique_rows(
    const uint64_t* rows, int64_t n, int64_t words,
    int64_t* first_idx, int64_t* inverse
) {
    if (n == 0) return 0;
    int64_t cap = 16;
    while (cap < 2 * n) cap <<= 1;
    std::vector<int64_t> table(cap, -1);
    const int64_t mask = cap - 1;
    int64_t n_unique = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t* row = rows + i * words;
        uint64_t h = row_hash(row, words);
        int64_t slot = (int64_t)(h & (uint64_t)mask);
        for (;;) {
            int64_t entry = table[slot];
            if (entry < 0) {
                table[slot] = n_unique;
                first_idx[n_unique] = i;
                inverse[i] = n_unique;
                ++n_unique;
                break;
            }
            const uint64_t* seen = rows + first_idx[entry] * words;
            if (std::memcmp(seen, row, (size_t)words * 8) == 0) {
                inverse[i] = entry;
                break;
            }
            slot = (slot + 1) & mask;
        }
    }
    return n_unique;
}

// Fused cleanup: unordered-unique over packed rows WITH coefficient
// accumulation in the same pass (first-occurrence order, like unique_rows).
// rows_out receives the unique rows densely; c (interleaved re/im of
// complex128, length n) accumulates into c_out (length >= n).  One traversal
// replaces unique_rows + a numpy fancy-index row gather + np.add.at.
int64_t cleanup_rows(
    const uint64_t* rows, const double* c, int64_t n, int64_t words,
    uint64_t* rows_out, double* c_out
) {
    if (n == 0) return 0;
    int64_t cap = 16;
    while (cap < 2 * n) cap <<= 1;
    std::vector<int64_t> table(cap, -1);
    const int64_t mask = cap - 1;
    int64_t n_unique = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t* row = rows + i * words;
        uint64_t h = row_hash(row, words);
        int64_t slot = (int64_t)(h & (uint64_t)mask);
        for (;;) {
            int64_t entry = table[slot];
            if (entry < 0) {
                table[slot] = n_unique;
                std::memcpy(rows_out + n_unique * words, row,
                            (size_t)words * 8);
                c_out[2 * n_unique] = c[2 * i];
                c_out[2 * n_unique + 1] = c[2 * i + 1];
                ++n_unique;
                break;
            }
            const uint64_t* seen = rows_out + entry * words;
            if (std::memcmp(seen, row, (size_t)words * 8) == 0) {
                c_out[2 * entry] += c[2 * i];
                c_out[2 * entry + 1] += c[2 * i + 1];
                break;
            }
            slot = (slot + 1) & mask;
        }
    }
    return n_unique;
}

// GF(2) matmul on packed operands: C[i,j] = parity(popcount(A_i & B_j)).
// A: (m, words) packed rows; B: (p, words) packed rows (i.e. B^T's columns);
// C: (m, p) uint8 output.
void matmul_gf2(
    const uint64_t* A, int64_t m,
    const uint64_t* B, int64_t p,
    int64_t words, uint8_t* C
) {
    for (int64_t i = 0; i < m; ++i) {
        const uint64_t* a = A + i * words;
        uint8_t* c_row = C + i * p;
        for (int64_t j = 0; j < p; ++j) {
            const uint64_t* b = B + j * words;
            uint64_t acc = 0;
            for (int64_t k = 0; k < words; ++k) {
                acc ^= a[k] & b[k];
            }
            c_row[j] = (uint8_t)(__builtin_popcountll(acc) & 1);
        }
    }
}

// In-place Clifford rotation by a single Pauli (xr, zr) with pi/2 multiple
// m4 = m mod 4 (semantics of np_core.rotate_single's Clifford branch):
//   m4 == 0: identity; terms commuting with the rotation are untouched;
//   m4 == 2: anticommuting terms get c -> -c;
//   m4 == 1/3: anticommuting terms map P -> -+ i P Q with the packed product
//   phase sign * i^{3(y_in + y_r) + y_out} (cf. np_core.multiply_single).
// coeffs is the interleaved (re, im) view of a complex128 buffer.
void clifford_rotate_inplace(
    uint64_t* x, uint64_t* z, double* coeffs,
    int64_t n, int64_t W,
    const uint64_t* xr, const uint64_t* zr, int64_t m4
) {
    if (m4 == 0) return;
    int64_t y_r = 0;
    for (int64_t k = 0; k < W; ++k) y_r += __builtin_popcountll(xr[k] & zr[k]);
    const int64_t phase_shift = (m4 == 1) ? 3 : 1;  // *(-i) = i^3, *(+i) = i^1
    for (int64_t i = 0; i < n; ++i) {
        uint64_t* xi = x + i * W;
        uint64_t* zi = z + i * W;
        int64_t ac = 0;
        for (int64_t k = 0; k < W; ++k) {
            ac += __builtin_popcountll(xi[k] & zr[k])
                + __builtin_popcountll(zi[k] & xr[k]);
        }
        if (!(ac & 1)) continue;
        double re = coeffs[2 * i], im = coeffs[2 * i + 1];
        if (m4 == 2) {
            coeffs[2 * i] = -re;
            coeffs[2 * i + 1] = -im;
            continue;
        }
        int64_t y_in = 0, x1z2 = 0, y_out = 0;
        for (int64_t k = 0; k < W; ++k) {
            y_in += __builtin_popcountll(xi[k] & zi[k]);
            x1z2 += __builtin_popcountll(xi[k] & zr[k]);
            const uint64_t xo = xi[k] ^ xr[k];
            const uint64_t zo = zi[k] ^ zr[k];
            y_out += __builtin_popcountll(xo & zo);
            xi[k] = xo;
            zi[k] = zo;
        }
        const int64_t ip = (3 * (y_in + y_r) + y_out + phase_shift) % 4;
        if (x1z2 & 1) { re = -re; im = -im; }
        switch (ip) {
            case 0: coeffs[2 * i] = re;  coeffs[2 * i + 1] = im;  break;
            case 1: coeffs[2 * i] = -im; coeffs[2 * i + 1] = re;  break;
            case 2: coeffs[2 * i] = -re; coeffs[2 * i + 1] = -im; break;
            default: coeffs[2 * i] = im; coeffs[2 * i + 1] = -re; break;
        }
    }
}

static inline uint64_t row_hash2(
    const uint64_t* a, const uint64_t* b, int64_t words
) {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t k = 0; k < words; ++k) {
        h ^= a[k]; h *= 1099511628211ULL; h ^= h >> 29;
    }
    for (int64_t k = 0; k < words; ++k) {
        h ^= b[k]; h *= 1099511628211ULL; h ^= h >> 29;
    }
    return h;
}

// Fused non-Clifford rotation + dedup: conjugation by R(t) = e^{i t/2 Q}
// maps commuting terms to themselves and anticommuting terms P to
// cos(t) P + sin(t) (-i P Q), with the product phase of np_core
// .multiply_single.  The doubled row set never materialises: every output
// row goes straight into an open-addressing table keyed on (x, z), with
// coefficients accumulated on hit (the host analog of the device
// rotate_nonclifford_cleanup fusion, jx_core).  Returns n_unique; x_out /
// z_out / c_out are caller-allocated with capacity 2n.
int64_t rotate_nonclifford_cleanup(
    const uint64_t* x, const uint64_t* z, const double* c, int64_t n,
    int64_t W, const uint64_t* xr, const uint64_t* zr,
    double cos_t, double sin_t,
    uint64_t* x_out, uint64_t* z_out, double* c_out
) {
    if (n == 0) return 0;
    int64_t cap = 16;
    while (cap < 4 * n) cap <<= 1;  // up to 2n output rows, load <= 0.5
    std::vector<int64_t> table(cap, -1);
    const int64_t mask = cap - 1;
    int64_t n_unique = 0;
    int64_t y_r = 0;
    for (int64_t k = 0; k < W; ++k) y_r += __builtin_popcountll(xr[k] & zr[k]);

    auto insert = [&](const uint64_t* xi, const uint64_t* zi,
                      double re, double im) {
        uint64_t h = row_hash2(xi, zi, W);
        int64_t slot = (int64_t)(h & (uint64_t)mask);
        for (;;) {
            int64_t entry = table[slot];
            if (entry < 0) {
                table[slot] = n_unique;
                std::memcpy(x_out + n_unique * W, xi, (size_t)W * 8);
                std::memcpy(z_out + n_unique * W, zi, (size_t)W * 8);
                c_out[2 * n_unique] = re;
                c_out[2 * n_unique + 1] = im;
                ++n_unique;
                return;
            }
            if (std::memcmp(x_out + entry * W, xi, (size_t)W * 8) == 0 &&
                std::memcmp(z_out + entry * W, zi, (size_t)W * 8) == 0) {
                c_out[2 * entry] += re;
                c_out[2 * entry + 1] += im;
                return;
            }
            slot = (slot + 1) & mask;
        }
    };

    std::vector<uint64_t> xp(W), zp(W);
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t* xi = x + i * W;
        const uint64_t* zi = z + i * W;
        int64_t ac = 0, y_in = 0, x1z2 = 0, y_out = 0;
        for (int64_t k = 0; k < W; ++k) {
            ac += __builtin_popcountll(xi[k] & zr[k])
                + __builtin_popcountll(zi[k] & xr[k]);
            y_in += __builtin_popcountll(xi[k] & zi[k]);
            x1z2 += __builtin_popcountll(xi[k] & zr[k]);
            const uint64_t xw = xi[k] ^ xr[k];
            const uint64_t zw = zi[k] ^ zr[k];
            y_out += __builtin_popcountll(xw & zw);
            xp[k] = xw;
            zp[k] = zw;
        }
        const double re = c[2 * i], im = c[2 * i + 1];
        if (!(ac & 1)) {
            insert(xi, zi, re, im);
            continue;
        }
        insert(xi, zi, re * cos_t, im * cos_t);
        // phase = sign * i^{(3(y_in + y_r) + y_out) mod 4}, then * (-i sin t)
        double pr = re * sin_t, pi_ = im * sin_t;
        if (x1z2 & 1) { pr = -pr; pi_ = -pi_; }
        // fold the extra factor -i: i^ip * (-i) = i^{ip + 3}
        const int64_t ip = (3 * (y_in + y_r) + y_out + 3) % 4;
        switch (ip) {
            case 0: insert(xp.data(), zp.data(), pr, pi_); break;
            case 1: insert(xp.data(), zp.data(), -pi_, pr); break;
            case 2: insert(xp.data(), zp.data(), -pr, -pi_); break;
            default: insert(xp.data(), zp.data(), pi_, -pr); break;
        }
    }
    return n_unique;
}

// Fused all-pairs product + dedup: every product row goes straight into the
// open-addressing table (the m1*m2 row set never materialises) -- the host
// analog of the device mul_pairs_cleanup fusion (jx_core).  Output capacity
// must be m1*m2 rows (worst case, no duplicates).  Returns n_unique.
int64_t mul_pairs_cleanup(
    const uint64_t* x1, const uint64_t* z1, const double* c1, int64_t m1,
    const uint64_t* x2, const uint64_t* z2, const double* c2, int64_t m2,
    int64_t W, uint64_t* x_out, uint64_t* z_out, double* c_out
) {
    const int64_t P = m1 * m2;
    if (P == 0) return 0;
    int64_t cap = 16;
    while (cap < 2 * P) cap <<= 1;
    std::vector<int64_t> table(cap, -1);
    const int64_t mask = cap - 1;
    int64_t n_unique = 0;
    std::vector<uint64_t> xp(W), zp(W);
    std::vector<int64_t> y2(m2);
    for (int64_t j = 0; j < m2; ++j) {
        int64_t y = 0;
        const uint64_t* xj = x2 + j * W;
        const uint64_t* zj = z2 + j * W;
        for (int64_t k = 0; k < W; ++k) y += __builtin_popcountll(xj[k] & zj[k]);
        y2[j] = y;
    }
    for (int64_t i = 0; i < m1; ++i) {
        const uint64_t* xi = x1 + i * W;
        const uint64_t* zi = z1 + i * W;
        int64_t y1 = 0;
        for (int64_t k = 0; k < W; ++k) y1 += __builtin_popcountll(xi[k] & zi[k]);
        const double re1 = c1[2 * i], im1 = c1[2 * i + 1];
        for (int64_t j = 0; j < m2; ++j) {
            const uint64_t* xj = x2 + j * W;
            const uint64_t* zj = z2 + j * W;
            int64_t y_out = 0, x1z2 = 0;
            for (int64_t k = 0; k < W; ++k) {
                x1z2 += __builtin_popcountll(xi[k] & zj[k]);
                const uint64_t xw = xi[k] ^ xj[k];
                const uint64_t zw = zi[k] ^ zj[k];
                y_out += __builtin_popcountll(xw & zw);
                xp[k] = xw;
                zp[k] = zw;
            }
            double re = re1 * c2[2 * j] - im1 * c2[2 * j + 1];
            double im = re1 * c2[2 * j + 1] + im1 * c2[2 * j];
            if (x1z2 & 1) { re = -re; im = -im; }
            const int64_t ip = (3 * (y1 + y2[j]) + y_out) % 4;
            double pr, pi_;
            switch (ip) {
                case 0: pr = re;  pi_ = im;  break;
                case 1: pr = -im; pi_ = re;  break;
                case 2: pr = -re; pi_ = -im; break;
                default: pr = im; pi_ = -re; break;
            }
            uint64_t h = row_hash2(xp.data(), zp.data(), W);
            int64_t slot = (int64_t)(h & (uint64_t)mask);
            for (;;) {
                int64_t entry = table[slot];
                if (entry < 0) {
                    table[slot] = n_unique;
                    std::memcpy(x_out + n_unique * W, xp.data(), (size_t)W * 8);
                    std::memcpy(z_out + n_unique * W, zp.data(), (size_t)W * 8);
                    c_out[2 * n_unique] = pr;
                    c_out[2 * n_unique + 1] = pi_;
                    ++n_unique;
                    break;
                }
                if (std::memcmp(x_out + entry * W, xp.data(), (size_t)W * 8) == 0 &&
                    std::memcmp(z_out + entry * W, zp.data(), (size_t)W * 8) == 0) {
                    c_out[2 * entry] += pr;
                    c_out[2 * entry + 1] += pi_;
                    break;
                }
                slot = (slot + 1) & mask;
            }
        }
    }
    return n_unique;
}

// All-pairs Pauli product (left index outer, rows ordered i*m2 + j) with
// phases -- the packed equivalent of np_core.multiply: output planes are
// XORs, the coefficient picks up sign * i^{(3(y1+y2) + y_out) mod 4} with
// sign = (-1)^{popcount(x1 & z2)}.  Avoids numpy's broadcast temporaries
// (three (m1, m2, W) popcount arrays); streams each output row once.
// c1/c2/co are interleaved (re, im) views of complex128 buffers.
void mul_pairs(
    const uint64_t* x1, const uint64_t* z1, const double* c1, int64_t m1,
    const uint64_t* x2, const uint64_t* z2, const double* c2, int64_t m2,
    int64_t W, uint64_t* xo, uint64_t* zo, double* co
) {
    for (int64_t i = 0; i < m1; ++i) {
        const uint64_t* xi = x1 + i * W;
        const uint64_t* zi = z1 + i * W;
        int64_t y1 = 0;
        for (int64_t k = 0; k < W; ++k) y1 += __builtin_popcountll(xi[k] & zi[k]);
        const double re1 = c1[2 * i], im1 = c1[2 * i + 1];
        for (int64_t j = 0; j < m2; ++j) {
            const uint64_t* xj = x2 + j * W;
            const uint64_t* zj = z2 + j * W;
            const int64_t o = i * m2 + j;
            uint64_t* xr = xo + o * W;
            uint64_t* zr = zo + o * W;
            int64_t y2 = 0, y_out = 0, x1z2 = 0;
            for (int64_t k = 0; k < W; ++k) {
                y2 += __builtin_popcountll(xj[k] & zj[k]);
                x1z2 += __builtin_popcountll(xi[k] & zj[k]);
                const uint64_t xw = xi[k] ^ xj[k];
                const uint64_t zw = zi[k] ^ zj[k];
                y_out += __builtin_popcountll(xw & zw);
                xr[k] = xw;
                zr[k] = zw;
            }
            double re = re1 * c2[2 * j] - im1 * c2[2 * j + 1];
            double im = re1 * c2[2 * j + 1] + im1 * c2[2 * j];
            if (x1z2 & 1) { re = -re; im = -im; }
            const int64_t ip = (3 * (y1 + y2) + y_out) % 4;
            switch (ip) {
                case 0: co[2 * o] = re;  co[2 * o + 1] = im;  break;
                case 1: co[2 * o] = -im; co[2 * o + 1] = re;  break;
                case 2: co[2 * o] = -re; co[2 * o + 1] = -im; break;
                default: co[2 * o] = im; co[2 * o + 1] = -re; break;
            }
        }
    }
}

// Whole Clifford SEQUENCE applied in one call: depth rotations, each a
// single Pauli (xr_d, zr_d) with pi/2 multiple m4_d, run left-to-right over
// the same planes (the host analog of the device clifford_scan, jx_core --
// one ctypes crossing instead of one per gate).
// y_r cache for the rotation sequence: yrp[d] = popcount(rx_d & rz_d)
// (the rotation row's own Y count, a loop invariant of the phase formula).
// Uses the caller's stack array up to 64 rotations, else the heap vector.
static inline const int64_t* rotation_y_cache(
    const uint64_t* rx, const uint64_t* rz, int64_t W, int64_t depth,
    int64_t* y_stack, std::vector<int64_t>& y_heap
) {
    int64_t* yrp = y_stack;
    if (depth > 64) { y_heap.resize(depth); yrp = y_heap.data(); }
    for (int64_t d = 0; d < depth; ++d) {
        int64_t y = 0;
        for (int64_t k = 0; k < W; ++k)
            y += __builtin_popcountll(rx[d * W + k] & rz[d * W + k]);
        yrp[d] = y;
    }
    return yrp;
}

// Per-term Clifford rotation-sequence core (W <= 8): applies all depth
// rotations to ONE row held in registers.  m4 == 2 is the sign-only
// conjugation step; m4 in {1, 3} the branch-free pi/2 step (a ~50/50
// anticommute split defeats the branch predictor -- measured 1.5x on the
// flagship rotation set -- so always compute and select with an
// all-ones/zero mask).  Shared by clifford_rotate_sequence_inplace and the
// fused clifford_project_cleanup so the phase/sign arithmetic has exactly
// one definition.
static inline void rotate_row_registers(
    uint64_t* xi, uint64_t* zi, double& re, double& im, int64_t W,
    const uint64_t* rx, const uint64_t* rz, const int64_t* m4s,
    int64_t depth, const int64_t* yrp
) {
    for (int64_t d = 0; d < depth; ++d) {
        const int64_t m4 = m4s[d];
        if (m4 == 0) continue;
        const uint64_t* xr = rx + d * W;
        const uint64_t* zr = rz + d * W;
        if (m4 == 2) {
            int64_t ac = 0;
            for (int64_t k = 0; k < W; ++k) {
                ac += __builtin_popcountll(xi[k] & zr[k])
                    + __builtin_popcountll(zi[k] & xr[k]);
            }
            if (ac & 1) { re = -re; im = -im; }
            continue;
        }
        const int64_t phase_shift = (m4 == 1) ? 3 : 1;
        int64_t y_in = 0, x1z2 = 0, zx = 0, y_out = 0;
        for (int64_t k = 0; k < W; ++k) {
            y_in += __builtin_popcountll(xi[k] & zi[k]);
            x1z2 += __builtin_popcountll(xi[k] & zr[k]);
            zx   += __builtin_popcountll(zi[k] & xr[k]);
        }
        const uint64_t ac = (uint64_t)((x1z2 + zx) & 1);
        const uint64_t sel = (uint64_t)0 - ac;
        for (int64_t k = 0; k < W; ++k) {
            const uint64_t xo = xi[k] ^ (xr[k] & sel);
            const uint64_t zo = zi[k] ^ (zr[k] & sel);
            y_out += __builtin_popcountll(xo & zo);
            xi[k] = xo;
            zi[k] = zo;
        }
        // when !ac the planes are unchanged (ip forced to 0, sign to +1)
        const int64_t ip =
            (int64_t)(((3 * (y_in + yrp[d]) + y_out + phase_shift) & 3)
                      * (int64_t)ac);
        const double sign = (double)(1 - 2 * (int64_t)((x1z2 & 1) & ac));
        const double sre = sign * re, sim = sign * im;
        re = (ip == 0) ? sre : (ip == 1) ? -sim : (ip == 2) ? -sre : sim;
        im = (ip == 0) ? sim : (ip == 1) ? sre  : (ip == 2) ? -sim : -sre;
    }
}

void clifford_rotate_sequence_inplace(
    uint64_t* x, uint64_t* z, double* coeffs,
    int64_t n, int64_t W,
    const uint64_t* rx, const uint64_t* rz, const int64_t* m4s,
    int64_t depth
) {
    // Row-major traversal: each row's planes + coefficient stay in registers
    // across ALL depth rotations (one pass over the n*W operand memory
    // instead of depth passes; the d*W rotation rows live in L1).  The wide
    // fallback (W > 8) keeps the original depth-major order.
    if (W > 8) {
        for (int64_t d = 0; d < depth; ++d) {
            clifford_rotate_inplace(
                x, z, coeffs, n, W, rx + d * W, rz + d * W, m4s[d]
            );
        }
        return;
    }
    int64_t y_r[64];
    std::vector<int64_t> y_r_heap;
    const int64_t* yrp = rotation_y_cache(rx, rz, W, depth, y_r, y_r_heap);
    for (int64_t i = 0; i < n; ++i) {
        uint64_t xi[8], zi[8];
        uint64_t* xg = x + i * W;
        uint64_t* zg = z + i * W;
        for (int64_t k = 0; k < W; ++k) { xi[k] = xg[k]; zi[k] = zg[k]; }
        double re = coeffs[2 * i], im = coeffs[2 * i + 1];
        rotate_row_registers(xi, zi, re, im, W, rx, rz, m4s, depth, yrp);
        for (int64_t k = 0; k < W; ++k) { xg[k] = xi[k]; zg[k] = zi[k]; }
        coeffs[2 * i] = re;
        coeffs[2 * i + 1] = im;
    }
}

// Qubitwise-commutation matrix on packed operands:
// C[i,j] = 1 iff ((x1_i ^ x2_j) | (z1_i ^ z2_j)) & (x1_i | z1_i) & (x2_j | z2_j)
// vanishes, i.e. on every qubit the terms agree or one acts trivially
// (reference base.py:985-1009 broadcasts boolean blocks; this runs at packed
// memory speed with early exit).
void qwc_matrix(
    const uint64_t* x1, const uint64_t* z1, int64_t m1,
    const uint64_t* x2, const uint64_t* z2, int64_t m2,
    int64_t words, uint8_t* C
) {
    // hoist the per-row supports (n = x | z)
    std::vector<uint64_t> n2(m2 * words);
    for (int64_t j = 0; j < m2 * words; ++j) n2[j] = x2[j] | z2[j];
    for (int64_t i = 0; i < m1; ++i) {
        const uint64_t* xi = x1 + i * words;
        const uint64_t* zi = z1 + i * words;
        uint8_t* c_row = C + i * m2;
        uint64_t ni[32];
        uint64_t ni_heap_storage = 0; (void)ni_heap_storage;
        std::vector<uint64_t> ni_heap;
        uint64_t* nip = ni;
        if (words > 32) { ni_heap.resize(words); nip = ni_heap.data(); }
        for (int64_t k = 0; k < words; ++k) nip[k] = xi[k] | zi[k];
        for (int64_t j = 0; j < m2; ++j) {
            const uint64_t* xj = x2 + j * words;
            const uint64_t* zj = z2 + j * words;
            const uint64_t* nj = n2.data() + j * words;
            uint8_t ok = 1;
            for (int64_t k = 0; k < words; ++k) {
                uint64_t d = ((xi[k] ^ xj[k]) | (zi[k] ^ zj[k])) & nip[k] & nj[k];
                if (d) { ok = 0; break; }
            }
            c_row[j] = ok;
        }
    }
}

}  // extern "C"

extern "C" {

// 64x64 bit-block transpose via recursive delta swaps, LSB-first indexing:
// bit j of a[i] <-> bit i of a[j].
static void transpose64(uint64_t a[64]) {
    uint64_t m = 0x00000000FFFFFFFFULL;
    for (int j = 32; j != 0; j >>= 1, m ^= m << j) {
        for (int k = 0; k < 64; k = ((k | j) + 1) & ~j) {
            uint64_t t = ((a[k] >> j) ^ a[k | j]) & m;
            a[k | j] ^= t;
            a[k] ^= t << j;
        }
    }
}

// Transpose a bit matrix given as packed LSB-first uint64 rows.
//   in : rows x in_words   (bit c of row r = (in[r*in_words + c/64] >> (c%64)) & 1)
//   out: cols x out_words  (pre-zeroed by caller; out_words >= ceil(rows/64))
// Semantically out[c, r] = in[r, c] for r < rows, c < cols.
void transpose_bits(
    const uint64_t* in, int64_t rows, int64_t in_words, int64_t cols,
    uint64_t* out, int64_t out_words
) {
    uint64_t block[64];
    for (int64_t rb = 0; rb < rows; rb += 64) {
        const int64_t rn = (rows - rb < 64) ? (rows - rb) : 64;
        for (int64_t cb = 0; cb < cols; cb += 64) {
            for (int64_t i = 0; i < 64; ++i) {
                block[i] = (i < rn) ? in[(rb + i) * in_words + cb / 64] : 0ULL;
            }
            // note the LSB-first convention: bit j of block[i] is column cb+j
            // of row rb+i; transpose64 operates MSB-agnostically on the
            // 64x64 bit square, so the result has bit i of word j = original
            // bit j of word i -- exactly the LSB-first transpose.
            transpose64(block);
            const int64_t cn = (cols - cb < 64) ? (cols - cb) : 64;
            for (int64_t j = 0; j < cn; ++j) {
                out[(cb + j) * out_words + rb / 64] = block[j];
            }
        }
    }
}

#if defined(__BMI2__)
#include <immintrin.h>
static inline uint64_t pext64(uint64_t v, uint64_t m) { return _pext_u64(v, m); }
#else
// software parallel-extract: walk the set bits of the mask
static inline uint64_t pext64(uint64_t v, uint64_t m) {
    uint64_t out = 0;
    for (int j = 0; m; ++j, m &= m - 1) {
        if (v & (m & (~m + 1ULL))) out |= 1ULL << j;
    }
    return out;
}
#endif

// Packed bit-column selection (the host analog of kernels/pack.py
// select_columns): keep the bit columns where the packed keep-mask is set,
// compacted LSB-first.  One PEXT per (row, word) on BMI2 hardware replaces
// the python byte-LUT passes; the projection layer's qubit deletion
// (cf. symmer S3Projection _perform_projection, projection/base.py:62-93)
// runs at memory speed.
//   in   : (T, W) packed rows;  masks: (W,) keep-mask words, LSB-first
//   out  : (T, W_out) pre-zeroed, W_out >= ceil(popcount(masks)/64)
void select_columns(
    const uint64_t* in, int64_t T, int64_t W,
    const uint64_t* masks, uint64_t* out, int64_t W_out
) {
    std::vector<int64_t> width(W), base(W);
    int64_t offs = 0;
    for (int64_t k = 0; k < W; ++k) {
        width[k] = __builtin_popcountll(masks[k]);
        base[k] = offs;
        offs += width[k];
    }
    for (int64_t t = 0; t < T; ++t) {
        const uint64_t* row = in + t * W;
        uint64_t* orow = out + t * W_out;
        for (int64_t k = 0; k < W; ++k) {
            if (!masks[k]) continue;
            const uint64_t vals = pext64(row[k], masks[k]);
            const int64_t w = base[k] >> 6, b = base[k] & 63;
            orow[w] |= vals << b;
            if (b + width[k] > 64) orow[w + 1] |= vals >> (64 - b);
        }
    }
}

// Scatter XOR-fold: out[idx[i]] ^= M[i] for every row.  The GF(2) sketch
// compression behind the tall-matrix kernel-basis search (kernels/gf2.py
// _kernel_basis_sketched): one linear pass replaces argsort + gather +
// reduceat.  out must be zeroed, (m, W); idx values in [0, m).
void xor_fold(
    const uint64_t* M, int64_t R, int64_t W,
    const int64_t* idx, uint64_t* out
) {
    for (int64_t i = 0; i < R; ++i) {
        const uint64_t* r = M + i * W;
        uint64_t* o = out + idx[i] * W;
        for (int64_t k = 0; k < W; ++k) o[k] ^= r[k];
    }
}

// Null-space verification for the two-block (symplectic) layout: rows are
// the bit-concatenation [A_i | B_i] without materialising the concat.
// Returns 1 as soon as some candidate j has parity(popcount(A_i & Va_j)) ^
// parity(popcount(B_i & Vb_j)) == 1 for some row i, else 0 (all candidates
// annihilate every row).  Va/Vb: (k, Wa)/(k, Wb) packed candidate halves.
int64_t null_check2(
    const uint64_t* A, int64_t Wa,
    const uint64_t* B, int64_t Wb,
    int64_t R,
    const uint64_t* Va, const uint64_t* Vb, int64_t k
) {
    for (int64_t i = 0; i < R; ++i) {
        const uint64_t* a = A + i * Wa;
        const uint64_t* b = B + i * Wb;
        for (int64_t j = 0; j < k; ++j) {
            uint64_t acc = 0;
            const uint64_t* va = Va + j * Wa;
            for (int64_t w = 0; w < Wa; ++w) acc ^= a[w] & va[w];
            const uint64_t* vb = Vb + j * Wb;
            uint64_t accb = 0;
            for (int64_t w = 0; w < Wb; ++w) accb ^= b[w] & vb[w];
            if ((__builtin_popcountll(acc) + __builtin_popcountll(accb)) & 1)
                return 1;
        }
    }
    return 0;
}

// Fused host taper projection (the host mirror of the device
// clifford_rotate_project fusion, kernels/jx_core): for each input term, in
// ONE pass while the row is in registers --
//   1. apply the Clifford rotation sequence (branch-free pi/2 steps),
//   2. drop the term if it anticommutes with any rotated single-qubit
//      stabilizer (distinct qubits: one packed XOR tests them all),
//   3. flip the coefficient sign by the -1 eigenvalue parity,
//   4. PEXT-select the free qubit columns,
//   5. insert the reduced [x|z] key into the dedup table, accumulating the
//      coefficient.
// Nothing intermediate materialises: the unfused path writes/reads the
// rotated planes, the commute mask, the filtered copy and the selected
// planes through memory five times; this touches the operand memory once.
// rows_out: (n, 2*W_out) key rows (x words then z words); c_out interleaved
// complex accumulators.  Returns the unique-row count, or -1 when W > 8
// (caller falls back to the unfused path).
int64_t clifford_project_cleanup(
    const uint64_t* x, const uint64_t* z, const double* c,
    int64_t n, int64_t W,
    const uint64_t* rx, const uint64_t* rz, const int64_t* m4s, int64_t depth,
    const uint64_t* zmask, const uint64_t* xmask,
    const uint64_t* negx, const uint64_t* negz,
    const uint64_t* colmask, int64_t W_out,
    uint64_t* rows_out, double* c_out
) {
    if (W > 8 || W_out > 8) return -1;
    if (n == 0) return 0;
    int64_t y_r[64];
    std::vector<int64_t> y_r_heap;
    const int64_t* yrp = rotation_y_cache(rx, rz, W, depth, y_r, y_r_heap);
    int64_t width[8], base[8];
    int64_t offs = 0;
    for (int64_t k = 0; k < W; ++k) {
        width[k] = __builtin_popcountll(colmask[k]);
        base[k] = offs;
        offs += width[k];
    }
    const int64_t kw = 2 * W_out;
    int64_t cap = 16;
    while (cap < 2 * n) cap <<= 1;
    std::vector<int64_t> table(cap, -1);
    const int64_t tmask = cap - 1;
    int64_t n_unique = 0;

    for (int64_t i = 0; i < n; ++i) {
        uint64_t xi[8], zi[8];
        const uint64_t* xg = x + i * W;
        const uint64_t* zg = z + i * W;
        for (int64_t k = 0; k < W; ++k) { xi[k] = xg[k]; zi[k] = zg[k]; }
        double re = c[2 * i], im = c[2 * i + 1];
        rotate_row_registers(xi, zi, re, im, W, rx, rz, m4s, depth, yrp);

        // commute filter against the single-qubit stabilizers
        uint64_t anti = 0;
        for (int64_t k = 0; k < W; ++k)
            anti |= (xi[k] & zmask[k]) ^ (zi[k] & xmask[k]);
        if (anti) continue;

        // eigenvalue sign parity
        int64_t par = 0;
        for (int64_t k = 0; k < W; ++k) {
            par += __builtin_popcountll(xi[k] & negx[k])
                 + __builtin_popcountll(zi[k] & negz[k]);
        }
        if (par & 1) { re = -re; im = -im; }

        // PEXT free-column selection into the dedup key
        uint64_t key[16];
        for (int64_t k = 0; k < kw; ++k) key[k] = 0;
        for (int64_t k = 0; k < W; ++k) {
            if (!colmask[k]) continue;
            const int64_t w = base[k] >> 6, b = base[k] & 63;
            const uint64_t xv = pext64(xi[k], colmask[k]);
            key[w] |= xv << b;
            if (b + width[k] > 64) key[w + 1] |= xv >> (64 - b);
            const uint64_t zv = pext64(zi[k], colmask[k]);
            key[W_out + w] |= zv << b;
            if (b + width[k] > 64) key[W_out + w + 1] |= zv >> (64 - b);
        }

        // dedup insert with coefficient accumulation
        uint64_t h = 1469598103934665603ULL;
        for (int64_t k = 0; k < kw; ++k) {
            h ^= key[k]; h *= 1099511628211ULL; h ^= h >> 29;
        }
        int64_t slot = (int64_t)(h & (uint64_t)tmask);
        for (;;) {
            int64_t entry = table[slot];
            if (entry < 0) {
                table[slot] = n_unique;
                std::memcpy(rows_out + n_unique * kw, key, (size_t)kw * 8);
                c_out[2 * n_unique] = re;
                c_out[2 * n_unique + 1] = im;
                ++n_unique;
                break;
            }
            if (std::memcmp(rows_out + entry * kw, key, (size_t)kw * 8) == 0) {
                c_out[2 * entry] += re;
                c_out[2 * entry + 1] += im;
                break;
            }
            slot = (slot + 1) & tmask;
        }
    }
    return n_unique;
}

}  // extern "C"
