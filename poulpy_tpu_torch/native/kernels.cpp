// The port's native host tier (C++ through ctypes, poulpy_tpu_torch/native).
//
// Host-side work around the card that numpy would do word by word: the
// ChaCha8 keystream behind hal/source.py's Source (every key, noise and
// mask draw), and exact coefficient-domain kernels (znx rotate and
// automorphism, base-2^k normalization, the i128 negacyclic convolution,
// the Montgomery NTT) held bit for bit against the port's torch functions
// (tests/test_torch_native.py) and usable as golden vectors.
//
// Limbs are wrapping int64 (poulpy's VecZnx): every add, subtract, negate
// and left shift that can leave the int64 range is done in uint64_t, and
// the file is built as C++20, where a right shift of a negative value is
// arithmetic and uint64_t → int64_t is modular.  So the results are
// defined at every input, the int64 extremes included.
//
// Build: g++ -O3 -march=native -std=c++20 -shared -fPIC (native/__init__.py).

#include <cstdint>
#include <cstring>

namespace {

inline int64_t wadd(int64_t a, int64_t b) { return (int64_t)((uint64_t)a + (uint64_t)b); }
inline int64_t wsub(int64_t a, int64_t b) { return (int64_t)((uint64_t)a - (uint64_t)b); }
inline int64_t wneg(int64_t a) { return (int64_t)(0 - (uint64_t)a); }
inline int64_t wshl(int64_t a, int64_t s) { return (int64_t)((uint64_t)a << s); }

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// ChaCha8 keystream (rand_chacha's ChaCha8Rng layout, as hal/source.py:
// constants | 8 key words | 64-bit block counter | stream 0, 8 rounds,
// output = post-round state + input state).
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

#define QR(a, b, c, d)                                                      \
    x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 16);                           \
    x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 12);                           \
    x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 8);                            \
    x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 7);

// key: 8 u32 words; out: nblocks × 16 u32 words for counters
// counter0 .. counter0 + nblocks − 1.
void chacha8_blocks(const uint32_t* key, uint64_t counter0,
                    uint64_t nblocks, uint32_t* out) {
    for (uint64_t blk = 0; blk < nblocks; ++blk) {
        uint64_t ctr = counter0 + blk;
        uint32_t st[16];
        st[0] = 0x61707865u; st[1] = 0x3320646Eu;
        st[2] = 0x79622D32u; st[3] = 0x6B206574u;
        for (int i = 0; i < 8; ++i) st[4 + i] = key[i];
        st[12] = (uint32_t)(ctr & 0xFFFFFFFFu);
        st[13] = (uint32_t)(ctr >> 32);
        st[14] = 0; st[15] = 0;
        uint32_t x[16];
        std::memcpy(x, st, sizeof(st));
        for (int r = 0; r < 4; ++r) {   // 8 rounds = 4 double rounds
            QR(0, 4, 8, 12) QR(1, 5, 9, 13) QR(2, 6, 10, 14) QR(3, 7, 11, 15)
            QR(0, 5, 10, 15) QR(1, 6, 11, 12) QR(2, 7, 8, 13) QR(3, 4, 9, 14)
        }
        uint32_t* o = out + 16 * blk;
        for (int i = 0; i < 16; ++i) o[i] = x[i] + st[i];
    }
}

// ---------------------------------------------------------------------------
// znx coefficient kernels (hal/znx.py), wrapping int64, rows × n row-major.
// ---------------------------------------------------------------------------

// res = a · X^p in Z[X]/(X^N+1): res[i] = ±a[(i − p) mod N]
void znx_rotate_i64(int64_t p, const int64_t* a, int64_t* out,
                    int64_t rows, int64_t n) {
    int64_t mask2n = 2 * n - 1;
    for (int64_t r = 0; r < rows; ++r) {
        const int64_t* ar = a + r * n;
        int64_t* orow = out + r * n;
        for (int64_t i = 0; i < n; ++i) {
            int64_t q = wsub(i, p) & mask2n;
            orow[i] = (q < n) ? ar[q] : wneg(ar[q - n]);
        }
    }
}

// res(X) = a(X^p), p odd and reduced mod 2N: a[i] → ±res[(i · p) mod 2N]
void znx_automorphism_i64(int64_t p, const int64_t* a, int64_t* out,
                          int64_t rows, int64_t n) {
    int64_t mask2n = 2 * n - 1;
    for (int64_t r = 0; r < rows; ++r) {
        const int64_t* ar = a + r * n;
        int64_t* orow = out + r * n;
        orow[0] = ar[0];
        int64_t k = 0;
        for (int64_t i = 1; i < n; ++i) {
            k = (k + p) & mask2n;
            if (k < n) orow[k] = ar[i];
            else       orow[k - n] = wneg(ar[i]);
        }
    }
}

// ---------------------------------------------------------------------------
// Base-2^k carry-propagation normalization (hal/normalization.py
// vec_znx_normalize: the first / middle / final schedule): x is [size, n]
// limb-major (limb 0 most significant), normalized in place, with an
// optional fused left shift lsh.
// ---------------------------------------------------------------------------

// sign-extended low k bits of x, 1 ≤ k ≤ 64
static inline int64_t get_digit(int64_t k, int64_t x) {
    int sh = (int)(64 - k);
    return wshl(x, sh) >> sh;
}

static inline int64_t get_carry(int64_t k, int64_t x, int64_t digit) {
    return wsub(x, digit) >> k;
}

void vec_znx_normalize_i64(int64_t base2k, int64_t lsh, int64_t* x,
                           int64_t size, int64_t n) {
    int64_t k = base2k - lsh;
    if (size == 1) {
        for (int64_t c = 0; c < n; ++c)
            x[c] = get_digit(base2k, wshl(get_digit(k, x[c]), lsh));
        return;
    }
    for (int64_t c = 0; c < n; ++c) {
        // first (lowest) limb
        int64_t* last = x + (size - 1) * n;
        int64_t d = get_digit(k, last[c]);
        int64_t carry = get_carry(k, last[c], d);
        last[c] = wshl(d, lsh);
        // middle limbs
        for (int64_t j = size - 2; j > 0; --j) {
            int64_t* row = x + j * n;
            int64_t dj = get_digit(k, row[c]);
            int64_t cj = get_carry(k, row[c], dj);
            int64_t dpc = wadd(wshl(dj, lsh), carry);
            int64_t x1 = get_digit(base2k, dpc);
            row[c] = x1;
            carry = wadd(cj, get_carry(base2k, dpc, x1));
        }
        // final (top) limb: the outgoing carry is dropped (mod 1 on the torus)
        x[c] = get_digit(base2k, wadd(wshl(get_digit(k, x[c]), lsh), carry));
    }
}

// ---------------------------------------------------------------------------
// Exact negacyclic convolution with 128-bit accumulation: out = a ⊛ b in
// Z[X]/(X^N+1), returned as (hi, lo) signed-128 pairs (lo unsigned).  The
// caller guarantees Σ |a_i · b_j| < 2^127 (native.negacyclic_mul_exact
// checks it from the inputs' magnitudes).
// ---------------------------------------------------------------------------

void negacyclic_conv_i128(const int64_t* a, const int64_t* b,
                          int64_t* out_hi, uint64_t* out_lo, int64_t n) {
    __int128* acc = new __int128[n];
    for (int64_t i = 0; i < n; ++i) acc[i] = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t ai = a[i];
        if (ai == 0) continue;
        for (int64_t j = 0; j < n; ++j) {
            __int128 prod = (__int128)ai * (__int128)b[j];
            int64_t kidx = i + j;
            if (kidx < n) acc[kidx] += prod;
            else          acc[kidx - n] -= prod;
        }
    }
    for (int64_t i = 0; i < n; ++i) {
        out_lo[i] = (uint64_t)(acc[i] & 0xFFFFFFFFFFFFFFFFu);
        out_hi[i] = (int64_t)(acc[i] >> 64);
    }
    delete[] acc;
}

// rows independent polynomials
void negacyclic_conv_i128_batch(const int64_t* a, const int64_t* b,
                                int64_t* out_hi, uint64_t* out_lo,
                                int64_t rows, int64_t n) {
    for (int64_t r = 0; r < rows; ++r)
        negacyclic_conv_i128(a + r * n, b + r * n,
                             out_hi + r * n, out_lo + r * n, n);
}

// ---------------------------------------------------------------------------
// Negacyclic NTT of one prime (Montgomery R = 2^30, the stage schedule and
// tables of hal/ntt.py: forward Cooley–Tukey with merged psi powers, inverse
// Gentleman–Sande, then N^{-1}).  x: [rows, n] residues in [0, p), in place;
// psi_t / psi_inv_t: that prime's row of hal.ntt._host_tables.
// ---------------------------------------------------------------------------

static inline int64_t mont_mul_p(int64_t a, int64_t b, int64_t p,
                                 int64_t qinv30) {
    const int64_t R_MASK = (1ll << 30) - 1;
    __int128 t = (__int128)a * b;
    int64_t t0 = (int64_t)(t & R_MASK);
    int64_t m = (t0 * qinv30) & R_MASK;
    __int128 u = (t + (__int128)m * p) >> 30;
    int64_t r = (int64_t)u;
    return r >= p ? r - p : r;
}

void ntt_forward_i64(const int64_t* psi_t, int64_t p, int64_t qinv,
                     int64_t* x, int64_t rows, int64_t n) {
    int logn = 0;
    while ((1ll << logn) < n) ++logn;
    for (int64_t r = 0; r < rows; ++r) {
        int64_t* xr = x + r * n;
        for (int s = 0; s < logn; ++s) {
            int64_t m = 1ll << s;
            int64_t half = n >> (s + 1);
            for (int64_t blk = 0; blk < m; ++blk) {
                int64_t w = psi_t[m + blk];
                int64_t* lo = xr + blk * 2 * half;
                int64_t* hi = lo + half;
                for (int64_t i = 0; i < half; ++i) {
                    int64_t v = mont_mul_p(hi[i], w, p, qinv);
                    int64_t u = lo[i];
                    int64_t s1 = u + v;  if (s1 >= p) s1 -= p;
                    int64_t s2 = u - v;  if (s2 < 0)  s2 += p;
                    lo[i] = s1;
                    hi[i] = s2;
                }
            }
        }
    }
}

void ntt_inverse_i64(const int64_t* psi_inv_t, int64_t ninv_mont, int64_t p,
                     int64_t qinv, int64_t* x, int64_t rows, int64_t n) {
    int logn = 0;
    while ((1ll << logn) < n) ++logn;
    for (int64_t r = 0; r < rows; ++r) {
        int64_t* xr = x + r * n;
        for (int s = logn - 1; s >= 0; --s) {
            int64_t m = 1ll << s;
            int64_t half = n >> (s + 1);
            for (int64_t blk = 0; blk < m; ++blk) {
                int64_t w = psi_inv_t[m + blk];
                int64_t* lo = xr + blk * 2 * half;
                int64_t* hi = lo + half;
                for (int64_t i = 0; i < half; ++i) {
                    int64_t u = lo[i], v = hi[i];
                    int64_t s1 = u + v;  if (s1 >= p) s1 -= p;
                    int64_t d = u - v;   if (d < 0)   d += p;  // lo − hi
                    lo[i] = s1;
                    hi[i] = mont_mul_p(d, w, p, qinv);
                }
            }
        }
        for (int64_t i = 0; i < n; ++i)
            xr[i] = mont_mul_p(xr[i], ninv_mont, p, qinv);
    }
}

}  // extern "C"
