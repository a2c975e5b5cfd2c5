// Vectorized reduce kernels with runtime CPU dispatch.
//
// The reference accelerates f16 reduction with AVX/F16C intrinsics
// (reference: srcs/go/kungfu/base/f16.c:17-50) and relies on templated
// vectorizable transforms for the other dtypes (op.cpp:24-53). Here the
// hot dtypes (f16, bf16, f32, f64) get explicit AVX2/F16C/FMA kernels,
// selected at runtime via __builtin_cpu_supports so the library still runs
// on baseline x86-64 (and non-x86, where this file compiles to the
// "not handled" stub). bf16 matters more than in the reference: it is the
// native TPU dtype, so fused-model DCN transfers are usually bf16.
//
// SIMD and scalar paths are bit-identical: 16-bit floats widen to f32,
// reduce, and narrow with round-to-nearest-even on both paths
// (halffloat.hpp documents the pairing).

#include "core.hpp"
#include "halffloat.hpp"

#if defined(__x86_64__) || defined(__i386__)
#define KF_X86 1
#include <cpuid.h>
#include <immintrin.h>
#endif

namespace kf {

#if KF_X86

namespace {

// Raw CPUID instead of __builtin_cpu_supports: GCC < 11 has no "f16c"
// feature name, and the probe must compile on every toolchain that can
// build the rest of this file.
bool cpu_has_avx2_f16c() {
    static const bool ok = [] {
        if (std::getenv("KF_NO_SIMD")) return false;
        unsigned a, b, c, d;
        if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
        const bool f16c = (c >> 29) & 1;     // CPUID.1:ECX.F16C
        const bool osxsave = (c >> 27) & 1;  // OS saves YMM state?
        if (!f16c || !osxsave) return false;
        unsigned xlo, xhi;  // xgetbv via asm: _xgetbv needs -mxsave
        __asm__ volatile("xgetbv" : "=a"(xlo), "=d"(xhi) : "c"(0));
        if ((xlo & 0x6) != 0x6) return false;  // XMM+YMM enabled
        unsigned a7, b7, c7, d7;
        if (!__get_cpuid_count(7, 0, &a7, &b7, &c7, &d7)) return false;
        return ((b7 >> 5) & 1) != 0;         // CPUID.7.0:EBX.AVX2
    }();
    return ok;
}

// Operand order carries the select semantics: the scalar kernels compute
// `src (cmp) dst ? src : dst`, and VMINPS/VMAXPS return the SECOND operand
// on equal/unordered — so calling op(src, dst) reproduces the scalar
// result bit-for-bit, including NaN propagation and ±0 ties. The macros
// below therefore pass (b, a) = (src, dst) for min/max.
#define KF_VMIN_PS(a, b) _mm256_min_ps(b, a)
#define KF_VMAX_PS(a, b) _mm256_max_ps(b, a)
#define KF_VMIN_PD(a, b) _mm256_min_pd(b, a)
#define KF_VMAX_PD(a, b) _mm256_max_pd(b, a)

// ------------------------------------------------------------------- f16
// 8 halves per iteration: widen to f32 (F16C), op, narrow with RNE.

#define KF_F16_KERNEL(NAME, VOP, SOP)                                        \
    __attribute__((target("avx2,f16c"))) void NAME(                          \
        uint16_t *d, const uint16_t *s, int64_t n) {                         \
        int64_t i = 0;                                                       \
        for (; i + 8 <= n; i += 8) {                                         \
            __m256 a =                                                       \
                _mm256_cvtph_ps(_mm_loadu_si128((const __m128i *)(d + i)));  \
            __m256 b =                                                       \
                _mm256_cvtph_ps(_mm_loadu_si128((const __m128i *)(s + i)));  \
            __m256 r = VOP(a, b);                                            \
            _mm_storeu_si128((__m128i *)(d + i),                             \
                             _mm256_cvtps_ph(r, _MM_FROUND_TO_NEAREST_INT)); \
        }                                                                    \
        for (; i < n; i++) {                                                 \
            float a = f16_to_f32(d[i]), b = f16_to_f32(s[i]);                \
            d[i] = f32_to_f16(SOP);                                          \
        }                                                                    \
    }

KF_F16_KERNEL(f16_sum, _mm256_add_ps, a + b)
KF_F16_KERNEL(f16_min, KF_VMIN_PS, b < a ? b : a)
KF_F16_KERNEL(f16_max, KF_VMAX_PS, b > a ? b : a)
KF_F16_KERNEL(f16_prod, _mm256_mul_ps, a *b)
#undef KF_F16_KERNEL

// ------------------------------------------------------------------ bf16
// widen: u16 -> u32 << 16 reinterpreted as f32. narrow: RNE bias add then
// take the high 16 bits (same formula as the scalar f32_to_bf16).

__attribute__((target("avx2"))) inline __m256 bf16_widen(const uint16_t *p) {
    __m128i h = _mm_loadu_si128((const __m128i *)p);
    __m256i w = _mm256_slli_epi32(_mm256_cvtepu16_epi32(h), 16);
    return _mm256_castsi256_ps(w);
}

__attribute__((target("avx2"))) inline void bf16_narrow(uint16_t *p,
                                                        __m256 v) {
    __m256i bits = _mm256_castps_si256(v);
    __m256i lsb = _mm256_and_si256(_mm256_srli_epi32(bits, 16),
                                   _mm256_set1_epi32(1));
    __m256i bias = _mm256_add_epi32(lsb, _mm256_set1_epi32(0x7FFF));
    __m256i r = _mm256_srli_epi32(_mm256_add_epi32(bits, bias), 16);
    // inf/nan lanes bypass the bias add (which could carry a large-payload
    // nan through the sign bit into ±0): truncate, and quiet a nan whose
    // payload lived entirely in the dropped bits — same as the scalar
    // f32_to_bf16 special case
    __m256i expf = _mm256_set1_epi32(0x7F800000);
    __m256i naninf = _mm256_cmpeq_epi32(_mm256_and_si256(bits, expf), expf);
    __m256i t = _mm256_srli_epi32(bits, 16);
    __m256i man_nz = _mm256_andnot_si256(
        _mm256_cmpeq_epi32(_mm256_and_si256(bits, _mm256_set1_epi32(0x7FFFFF)),
                           _mm256_setzero_si256()),
        _mm256_set1_epi32(-1));
    __m256i tman_z = _mm256_cmpeq_epi32(
        _mm256_and_si256(t, _mm256_set1_epi32(0x7F)), _mm256_setzero_si256());
    __m256i quiet = _mm256_and_si256(_mm256_and_si256(man_nz, tman_z),
                                     _mm256_set1_epi32(0x40));
    t = _mm256_or_si256(t, quiet);
    r = _mm256_blendv_epi8(r, t, naninf);
    // pack 8x u32 -> 8x u16: packus works per 128-bit lane, so fix lane
    // order afterwards ([a0..3 a0..3 | a4..7 a4..7] -> low128 = a0..7)
    __m256i packed = _mm256_packus_epi32(r, r);
    __m256i fixed = _mm256_permute4x64_epi64(packed, 0x08);
    _mm_storeu_si128((__m128i *)p, _mm256_castsi256_si128(fixed));
}

#define KF_BF16_KERNEL(NAME, VOP, SOP)                              \
    __attribute__((target("avx2"))) void NAME(                      \
        uint16_t *d, const uint16_t *s, int64_t n) {                \
        int64_t i = 0;                                              \
        for (; i + 8 <= n; i += 8) {                                \
            __m256 a = bf16_widen(d + i);                           \
            __m256 b = bf16_widen(s + i);                           \
            bf16_narrow(d + i, VOP(a, b));                          \
        }                                                           \
        for (; i < n; i++) {                                        \
            float a = bf16_to_f32(d[i]), b = bf16_to_f32(s[i]);     \
            d[i] = f32_to_bf16(SOP);                                \
        }                                                           \
    }

KF_BF16_KERNEL(bf16_sum, _mm256_add_ps, a + b)
KF_BF16_KERNEL(bf16_min, KF_VMIN_PS, b < a ? b : a)
KF_BF16_KERNEL(bf16_max, KF_VMAX_PS, b > a ? b : a)
KF_BF16_KERNEL(bf16_prod, _mm256_mul_ps, a *b)
#undef KF_BF16_KERNEL

// -------------------------------------------------------------- i8 sat
// Saturating int8 accumulate — the compressed-gradient wire kernel
// (VPADDSB clamps at ±127 exactly like the scalar sat_add path).

__attribute__((target("avx2"))) void i8_sum_sat(int8_t *d, const int8_t *s,
                                                int64_t n) {
    int64_t i = 0;
    for (; i + 32 <= n; i += 32) {
        __m256i a = _mm256_loadu_si256((const __m256i *)(d + i));
        __m256i b = _mm256_loadu_si256((const __m256i *)(s + i));
        _mm256_storeu_si256((__m256i *)(d + i), _mm256_adds_epi8(a, b));
    }
    for (; i < n; i++) {
        int v = int(d[i]) + int(s[i]);
        d[i] = int8_t(v > 127 ? 127 : (v < -128 ? -128 : v));
    }
}

// ------------------------------------------------------------- f32 / f64

#define KF_F32_KERNEL(NAME, VOP, SOP)                                       \
    __attribute__((target("avx2"))) void NAME(float *d, const float *s,     \
                                              int64_t n) {                  \
        int64_t i = 0;                                                      \
        for (; i + 8 <= n; i += 8) {                                        \
            __m256 a = _mm256_loadu_ps(d + i);                              \
            __m256 b = _mm256_loadu_ps(s + i);                              \
            _mm256_storeu_ps(d + i, VOP(a, b));                             \
        }                                                                   \
        for (; i < n; i++) {                                                \
            float a = d[i], b = s[i];                                       \
            d[i] = SOP;                                                     \
        }                                                                   \
    }

KF_F32_KERNEL(f32_sum, _mm256_add_ps, a + b)
KF_F32_KERNEL(f32_min, KF_VMIN_PS, b < a ? b : a)
KF_F32_KERNEL(f32_max, KF_VMAX_PS, b > a ? b : a)
KF_F32_KERNEL(f32_prod, _mm256_mul_ps, a *b)
#undef KF_F32_KERNEL

#define KF_F64_KERNEL(NAME, VOP, SOP)                                       \
    __attribute__((target("avx2"))) void NAME(double *d, const double *s,   \
                                              int64_t n) {                  \
        int64_t i = 0;                                                      \
        for (; i + 4 <= n; i += 4) {                                        \
            __m256d a = _mm256_loadu_pd(d + i);                             \
            __m256d b = _mm256_loadu_pd(s + i);                             \
            _mm256_storeu_pd(d + i, VOP(a, b));                             \
        }                                                                   \
        for (; i < n; i++) {                                                \
            double a = d[i], b = s[i];                                      \
            d[i] = SOP;                                                     \
        }                                                                   \
    }

KF_F64_KERNEL(f64_sum, _mm256_add_pd, a + b)
KF_F64_KERNEL(f64_min, KF_VMIN_PD, b < a ? b : a)
KF_F64_KERNEL(f64_max, KF_VMAX_PD, b > a ? b : a)
KF_F64_KERNEL(f64_prod, _mm256_mul_pd, a *b)
#undef KF_F64_KERNEL

}  // namespace

bool reduce_accumulate_simd(void *dst, const void *src, int64_t count,
                            Dtype dt, ROp op) {
    if (!cpu_has_avx2_f16c()) return false;
    switch (dt) {
        case Dtype::i8: {
            if (op != ROp::sum_sat) return false;  // others: portable loop
            i8_sum_sat((int8_t *)dst, (const int8_t *)src, count);
            return true;
        }
        case Dtype::f16: {
            auto *d = (uint16_t *)dst;
            auto *s = (const uint16_t *)src;
            switch (op) {
                case ROp::sum:
                case ROp::sum_sat: f16_sum(d, s, count); return true;
                case ROp::min: f16_min(d, s, count); return true;
                case ROp::max: f16_max(d, s, count); return true;
                case ROp::prod: f16_prod(d, s, count); return true;
            }
            return false;
        }
        case Dtype::bf16: {
            auto *d = (uint16_t *)dst;
            auto *s = (const uint16_t *)src;
            switch (op) {
                case ROp::sum:
                case ROp::sum_sat: bf16_sum(d, s, count); return true;
                case ROp::min: bf16_min(d, s, count); return true;
                case ROp::max: bf16_max(d, s, count); return true;
                case ROp::prod: bf16_prod(d, s, count); return true;
            }
            return false;
        }
        case Dtype::f32: {
            auto *d = (float *)dst;
            auto *s = (const float *)src;
            switch (op) {
                case ROp::sum:
                case ROp::sum_sat: f32_sum(d, s, count); return true;
                case ROp::min: f32_min(d, s, count); return true;
                case ROp::max: f32_max(d, s, count); return true;
                case ROp::prod: f32_prod(d, s, count); return true;
            }
            return false;
        }
        case Dtype::f64: {
            auto *d = (double *)dst;
            auto *s = (const double *)src;
            switch (op) {
                case ROp::sum:
                case ROp::sum_sat: f64_sum(d, s, count); return true;
                case ROp::min: f64_min(d, s, count); return true;
                case ROp::max: f64_max(d, s, count); return true;
                case ROp::prod: f64_prod(d, s, count); return true;
            }
            return false;
        }
        default:
            return false;  // integer dtypes: the portable loop is fine
    }
}

#else  // !KF_X86

bool reduce_accumulate_simd(void *, const void *, int64_t, Dtype, ROp) {
    return false;
}

#endif

}  // namespace kf
