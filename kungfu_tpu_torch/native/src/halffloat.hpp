// Scalar f16/bf16 <-> f32 conversions shared by the portable reduce
// kernels (core.cpp) and the SIMD tail loops (simd.cpp). Semantics match
// IEEE half / bfloat16 with round-to-nearest-even narrowing, which is what
// the vector conversions (_mm256_cvtps_ph, bias-rounded bf16 pack) produce,
// so SIMD and scalar paths are bit-identical.
#pragma once

#include <cstdint>
#include <cstring>

namespace kf {

inline float f16_to_f32(uint16_t h) {
    uint32_t sign = uint32_t(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {  // subnormal: normalize
            int shift = 0;
            while (!(man & 0x400)) {
                man <<= 1;
                shift++;
            }
            man &= 0x3FF;
            // subnormal value is man * 2^-24; after normalizing by `shift`
            // the effective exponent is -15 - shift + 1 = -(14 + shift)
            bits = sign | ((127 - 14 - shift) << 23) | (man << 13);
        }
    } else if (exp == 0x1F) {
        bits = sign | 0x7F800000 | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

inline uint16_t f32_to_f16(float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, 4);
    uint16_t sign = uint16_t((bits >> 16) & 0x8000);
    uint32_t fexp = (bits >> 23) & 0xFF;
    uint32_t man = bits & 0x7FFFFF;
    if (fexp == 0xFF)  // inf / nan: quiet the nan, truncate the payload
        // (matches VCVTPS2PH: quiet bit set, top 10 payload bits kept)
        return sign | 0x7C00 | (man ? 0x200 : 0) | uint16_t(man >> 13);
    int32_t exp = int32_t(fexp) - 127 + 15;
    auto round_shift = [](uint32_t v, uint32_t shift) {
        // round-to-nearest-even on the dropped `shift` low bits; a carry
        // out of the mantissa correctly bumps the exponent field
        uint32_t half = 1u << (shift - 1);
        uint32_t rest = v & ((half << 1) - 1);
        uint32_t q = v >> shift;
        if (rest > half || (rest == half && (q & 1))) q++;
        return q;
    };
    if (exp >= 0x1F) return sign | 0x7C00;  // overflow
    if (exp <= 0) {
        if (exp < -10) return sign;  // underflow to zero
        man |= 0x800000;
        return sign | uint16_t(round_shift(man, uint32_t(14 - exp)));
    }
    // normal: drop 13 mantissa bits with RNE; rounding carry propagates
    // from the packed mantissa into the exponent field, which is exactly
    // the IEEE behavior (1.11..1 rounds up to 2.0 = exponent+1)
    uint32_t packed =
        round_shift((uint32_t(exp) << 23) | man, 13);
    if (packed >= 0x7C00) return sign | 0x7C00;  // rounded into overflow
    return sign | uint16_t(packed);
}

inline float bf16_to_f32(uint16_t h) {
    uint32_t bits = uint32_t(h) << 16;
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

inline uint16_t f32_to_bf16(float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, 4);
    if ((bits & 0x7F800000) == 0x7F800000) {
        // inf/nan: truncate; if truncation would zero a nan's mantissa
        // (payload lived in the dropped bits), set the quiet bit so the
        // nan survives instead of decaying to inf — and never let the
        // round-to-nearest bias below carry a nan into ±0
        uint16_t t = uint16_t(bits >> 16);
        if ((bits & 0x7FFFFF) && !(t & 0x7F)) t |= 0x40;
        return t;
    }
    // round-to-nearest-even on the dropped 16 bits
    uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
    return uint16_t((bits + rounding) >> 16);
}

}  // namespace kf
