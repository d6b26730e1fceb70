// XLA FFI custom-call kernels: batched prime-field arithmetic (CPU).
//
// This is the native CPU execution path for fields/fr.py.  On the GPU the
// field ops are pure-JAX limb arithmetic (fused by XLA); on the CPU
// backend every mul/add/sub/inv lowers to ONE custom-call instruction
// backed by 64-bit-limb Montgomery arithmetic here.  Motivation is both
// speed (u64 CIOS with __int128 carries vs. emulated 16-bit limbs in
// u32 lanes) and XLA:CPU compile time: protocol graphs contain tens of
// thousands of field ops, and emitting a scan body per call site made
// even tiny provers multi-GB compiles.  (The reference's equivalent
// layer is arkworks' Rust bigint arithmetic; this file re-implements
// standard CIOS — see e.g. dist-primitive/Cargo.toml:18-24 for the
// reference's use of ark-ff.)
//
// Performance structure: every field helper is templated on the word
// count NW (NW = 0 keeps the runtime-width generic body).  The moduli
// in use are 4 words (Fr, 255 bits) and 6 words (Fq, 381 bits); fixed
// widths let the compiler fully unroll the CIOS and carry chains —
// ~2x over the runtime-width loops.  Point adds additionally take the
// MIXED (Z2 == 1) fast path per operand: SRS bases are pre-normalized
// to affine, so the Pippenger bucket pass runs 8M+3S madd instead of
// 11M+5S full Jacobian adds.
//
// Data layout across the boundary: uint32 arrays [..., L] of 16-bit
// limbs, little-endian, Montgomery form with R = 2^(16 L) — identical
// to the device layout, repacked to 64-bit words (L = 4 nw) in-kernel.
//
// Field parameters are registered at load time via sczk_field_init
// (moduli come from fields/config.py — single source of truth).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__AVX512IFMA__)
#include <immintrin.h>
#define SCZK_HAVE_IFMA 1
#endif

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

using u64 = uint64_t;
using u128 = unsigned __int128;

namespace {

constexpr int MAXW = 8;       // up to 512-bit fields
constexpr int MAX_FIELDS = 8;

struct FieldP {
  int fid = -1;          // registry slot (keys the radix-52 twin g_f52)
  int nw = 0;            // number of 64-bit words
  u64 p[MAXW] = {0};     // modulus
  u64 e[MAXW] = {0};     // p - 2 (Fermat exponent)
  u64 n0inv = 0;         // -p^{-1} mod 2^64
  u64 one_m[MAXW] = {0}; // R mod p (1 in Montgomery form)
  u64 r3[MAXW] = {0};    // R^3 mod p (EGCD-inverse Montgomery fixup)
};

FieldP g_fields[MAX_FIELDS];

// ---------------------------------------------------------------------
// Optional per-op profiling (SCZK_FFI_PROF=1): wall time + call + element
// counts per op class, dumped to stderr at process exit.  The XLA:CPU
// profiler shows custom calls only as anonymous `ffi_call.N` events; this
// is the attribution layer under it.
// ---------------------------------------------------------------------
enum ProfOp { P_MUL, P_ADD, P_SUB, P_INV, P_MSM, P_SMUL, P_SUM, P_LMAP, P_N };
const char *kProfNames[P_N] = {"fr.mul",  "fr.add", "fr.sub",    "fr.inv",
                               "g1.msm",  "g1.smul", "g1.sum",   "g1.lmap"};
struct ProfSlot {
  std::atomic<uint64_t> ns{0}, calls{0}, elems{0};
};
ProfSlot g_prof[P_N];
bool g_prof_on = [] { return std::getenv("SCZK_FFI_PROF") != nullptr; }();

struct ProfDump {
  ~ProfDump() {
    if (!g_prof_on) return;
    std::fprintf(stderr, "# SCZK_FFI_PROF (op: seconds / calls / elems)\n");
    for (int i = 0; i < P_N; i++) {
      uint64_t ns = g_prof[i].ns.load();
      if (!ns) continue;
      std::fprintf(stderr, "#   %-8s %9.3fs  calls=%-8llu elems=%llu\n",
                   kProfNames[i], ns / 1e9,
                   (unsigned long long)g_prof[i].calls.load(),
                   (unsigned long long)g_prof[i].elems.load());
    }
  }
} g_prof_dump;

struct ProfScope {
  ProfOp op;
  uint64_t elems;
  std::chrono::steady_clock::time_point t0;
  ProfScope(ProfOp o, uint64_t e) : op(o), elems(e) {
    if (g_prof_on) t0 = std::chrono::steady_clock::now();
  }
  ~ProfScope() {
    if (!g_prof_on) return;
    auto dt = std::chrono::steady_clock::now() - t0;
    g_prof[op].ns.fetch_add(
        std::chrono::duration_cast<std::chrono::nanoseconds>(dt).count());
    g_prof[op].calls.fetch_add(1);
    g_prof[op].elems.fetch_add(elems);
  }
};

// NW = 0 -> runtime width from the field params; NW > 0 -> compile-time
// constant (loops unroll, carries stay in registers).
template <int NW> inline int fw(const FieldP &f) { return NW ? NW : f.nw; }

template <int NW> inline bool geq_p_t(const FieldP &f, const u64 *a) {
  for (int i = fw<NW>(f) - 1; i >= 0; i--) {
    if (a[i] > f.p[i]) return true;
    if (a[i] < f.p[i]) return false;
  }
  return true;
}

template <int NW> inline void sub_p_t(const FieldP &f, u64 *a) {
  u128 borrow = 0;
  for (int i = 0; i < fw<NW>(f); i++) {
    u128 d = (u128)a[i] - f.p[i] - borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

template <int NW>
inline void add_mod_t(const FieldP &f, const u64 *a, const u64 *b, u64 *r) {
  u128 carry = 0;
  for (int i = 0; i < fw<NW>(f); i++) {
    u128 s = (u128)a[i] + b[i] + carry;
    r[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || geq_p_t<NW>(f, r)) sub_p_t<NW>(f, r);
}

template <int NW>
inline void sub_mod_t(const FieldP &f, const u64 *a, const u64 *b, u64 *r) {
  u128 borrow = 0;
  for (int i = 0; i < fw<NW>(f); i++) {
    u128 d = (u128)a[i] - b[i] - borrow;
    r[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < fw<NW>(f); i++) {
      u128 s = (u128)r[i] + f.p[i] + carry;
      r[i] = (u64)s;
      carry = s >> 64;
    }
  }
}

// Montgomery CIOS multiply (same schedule as bls12_381.cc:fq_mul,
// generalized over the word count).
template <int NW>
inline void mont_mul_t(const FieldP &f, const u64 *a, const u64 *b, u64 *out) {
  const int nw = fw<NW>(f);
  u64 t[MAXW + 2] = {0};
  for (int i = 0; i < nw; i++) {
    u128 carry = 0;
    for (int j = 0; j < nw; j++) {
      u128 s = (u128)t[j] + (u128)a[i] * b[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[nw] + carry;
    t[nw] = (u64)s;
    t[nw + 1] = (u64)(s >> 64);
    u64 m = t[0] * f.n0inv;
    carry = ((u128)t[0] + (u128)m * f.p[0]) >> 64;
    for (int j = 1; j < nw; j++) {
      u128 s2 = (u128)t[j] + (u128)m * f.p[j] + carry;
      t[j - 1] = (u64)s2;
      carry = s2 >> 64;
    }
    s = (u128)t[nw] + carry;
    t[nw - 1] = (u64)s;
    t[nw] = t[nw + 1] + (u64)(s >> 64);
    t[nw + 1] = 0;
  }
  std::memcpy(out, t, nw * sizeof(u64));
  if (t[nw] || geq_p_t<NW>(f, out)) sub_p_t<NW>(f, out);
}

// Runtime-width entry points (init code, pow, element loops pick their
// own width template at the call boundary).
inline void add_mod(const FieldP &f, const u64 *a, const u64 *b, u64 *r) {
  add_mod_t<0>(f, a, b, r);
}
inline void mont_mul(const FieldP &f, const u64 *a, const u64 *b, u64 *out) {
  switch (f.nw) {
    case 4: mont_mul_t<4>(f, a, b, out); return;
    case 6: mont_mul_t<6>(f, a, b, out); return;
    default: mont_mul_t<0>(f, a, b, out); return;
  }
}

inline bool words_zero(const u64 *a, int nw) {
  u64 o = 0;
  for (int i = 0; i < nw; i++) o |= a[i];
  return o == 0;
}

inline bool words_eq(const u64 *a, const u64 *b, int nw) {
  u64 o = 0;
  for (int i = 0; i < nw; i++) o |= a[i] ^ b[i];
  return o == 0;
}

inline bool words_is_one(const u64 *a, int nw) {
  if (a[0] != 1) return false;
  for (int i = 1; i < nw; i++)
    if (a[i]) return false;
  return true;
}

inline bool words_geq(const u64 *a, const u64 *b, int nw) {
  for (int i = nw - 1; i >= 0; i--) {
    if (a[i] > b[i]) return true;
    if (a[i] < b[i]) return false;
  }
  return true;
}

// Montgomery inversion via binary extended GCD: ~10x faster than the
// Fermat pow (381 shift/sub halvings vs ~770 full Montgomery muls).
// Requires p < 2^(64 nw - 1) (holds for Fr 255/256 and Fq 381/384) so
// the conditional +p in the halving fits one carry bit.  0 -> 0.
// raw binary-EGCD inverse: out = a^{-1} mod p for a plain number a
// (no Montgomery domain fixup); 0 -> 0.
inline void egcd_inv_raw(const FieldP &f, const u64 *a, u64 *out) {
  const int nw = f.nw;
  if (words_zero(a, nw)) {
    std::memset(out, 0, nw * sizeof(u64));
    return;
  }
  u64 u[MAXW], v[MAXW], x1[MAXW] = {0}, x2[MAXW] = {0};
  std::memcpy(u, a, nw * sizeof(u64));
  std::memcpy(v, f.p, nw * sizeof(u64));
  x1[0] = 1;
  auto half_mod = [&](u64 *x) {
    u64 carry = 0;
    if (x[0] & 1) {
      u128 c = 0;
      for (int i = 0; i < nw; i++) {
        u128 s = (u128)x[i] + f.p[i] + c;
        x[i] = (u64)s;
        c = s >> 64;
      }
      carry = (u64)c;
    }
    for (int i = 0; i < nw - 1; i++) x[i] = (x[i] >> 1) | (x[i + 1] << 63);
    x[nw - 1] = (x[nw - 1] >> 1) | (carry << 63);
  };
  auto sub_raw = [&](u64 *a, const u64 *b) {
    u128 borrow = 0;
    for (int i = 0; i < nw; i++) {
      u128 d = (u128)a[i] - b[i] - borrow;
      a[i] = (u64)d;
      borrow = (d >> 64) & 1;
    }
  };
  while (!words_is_one(u, nw) && !words_is_one(v, nw)) {
    while (!(u[0] & 1)) {
      for (int i = 0; i < nw - 1; i++) u[i] = (u[i] >> 1) | (u[i + 1] << 63);
      u[nw - 1] >>= 1;
      half_mod(x1);
    }
    while (!(v[0] & 1)) {
      for (int i = 0; i < nw - 1; i++) v[i] = (v[i] >> 1) | (v[i + 1] << 63);
      v[nw - 1] >>= 1;
      half_mod(x2);
    }
    if (words_geq(u, v, nw)) {
      sub_raw(u, v);
      sub_mod_t<0>(f, x1, x2, x1);
    } else {
      sub_raw(v, u);
      sub_mod_t<0>(f, x2, x1, x2);
    }
  }
  const u64 *r = words_is_one(u, nw) ? x1 : x2;
  std::memcpy(out, r, nw * sizeof(u64));
}

// Montgomery-domain inverse: a_hat = aR -> a^{-1} R (0 -> 0).
inline void mont_inv_one(const FieldP &f, const u64 *a_hat, u64 *out) {
  u64 r[MAXW];
  egcd_inv_raw(f, a_hat, r);
  // r = (aR)^{-1} = a^{-1} R^{-1}; out = r * R^3 * R^{-1} = a^{-1} R
  mont_mul(f, r, f.r3, out);
}

// Montgomery square-and-multiply: given a-hat = a R, returns a^e R.
inline void mont_pow(const FieldP &f, const u64 *a, const u64 *e, u64 *out) {
  u64 result[MAXW], base[MAXW];
  std::memcpy(result, f.one_m, sizeof(result));
  std::memcpy(base, a, f.nw * sizeof(u64));
  for (int w = 0; w < f.nw; w++) {
    for (int b = 0; b < 64; b++) {
      if ((e[w] >> b) & 1) mont_mul(f, result, base, result);
      // square unconditionally (cheap relative to branch complexity)
      mont_mul(f, base, base, base);
    }
  }
  std::memcpy(out, result, f.nw * sizeof(u64));
}

// ---------------------------------------------------------------------
// Radix-52 field arithmetic for the AVX512IFMA path.  vpmadd52{lo,hi}
// give 8 independent 52x52+64 multiply-accumulates per instruction —
// a full 8-lane 381-bit Montgomery multiply lands at ~6.5 ns/mul vs
// ~88 ns scalar (native/bench_kernels.cc) — so every data-parallel
// section of the MSM (bucket adds, batch inversions, domain
// conversions) runs 8 lanes wide in radix 52.
//
// Domain note: the radix-52 CIOS uses R52 = 2^(52 NL) (NL = number of
// 52-bit limbs) while the rest of the library uses R64 = 2^(64 nw).
// Values entering the IFMA region are converted x*R64 -> x*R52 by one
// Montgomery multiply with c_to52 = R52^2/R64, and leave via one
// multiply with one64_52 = R64 (both precomputed at field init).
// ---------------------------------------------------------------------
constexpr int MAXL52 = 11;  // up to 8x64 = 512 bits -> 10 limbs
constexpr u64 MASK52 = (1ULL << 52) - 1;

struct F52 {
  int nl = 0;           // limb count = ceil(64 nw / 52)
  u64 p52[MAXL52] = {0};
  u64 n0inv52 = 0;      // -p^{-1} mod 2^52
  u64 one52[MAXL52] = {0};    // R52 mod p      ("1" of the R52 domain)
  u64 c_to52[MAXL52] = {0};   // R52^2 / R64 mod p
  u64 one64_52[MAXL52] = {0}; // R64 mod p      (back-conversion factor)
  u64 r52fix[MAXL52] = {0};   // R52^3 mod p    (EGCD-inverse fixup)
};

F52 g_f52[MAX_FIELDS];

// radix-64 words [nw] -> radix-52 limbs [nl] (generic bit repack)
inline void to52(const u64 *a, int nw, int nl, u64 *o) {
  for (int i = 0; i < nl; i++) {
    const int bit = 52 * i;
    const int w = bit / 64, off = bit % 64;
    u64 v = (w < nw) ? (a[w] >> off) : 0;
    if (off > 12 && w + 1 < nw) v |= a[w + 1] << (64 - off);
    o[i] = v & MASK52;
  }
}

inline void from52(const u64 *a, int nl, int nw, u64 *o) {
  for (int w = 0; w < nw; w++) o[w] = 0;
  for (int i = 0; i < nl; i++) {
    const int bit = 52 * i;
    const int w = bit / 64, off = bit % 64;
    o[w] |= a[i] << off;
    if (off > 12 && w + 1 < nw) o[w + 1] |= a[i] >> (64 - off);
  }
}

inline bool geq52(const u64 *a, const u64 *b, int nl) {
  for (int i = nl - 1; i >= 0; i--) {
    if (a[i] > b[i]) return true;
    if (a[i] < b[i]) return false;
  }
  return true;
}

inline void add52_s(const F52 &f, const u64 *a, const u64 *b, u64 *r) {
  u64 carry = 0;
  for (int i = 0; i < f.nl; i++) {
    u64 s = a[i] + b[i] + carry;
    r[i] = s & MASK52;
    carry = s >> 52;
  }
  if (geq52(r, f.p52, f.nl)) {
    u64 borrow = 0;
    for (int i = 0; i < f.nl; i++) {
      u64 d = r[i] - f.p52[i] - borrow;
      borrow = (d >> 63) & 1;
      r[i] = d & MASK52;
    }
  }
}

inline void sub52_s(const F52 &f, const u64 *a, const u64 *b, u64 *r) {
  u64 borrow = 0;
  for (int i = 0; i < f.nl; i++) {
    u64 d = a[i] - b[i] - borrow;
    borrow = (d >> 63) & 1;
    r[i] = d & MASK52;
  }
  if (borrow) {
    u64 carry = 0;
    for (int i = 0; i < f.nl; i++) {
      u64 s = r[i] + f.p52[i] + carry;
      r[i] = s & MASK52;
      carry = s >> 52;
    }
  }
}

// scalar radix-52 Montgomery multiply (CIOS), for glue paths (stripe
// combines, doubling jobs, domain conversions in the reduce)
inline void mont_mul52_s(const F52 &f, const u64 *a, const u64 *b, u64 *out) {
  const int nl = f.nl;
  u64 t[MAXL52 + 1] = {0};
  for (int i = 0; i < nl; i++) {
    u64 carry = 0;
    for (int j = 0; j < nl; j++) {
      u128 pr = (u128)a[i] * b[j] + t[j] + carry;
      t[j] = (u64)pr & MASK52;
      carry = (u64)(pr >> 52);
    }
    t[nl] += carry;
    const u64 m = (t[0] * f.n0inv52) & MASK52;
    carry = (u64)(((u128)m * f.p52[0] + t[0]) >> 52);
    for (int j = 1; j < nl; j++) {
      u128 pr = (u128)m * f.p52[j] + t[j] + carry;
      t[j - 1] = (u64)pr & MASK52;
      carry = (u64)(pr >> 52);
    }
    t[nl - 1] = t[nl] + carry;
    t[nl] = 0;
  }
  if (geq52(t, f.p52, nl)) {
    u64 borrow = 0;
    for (int i = 0; i < nl; i++) {
      u64 d = t[i] - f.p52[i] - borrow;
      borrow = (d >> 63) & 1;
      out[i] = d & MASK52;
    }
  } else {
    std::memcpy(out, t, nl * sizeof(u64));
  }
}

#ifdef SCZK_HAVE_IFMA
// SoA block of 8 lanes; l[i] holds limb i of 8 independent elements.
template <int NL>
struct V8 {
  __m512i l[NL];
};

// 8-lane radix-52 Montgomery multiply (inputs/outputs reduced < p)
template <int NL>
inline void mm8_mul(const F52 &f, const V8<NL> &A, const V8<NL> &B,
                    V8<NL> &O) {
  const __m512i zero = _mm512_setzero_si512();
  const __m512i n0 = _mm512_set1_epi64(f.n0inv52);
  __m512i p[NL];
  for (int i = 0; i < NL; i++) p[i] = _mm512_set1_epi64(f.p52[i]);
  __m512i acc[NL + 1];
  for (int i = 0; i <= NL; i++) acc[i] = zero;
  for (int i = 0; i < NL; i++) {
    const __m512i ai = A.l[i];
    for (int j = 0; j < NL; j++) {
      acc[j] = _mm512_madd52lo_epu64(acc[j], ai, B.l[j]);
      acc[j + 1] = _mm512_madd52hi_epu64(acc[j + 1], ai, B.l[j]);
    }
    const __m512i m = _mm512_madd52lo_epu64(zero, acc[0], n0);
    for (int j = 0; j < NL; j++) {
      acc[j] = _mm512_madd52lo_epu64(acc[j], m, p[j]);
      acc[j + 1] = _mm512_madd52hi_epu64(acc[j + 1], m, p[j]);
    }
    acc[1] = _mm512_add_epi64(acc[1], _mm512_srli_epi64(acc[0], 52));
    for (int j = 0; j < NL; j++) acc[j] = acc[j + 1];
    acc[NL] = zero;
  }
  const __m512i mask = _mm512_set1_epi64(MASK52);
  for (int j = 0; j < NL - 1; j++) {
    acc[j + 1] = _mm512_add_epi64(acc[j + 1], _mm512_srli_epi64(acc[j], 52));
    acc[j] = _mm512_and_epi64(acc[j], mask);
  }
  __m512i d[NL];
  __mmask8 borrow = 0;
  for (int j = 0; j < NL; j++) {
    __m512i bin = _mm512_maskz_set1_epi64(borrow, 1);
    __m512i bj = _mm512_sub_epi64(_mm512_sub_epi64(acc[j], p[j]), bin);
    borrow = _mm512_cmplt_epu64_mask(acc[j], _mm512_add_epi64(p[j], bin));
    d[j] = _mm512_and_epi64(bj, mask);
  }
  for (int j = 0; j < NL; j++)
    O.l[j] = _mm512_mask_blend_epi64(borrow, d[j], acc[j]);
}

// 8-lane modular subtract (lanes of mask `negout` additionally produce
// p - (a - b), i.e. the negated difference — used for signed points)
template <int NL>
inline void mm8_sub(const F52 &f, const V8<NL> &A, const V8<NL> &B,
                    V8<NL> &O) {
  const __m512i mask = _mm512_set1_epi64(MASK52);
  __m512i p[NL];
  for (int i = 0; i < NL; i++) p[i] = _mm512_set1_epi64(f.p52[i]);
  __m512i d[NL];
  __mmask8 borrow = 0;
  for (int j = 0; j < NL; j++) {
    __m512i bin = _mm512_maskz_set1_epi64(borrow, 1);
    d[j] = _mm512_sub_epi64(_mm512_sub_epi64(A.l[j], B.l[j]), bin);
    borrow = _mm512_cmplt_epu64_mask(A.l[j], _mm512_add_epi64(B.l[j], bin));
    d[j] = _mm512_and_epi64(d[j], mask);
  }
  // lanes with borrow: add p back
  __mmask8 carry = 0;
  for (int j = 0; j < NL; j++) {
    __m512i cin = _mm512_maskz_set1_epi64(carry, 1);
    __m512i s =
        _mm512_add_epi64(_mm512_add_epi64(d[j], _mm512_maskz_mov_epi64(borrow, p[j])), cin);
    carry = _kand_mask8(borrow, _mm512_cmpgt_epu64_mask(
                                    _mm512_srli_epi64(s, 52), _mm512_setzero_si512()));
    O.l[j] = _mm512_and_epi64(s, mask);
  }
}

// 8-lane modular add
template <int NL>
inline void mm8_add(const F52 &f, const V8<NL> &A, const V8<NL> &B,
                    V8<NL> &O) {
  const __m512i mask = _mm512_set1_epi64(MASK52);
  __m512i s[NL];
  __m512i carry = _mm512_setzero_si512();
  for (int j = 0; j < NL; j++) {
    __m512i t = _mm512_add_epi64(_mm512_add_epi64(A.l[j], B.l[j]), carry);
    carry = _mm512_srli_epi64(t, 52);
    s[j] = _mm512_and_epi64(t, mask);
  }
  // conditional subtract p where s >= p
  __m512i d[NL];
  __mmask8 borrow = 0;
  for (int j = 0; j < NL; j++) {
    const __m512i pj = _mm512_set1_epi64(f.p52[j]);
    __m512i bin = _mm512_maskz_set1_epi64(borrow, 1);
    d[j] = _mm512_and_epi64(
        _mm512_sub_epi64(_mm512_sub_epi64(s[j], pj), bin), mask);
    borrow = _mm512_cmplt_epu64_mask(s[j], _mm512_add_epi64(pj, bin));
  }
  for (int j = 0; j < NL; j++)
    O.l[j] = _mm512_mask_blend_epi64(borrow, d[j], s[j]);
}

// conditional negate: lanes in `m` become p - a (a != 0 assumed; curve
// y-coordinates are never 0 on BLS12-381)
template <int NL>
inline void mm8_neg_masked(const F52 &f, V8<NL> &A, __mmask8 m) {
  if (!m) return;
  const __m512i mask = _mm512_set1_epi64(MASK52);
  __mmask8 borrow = 0;
  for (int j = 0; j < NL; j++) {
    const __m512i pj = _mm512_set1_epi64(f.p52[j]);
    __m512i bin = _mm512_maskz_set1_epi64(borrow, 1);
    __m512i d = _mm512_sub_epi64(_mm512_sub_epi64(pj, A.l[j]), bin);
    borrow = _mm512_cmplt_epu64_mask(pj, _mm512_add_epi64(A.l[j], bin));
    A.l[j] = _mm512_mask_and_epi64(A.l[j], m, d, mask);
  }
}

// 8x8 u64 in-register transpose (24 shuffles)
inline void transpose8x8(const __m512i r[8], __m512i o[8]) {
  __m512i t[8], u[8];
  t[0] = _mm512_unpacklo_epi64(r[0], r[1]);
  t[1] = _mm512_unpackhi_epi64(r[0], r[1]);
  t[2] = _mm512_unpacklo_epi64(r[2], r[3]);
  t[3] = _mm512_unpackhi_epi64(r[2], r[3]);
  t[4] = _mm512_unpacklo_epi64(r[4], r[5]);
  t[5] = _mm512_unpackhi_epi64(r[4], r[5]);
  t[6] = _mm512_unpacklo_epi64(r[6], r[7]);
  t[7] = _mm512_unpackhi_epi64(r[6], r[7]);
  u[0] = _mm512_shuffle_i64x2(t[0], t[2], 0x88);
  u[1] = _mm512_shuffle_i64x2(t[1], t[3], 0x88);
  u[2] = _mm512_shuffle_i64x2(t[0], t[2], 0xdd);
  u[3] = _mm512_shuffle_i64x2(t[1], t[3], 0xdd);
  u[4] = _mm512_shuffle_i64x2(t[4], t[6], 0x88);
  u[5] = _mm512_shuffle_i64x2(t[5], t[7], 0x88);
  u[6] = _mm512_shuffle_i64x2(t[4], t[6], 0xdd);
  u[7] = _mm512_shuffle_i64x2(t[5], t[7], 0xdd);
  o[0] = _mm512_shuffle_i64x2(u[0], u[4], 0x88);
  o[1] = _mm512_shuffle_i64x2(u[1], u[5], 0x88);
  o[2] = _mm512_shuffle_i64x2(u[2], u[6], 0x88);
  o[3] = _mm512_shuffle_i64x2(u[3], u[7], 0x88);
  o[4] = _mm512_shuffle_i64x2(u[0], u[4], 0xdd);
  o[5] = _mm512_shuffle_i64x2(u[1], u[5], 0xdd);
  o[6] = _mm512_shuffle_i64x2(u[2], u[6], 0xdd);
  o[7] = _mm512_shuffle_i64x2(u[3], u[7], 0xdd);
}

// transpose 8 contiguous radix-52 elements (AoS u64[NL]) into SoA.
// NL == 8 (Fq): one vector load per element + in-register transpose.
template <int NL>
inline void mm8_load(const u64 *const src[8], V8<NL> &o) {
  if constexpr (NL == 8) {
    __m512i r[8];
    for (int k = 0; k < 8; k++) r[k] = _mm512_loadu_si512(src[k]);
    transpose8x8(r, o.l);
    return;
  }
  alignas(64) u64 row[8];
  for (int j = 0; j < NL; j++) {
    for (int k = 0; k < 8; k++) row[k] = src[k][j];
    o.l[j] = _mm512_load_epi64(row);
  }
}

template <int NL>
inline void mm8_store(const V8<NL> &o, u64 *dst[8], int cnt) {
  if constexpr (NL == 8) {
    __m512i r[8];
    transpose8x8(o.l, r);
    for (int k = 0; k < cnt; k++) _mm512_storeu_si512(dst[k], r[k]);
    return;
  }
  alignas(64) u64 row[8];
  for (int j = 0; j < NL; j++) {
    _mm512_store_epi64(row, o.l[j]);
    for (int k = 0; k < cnt; k++) dst[k][j] = row[k];
  }
}

template <int NL>
inline void mm8_broadcast(const u64 *v, V8<NL> &o) {
  for (int j = 0; j < NL; j++) o.l[j] = _mm512_set1_epi64(v[j]);
}
#endif  // SCZK_HAVE_IFMA

bool g_has_ifma = [] {
#ifdef SCZK_HAVE_IFMA
  // SCZK_NO_IFMA forces the scalar radix-64 fallback (testing parity
  // with non-IFMA hosts)
  return std::getenv("SCZK_NO_IFMA") == nullptr &&
         __builtin_cpu_supports("avx512ifma") != 0;
#else
  return false;
#endif
}();

// 16-bit uint32 limbs [L] <-> u64 words [nw] (L = 4 nw).
inline void load_el(const uint32_t *limbs, int nw, u64 *w) {
  for (int i = 0; i < nw; i++) {
    w[i] = (u64)(limbs[4 * i] & 0xffff) |
           ((u64)(limbs[4 * i + 1] & 0xffff) << 16) |
           ((u64)(limbs[4 * i + 2] & 0xffff) << 32) |
           ((u64)(limbs[4 * i + 3] & 0xffff) << 48);
  }
}

inline void store_el(const u64 *w, int nw, uint32_t *limbs) {
  for (int i = 0; i < nw; i++) {
    limbs[4 * i] = (uint32_t)(w[i] & 0xffff);
    limbs[4 * i + 1] = (uint32_t)((w[i] >> 16) & 0xffff);
    limbs[4 * i + 2] = (uint32_t)((w[i] >> 32) & 0xffff);
    limbs[4 * i + 3] = (uint32_t)((w[i] >> 48) & 0xffff);
  }
}

// ---------------------------------------------------------------------
// Jacobian short-Weierstrass group law (a = 0), Montgomery coordinates.
// Mirrors curves/g1.py (dbl-2009-l / add-2007-bl / madd) with explicit
// branches instead of branch-free selects; Z == 0 encodes infinity.
// ---------------------------------------------------------------------
struct JacP {
  u64 x[MAXW], y[MAXW], z[MAXW];
};

inline void jac_set_inf(const FieldP &f, JacP &r) {
  std::memset(r.x, 0, sizeof(r.x));
  std::memset(r.z, 0, sizeof(r.z));
  std::memcpy(r.y, f.one_m, sizeof(r.y));
}

template <int NW>
inline void jac_double_t(const FieldP &f, const JacP &p, JacP &r) {
  const int nw = fw<NW>(f);
  if (words_zero(p.z, nw) || words_zero(p.y, nw)) {
    jac_set_inf(f, r);
    return;
  }
  u64 A[MAXW], B[MAXW], C[MAXW], D[MAXW], E[MAXW], G[MAXW], t[MAXW];
  mont_mul_t<NW>(f, p.x, p.x, A);         // A = X^2
  mont_mul_t<NW>(f, p.y, p.y, B);         // B = Y^2
  mont_mul_t<NW>(f, B, B, C);             // C = B^2
  add_mod_t<NW>(f, p.x, B, t);
  mont_mul_t<NW>(f, t, t, t);             // (X+B)^2
  sub_mod_t<NW>(f, t, A, t);
  sub_mod_t<NW>(f, t, C, t);
  add_mod_t<NW>(f, t, t, D);              // D = 2((X+B)^2 - A - C)
  add_mod_t<NW>(f, A, A, E);
  add_mod_t<NW>(f, E, A, E);              // E = 3A
  mont_mul_t<NW>(f, E, E, G);             // G = E^2
  u64 X3[MAXW], Y3[MAXW], Z3[MAXW], C8[MAXW];
  add_mod_t<NW>(f, D, D, t);
  sub_mod_t<NW>(f, G, t, X3);             // X3 = G - 2D
  add_mod_t<NW>(f, C, C, C8);
  add_mod_t<NW>(f, C8, C8, C8);
  add_mod_t<NW>(f, C8, C8, C8);           // 8C
  sub_mod_t<NW>(f, D, X3, t);
  mont_mul_t<NW>(f, E, t, t);
  sub_mod_t<NW>(f, t, C8, Y3);            // Y3 = E(D - X3) - 8C
  mont_mul_t<NW>(f, p.y, p.z, t);
  add_mod_t<NW>(f, t, t, Z3);             // Z3 = 2YZ
  std::memcpy(r.x, X3, nw * sizeof(u64));
  std::memcpy(r.y, Y3, nw * sizeof(u64));
  std::memcpy(r.z, Z3, nw * sizeof(u64));
}

template <int NW>
inline void jac_add_t(const FieldP &f, const JacP &p1, const JacP &p2, JacP &r) {
  const int nw = fw<NW>(f);
  if (words_zero(p1.z, nw)) { r = p2; return; }
  if (words_zero(p2.z, nw)) { r = p1; return; }
  u64 Z1Z1[MAXW], Z2Z2[MAXW], U1[MAXW], U2[MAXW], S1[MAXW], S2[MAXW];
  mont_mul_t<NW>(f, p1.z, p1.z, Z1Z1);
  mont_mul_t<NW>(f, p2.z, p2.z, Z2Z2);
  mont_mul_t<NW>(f, p1.x, Z2Z2, U1);
  mont_mul_t<NW>(f, p2.x, Z1Z1, U2);
  u64 t[MAXW];
  mont_mul_t<NW>(f, p1.y, p2.z, t);
  mont_mul_t<NW>(f, t, Z2Z2, S1);
  mont_mul_t<NW>(f, p2.y, p1.z, t);
  mont_mul_t<NW>(f, t, Z1Z1, S2);
  u64 H[MAXW], rr[MAXW];
  sub_mod_t<NW>(f, U2, U1, H);
  sub_mod_t<NW>(f, S2, S1, rr);
  if (words_zero(H, nw)) {
    if (words_zero(rr, nw)) { jac_double_t<NW>(f, p1, r); return; }
    jac_set_inf(f, r);
    return;
  }
  u64 HH[MAXW], I[MAXW], J[MAXW], r2[MAXW], V[MAXW];
  mont_mul_t<NW>(f, H, H, HH);
  add_mod_t<NW>(f, HH, HH, I);
  add_mod_t<NW>(f, I, I, I);              // I = 4 HH
  mont_mul_t<NW>(f, H, I, J);
  add_mod_t<NW>(f, rr, rr, r2);
  mont_mul_t<NW>(f, U1, I, V);
  u64 X3[MAXW], Y3[MAXW], Z3[MAXW];
  mont_mul_t<NW>(f, r2, r2, t);
  sub_mod_t<NW>(f, t, J, t);
  sub_mod_t<NW>(f, t, V, t);
  sub_mod_t<NW>(f, t, V, X3);             // X3 = r2^2 - J - 2V
  sub_mod_t<NW>(f, V, X3, t);
  mont_mul_t<NW>(f, r2, t, t);
  u64 sj[MAXW];
  mont_mul_t<NW>(f, S1, J, sj);
  add_mod_t<NW>(f, sj, sj, sj);
  sub_mod_t<NW>(f, t, sj, Y3);            // Y3 = r2(V - X3) - 2 S1 J
  add_mod_t<NW>(f, p1.z, p2.z, t);
  mont_mul_t<NW>(f, t, t, t);
  sub_mod_t<NW>(f, t, Z1Z1, t);
  sub_mod_t<NW>(f, t, Z2Z2, t);
  mont_mul_t<NW>(f, H, t, Z3);            // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H
  std::memcpy(r.x, X3, nw * sizeof(u64));
  std::memcpy(r.y, Y3, nw * sizeof(u64));
  std::memcpy(r.z, Z3, nw * sizeof(u64));
}

// Mixed add (madd-2007-bl): p2 MUST be affine (Z2 == 1 Montgomery).
// 8M + 3S vs the 11M + 5S general add — the Pippenger bucket pass runs
// this against the pre-normalized SRS bases.
template <int NW>
inline void jac_add_mixed_t(const FieldP &f, const JacP &p1, const JacP &p2,
                            JacP &r) {
  const int nw = fw<NW>(f);
  if (words_zero(p1.z, nw)) { r = p2; return; }
  u64 Z1Z1[MAXW], U2[MAXW], S2[MAXW], t[MAXW];
  mont_mul_t<NW>(f, p1.z, p1.z, Z1Z1);
  mont_mul_t<NW>(f, p2.x, Z1Z1, U2);
  mont_mul_t<NW>(f, p2.y, p1.z, t);
  mont_mul_t<NW>(f, t, Z1Z1, S2);
  u64 H[MAXW], rr[MAXW];
  sub_mod_t<NW>(f, U2, p1.x, H);          // H = U2 - X1
  sub_mod_t<NW>(f, S2, p1.y, rr);         // rr = S2 - Y1
  if (words_zero(H, nw)) {
    if (words_zero(rr, nw)) { jac_double_t<NW>(f, p1, r); return; }
    jac_set_inf(f, r);
    return;
  }
  u64 HH[MAXW], I[MAXW], J[MAXW], r2[MAXW], V[MAXW];
  mont_mul_t<NW>(f, H, H, HH);
  add_mod_t<NW>(f, HH, HH, I);
  add_mod_t<NW>(f, I, I, I);              // I = 4 HH
  mont_mul_t<NW>(f, H, I, J);
  add_mod_t<NW>(f, rr, rr, r2);           // r2 = 2(S2 - Y1)
  mont_mul_t<NW>(f, p1.x, I, V);          // V = X1 I
  u64 X3[MAXW], Y3[MAXW], Z3[MAXW];
  mont_mul_t<NW>(f, r2, r2, t);
  sub_mod_t<NW>(f, t, J, t);
  sub_mod_t<NW>(f, t, V, t);
  sub_mod_t<NW>(f, t, V, X3);             // X3 = r2^2 - J - 2V
  sub_mod_t<NW>(f, V, X3, t);
  mont_mul_t<NW>(f, r2, t, t);
  u64 sj[MAXW];
  mont_mul_t<NW>(f, p1.y, J, sj);
  add_mod_t<NW>(f, sj, sj, sj);
  sub_mod_t<NW>(f, t, sj, Y3);            // Y3 = r2(V - X3) - 2 Y1 J
  mont_mul_t<NW>(f, p1.z, H, t);
  add_mod_t<NW>(f, t, t, Z3);             // Z3 = 2 Z1 H
  std::memcpy(r.x, X3, nw * sizeof(u64));
  std::memcpy(r.y, Y3, nw * sizeof(u64));
  std::memcpy(r.z, Z3, nw * sizeof(u64));
}

// Add with automatic mixed fast path when the RHS is affine.
template <int NW>
inline void jac_add_auto_t(const FieldP &f, const JacP &p1, const JacP &p2,
                           JacP &r) {
  if (words_eq(p2.z, f.one_m, fw<NW>(f)))
    jac_add_mixed_t<NW>(f, p1, p2, r);
  else
    jac_add_t<NW>(f, p1, p2, r);
}

// ---------------------------------------------------------------------
// Batched-affine signed-digit Pippenger — the CPU MSM workhorse.
//
// Two improvements over the classic Jacobian bucket method (measured on
// this machine, native/bench_kernels.cc):
//  * bucket accumulation via the AFFINE add with batch-inverted
//    denominators: 560 ns/add vs 1320 ns for the mixed Jacobian add —
//    the Montgomery batch trick amortizes the inversion to ~3 muls per
//    add, and a serial two-pass product is exactly what one CPU core is
//    good at (the written argument for why this LOSES on a lane machine is in
//    primitives/msm.py::_msm_1d_buckets);
//  * signed digits in [-2^(c-1), 2^(c-1)]: halves the bucket count, so
//    the per-window reduction (the dominant term for the PCS opening
//    chains' many small MSMs) costs half, and the same reduce budget
//    affords c+1 on large MSMs.
//
// Buckets are scheduled in conflict-free waves: each wave claims every
// bucket at most once, batch-inverts all wave denominators in one pass,
// and applies the affine adds; conflicting entries defer to the next
// wave (waves ~= max bucket load, entries scanned once per deferral).
// ---------------------------------------------------------------------
struct AffP {
  u64 x[MAXW], y[MAXW];
  bool inf;
};

constexpr int MSM_MAX_C = 12;

// affine point in the radix-52 / R52 Montgomery domain (IFMA path)
struct AffP52 {
  u64 x[MAXL52], y[MAXL52];
  bool inf;
};

// scratch reused across calls (single-threaded XLA:CPU executor; the
// thread_local keeps it correct if thunks ever run on a pool)
struct MsmScratch {
  std::vector<int16_t> dig;        // [n, Wtot] signed digits
  std::vector<u64> bx, by;         // bucket affine coords [K2, nw]
  std::vector<unsigned char> occ;  // bucket occupied flags
  std::vector<uint32_t> claimed;   // bucket -> wave id
  std::vector<uint32_t> qpid;      // queue: point id
  std::vector<int32_t> qk;         // queue: bucket (negative = negate P)
  std::vector<uint32_t> jk, jp;    // wave jobs: bucket, point id
  std::vector<int8_t> jneg, jdbl;  // wave jobs: negate flag, doubling flag
  std::vector<u64> den, pre;       // batch-inversion work
  // IFMA (radix-52) extensions
  std::vector<AffP52> p52;         // converted input points
  std::vector<u64> dend;           // doubling-job denominators
  std::vector<uint32_t> jdk;       // doubling-job slots
  std::vector<u64> borig;          // batch-inversion original copy
  std::vector<u64> bwx, bwy;       // tree-reduce coordinate arena
  std::vector<unsigned char> binf; // arena infinity flags
  std::vector<uint32_t> seg_start, seg_len, idx, ja, jb, jo;
};

// r = p - a for a != 0 (radix 52, reduced input)
inline void neg52_s(const F52 &f, const u64 *a, u64 *r) {
  u64 borrow = 0;
  for (int i = 0; i < f.nl; i++) {
    u64 d = f.p52[i] - a[i] - borrow;
    borrow = (d >> 63) & 1;
    r[i] = d & MASK52;
  }
}

// R52-domain Montgomery inverse of one radix-52 value (EGCD + fixup)
inline void inv52_one(const FieldP &fp, const F52 &f, const u64 *a, u64 *out) {
  u64 t64[MAXW] = {0}, raw[MAXW];
  from52(a, f.nl, fp.nw, t64);
  egcd_inv_raw(fp, t64, raw);
  u64 raw52[MAXL52];
  to52(raw, fp.nw, f.nl, raw52);
  // raw = (x R52)^{-1} = x^{-1} R52^{-2} * R52; fix: * R52^3 * R52^{-1}
  mont_mul52_s(f, raw52, f.r52fix, out);
}

#ifdef SCZK_HAVE_IFMA
// striped 8-lane batch inversion over AoS radix-52 values (R52 domain).
// den: [nbp][NL] inputs (left intact), out: [nbp][NL] inverses; nbp a
// multiple of 8, padding slots one52.  den != out.
template <int NL>
void batch_invert52_ifma(const FieldP &fp, const F52 &f, const u64 *den,
                         u64 *out, int nbp, MsmScratch &S) {
  const int G = nbp / 8;
  S.pre.resize((size_t)nbp * NL);
  V8<NL> run;
  mm8_broadcast<NL>(f.one52, run);
  u64 *wp[8];
  const u64 *rp[8];
  for (int t = 0; t < G; t++) {
    for (int k = 0; k < 8; k++) wp[k] = S.pre.data() + ((size_t)8 * t + k) * NL;
    mm8_store<NL>(run, wp, 8);
    for (int k = 0; k < 8; k++) rp[k] = den + ((size_t)8 * t + k) * NL;
    V8<NL> g;
    mm8_load<NL>(rp, g);
    mm8_mul<NL>(f, run, g, run);
  }
  // stripe totals -> one shared EGCD inverse -> per-lane inverses
  u64 tot[8][MAXL52], pret[8][MAXL52], runT[MAXL52], laneinv[8][MAXL52];
  u64 *tp[8];
  for (int k = 0; k < 8; k++) tp[k] = tot[k];
  mm8_store<NL>(run, tp, 8);
  std::memcpy(runT, f.one52, sizeof(runT));
  for (int k = 0; k < 8; k++) {
    std::memcpy(pret[k], runT, sizeof(runT));
    mont_mul52_s(f, runT, tot[k], runT);
  }
  u64 Tinv[MAXL52];
  inv52_one(fp, f, runT, Tinv);
  u64 run2[MAXL52];
  std::memcpy(run2, Tinv, sizeof(run2));
  for (int k = 7; k >= 0; k--) {
    mont_mul52_s(f, run2, pret[k], laneinv[k]);
    mont_mul52_s(f, run2, tot[k], run2);
  }
  V8<NL> rinv;
  for (int k = 0; k < 8; k++) rp[k] = laneinv[k];
  mm8_load<NL>(rp, rinv);
  for (int t = G - 1; t >= 0; t--) {
    for (int k = 0; k < 8; k++) rp[k] = S.pre.data() + ((size_t)8 * t + k) * NL;
    V8<NL> pg, og, outv;
    mm8_load<NL>(rp, pg);
    for (int k = 0; k < 8; k++) rp[k] = den + ((size_t)8 * t + k) * NL;
    mm8_load<NL>(rp, og);
    mm8_mul<NL>(f, rinv, pg, outv);
    for (int k = 0; k < 8; k++) wp[k] = out + ((size_t)8 * t + k) * NL;
    mm8_store<NL>(outv, wp, 8);
    mm8_mul<NL>(f, rinv, og, rinv);
  }
}
#endif  // SCZK_HAVE_IFMA

// signed base-2^c digits of an nbits = 64*nw_s scalar; Wtot = W + 1
// entries (the extra window absorbs the final carry).
inline void signed_digits(const u64 *s, int nw_s, int c, int Wtot,
                          int16_t *dig) {
  int carry = 0;
  const int half = 1 << (c - 1);
  for (int w = 0; w < Wtot; w++) {
    const int bit = w * c;
    const int word = bit / 64;
    u64 v = 0;
    if (word < nw_s) {
      const int off = bit % 64;
      v = s[word] >> off;
      if (off + c > 64 && word + 1 < nw_s) v |= s[word + 1] << (64 - off);
    }
    int d = (int)(v & ((1u << c) - 1)) + carry;
    if (d > half) {
      d -= (1 << c);
      carry = 1;
    } else {
      carry = 0;
    }
    dig[w] = (int16_t)d;
  }
}

// batch inversion of nb nonzero denominators (Montgomery trick),
// in place; pre[] is caller scratch of the same size.
inline void batch_invert(const FieldP &f, u64 *den, u64 *pre, int nb) {
  const int nw = f.nw;
  u64 run[MAXW];
  std::memcpy(run, f.one_m, sizeof(run));
  for (int i = 0; i < nb; i++) {
    std::memcpy(pre + (size_t)i * nw, run, nw * sizeof(u64));
    mont_mul(f, run, den + (size_t)i * nw, run);
  }
  u64 rinv[MAXW];
  mont_inv_one(f, run, rinv);
  for (int i = nb; i-- > 0;) {
    u64 t[MAXW];
    mont_mul(f, rinv, pre + (size_t)i * nw, t);
    mont_mul(f, rinv, den + (size_t)i * nw, rinv);
    std::memcpy(den + (size_t)i * nw, t, nw * sizeof(u64));
  }
}

template <int NW>
inline void msm_one_affine_t(const FieldP &f, const AffP *pts, const u64 *scal,
                             int n, int nw_s, JacP &out, MsmScratch &S) {
  const int nw = fw<NW>(f);
  const int nbits = nw_s * 64;
  // window width by the measured mul-cost model: data adds ~5.4 fq-muls
  // (batched affine), reduce ~31/bucket (mixed + full Jacobian add),
  // Horner doubles ~8
  int c = 2;
  double best = 1e300;
  for (int cc = 2; cc <= MSM_MAX_C; cc++) {
    const double W = (nbits + cc - 1) / cc + 1;
    const double cost =
        W * ((double)n * 5.4 + (double)(1 << (cc - 1)) * 31.0 + cc * 8.0);
    if (cost < best) { best = cost; c = cc; }
  }
  const int Wtot = (nbits + c - 1) / c + 1;
  const int K2 = 1 << (c - 1);
  const int G = Wtot * K2;  // flat (window, bucket) grid

  S.dig.resize((size_t)n * Wtot);
  for (int i = 0; i < n; i++)
    signed_digits(scal + (size_t)i * nw_s, nw_s, c, Wtot,
                  S.dig.data() + (size_t)i * Wtot);
  S.bx.resize((size_t)G * nw);
  S.by.resize((size_t)G * nw);
  S.occ.assign(G, 0);
  S.claimed.assign(G, 0);
  S.jk.resize(G);
  S.jp.resize(G);
  S.jneg.resize(G);
  S.jdbl.resize(G);
  S.den.resize((size_t)G * nw);
  S.pre.resize((size_t)G * nw);

  // one queue over ALL (point, window) pairs: a wave claims each grid
  // bucket at most once, so the shared inversion amortizes across the
  // whole MSM (per-window waves paid a full inversion per wave — the
  // dominant cost for small MSMs)
  S.qpid.resize((size_t)n * Wtot);
  S.qk.resize((size_t)n * Wtot);
  size_t m = 0;
  for (int i = 0; i < n; i++) {
    if (pts[i].inf) continue;
    const int16_t *di = S.dig.data() + (size_t)i * Wtot;
    for (int w = 0; w < Wtot; w++) {
      const int d = di[w];
      if (!d) continue;
      const int slot1 = w * K2 + (d > 0 ? d : -d);  // 1-based grid slot
      S.qpid[m] = (uint32_t)i;
      S.qk[m] = d > 0 ? slot1 : -slot1;
      m++;
    }
  }
  {
    uint32_t wave = 0;
    while (m > 0) {
      wave++;
      int nb = 0;
      size_t m2 = 0;
      for (size_t e = 0; e < m; e++) {
        const int32_t dk = S.qk[e];
        const int k = (dk > 0 ? dk : -dk) - 1;
        if (S.claimed[k] == wave) {  // bucket already busy this wave
          S.qpid[m2] = S.qpid[e];
          S.qk[m2] = dk;
          m2++;
          continue;
        }
        S.claimed[k] = wave;
        const AffP &P = pts[S.qpid[e]];
        const bool neg = dk < 0;
        u64 *BX = S.bx.data() + (size_t)k * nw;
        u64 *BY = S.by.data() + (size_t)k * nw;
        if (!S.occ[k]) {  // empty bucket: direct assignment
          std::memcpy(BX, P.x, nw * sizeof(u64));
          if (neg) {
            u64 z[MAXW] = {0};
            sub_mod_t<NW>(f, z, P.y, BY);
          } else {
            std::memcpy(BY, P.y, nw * sizeof(u64));
          }
          S.occ[k] = 1;
          continue;
        }
        if (words_eq(BX, P.x, nw)) {
          u64 py[MAXW];
          if (neg) {
            u64 z[MAXW] = {0};
            sub_mod_t<NW>(f, z, P.y, py);
          } else {
            std::memcpy(py, P.y, nw * sizeof(u64));
          }
          if (!words_eq(BY, py, nw) || words_zero(py, nw)) {
            S.occ[k] = 0;  // P + (-P): bucket cancels to infinity
            continue;
          }
          // doubling: denom = 2 y
          u64 *D = S.den.data() + (size_t)nb * nw;
          add_mod_t<NW>(f, BY, BY, D);
          S.jdbl[nb] = 1;
        } else {
          // addition: denom = x2 - x1
          u64 *D = S.den.data() + (size_t)nb * nw;
          sub_mod_t<NW>(f, P.x, BX, D);
          S.jdbl[nb] = 0;
        }
        S.jk[nb] = (uint32_t)k;
        S.jp[nb] = S.qpid[e];
        S.jneg[nb] = (int8_t)neg;
        nb++;
      }
      if (nb) {
        batch_invert(f, S.den.data(), S.pre.data(), nb);
        for (int j = 0; j < nb; j++) {
          const int k = (int)S.jk[j];
          u64 *BX = S.bx.data() + (size_t)k * nw;
          u64 *BY = S.by.data() + (size_t)k * nw;
          const AffP &P = pts[S.jp[j]];
          const u64 *dinv = S.den.data() + (size_t)j * nw;
          u64 lam[MAXW], t[MAXW], x3[MAXW];
          if (S.jdbl[j]) {
            // lambda = 3 x^2 / (2 y)
            mont_mul_t<NW>(f, BX, BX, t);
            u64 t3[MAXW];
            add_mod_t<NW>(f, t, t, t3);
            add_mod_t<NW>(f, t3, t, t3);
            mont_mul_t<NW>(f, t3, dinv, lam);
            mont_mul_t<NW>(f, lam, lam, x3);
            sub_mod_t<NW>(f, x3, BX, x3);
            sub_mod_t<NW>(f, x3, BX, x3);
          } else {
            u64 py[MAXW];
            if (S.jneg[j]) {
              u64 z[MAXW] = {0};
              sub_mod_t<NW>(f, z, P.y, py);
            } else {
              std::memcpy(py, P.y, nw * sizeof(u64));
            }
            sub_mod_t<NW>(f, py, BY, t);      // y2 - y1
            mont_mul_t<NW>(f, t, dinv, lam);  // lambda
            mont_mul_t<NW>(f, lam, lam, x3);
            sub_mod_t<NW>(f, x3, BX, x3);
            sub_mod_t<NW>(f, x3, P.x, x3);    // x3 = l^2 - x1 - x2
          }
          sub_mod_t<NW>(f, BX, x3, t);
          mont_mul_t<NW>(f, lam, t, t);
          sub_mod_t<NW>(f, t, BY, BY);        // y3 = l (x1 - x3) - y1
          std::memcpy(BX, x3, nw * sizeof(u64));
        }
      }
      m = m2;
    }
  }

  // reduce each window — sum_k (k+1) B_k via suffix accumulation (acc
  // mixed-adds each occupied affine bucket; sum full-adds acc per
  // bucket slot) — then Horner-combine windows MSB first
  jac_set_inf(f, out);
  JacP acc, sum, tmp;
  for (int w = Wtot - 1; w >= 0; w--) {
    if (w != Wtot - 1 && !words_zero(out.z, fw<NW>(f)))
      for (int b = 0; b < c; b++) jac_double_t<NW>(f, out, out);
    jac_set_inf(f, acc);
    jac_set_inf(f, sum);
    const unsigned char *occ = S.occ.data() + (size_t)w * K2;
    const size_t base = (size_t)w * K2;
    for (int k = K2 - 1; k >= 0; k--) {
      if (occ[k]) {
        std::memcpy(tmp.x, S.bx.data() + (base + k) * nw, nw * sizeof(u64));
        std::memcpy(tmp.y, S.by.data() + (base + k) * nw, nw * sizeof(u64));
        std::memcpy(tmp.z, f.one_m, sizeof(tmp.z));
        jac_add_mixed_t<NW>(f, acc, tmp, acc);
      }
      if (!words_zero(acc.z, nw)) jac_add_t<NW>(f, sum, acc, sum);
    }
    jac_add_t<NW>(f, out, sum, out);
  }
}

// r += g * a for a small positive integer g (double-and-add over the
// ~log2(K2) bits of a bucket-index gap)
template <int NW>
inline void jac_add_scaled_t(const FieldP &f, JacP &r, const JacP &a, uint32_t g) {
  if (g == 1) {
    jac_add_t<NW>(f, r, a, r);
    return;
  }
  JacP acc;
  jac_set_inf(f, acc);
  for (int b = 31 - __builtin_clz(g); b >= 0; b--) {
    jac_double_t<NW>(f, acc, acc);
    if ((g >> b) & 1) jac_add_t<NW>(f, acc, a, acc);
  }
  jac_add_t<NW>(f, r, acc, r);
}

#ifdef SCZK_HAVE_IFMA
// IFMA variant of the batched-affine MSM: identical wave/bucket scheme,
// but all bucket arithmetic runs in radix-52 / R52 form with the data
// adds and batch inversions 8 lanes wide (mm8_*).  Points convert into
// the domain once; buckets convert back at the reduce.
template <int NW>
inline void msm_one_affine_ifma_t(const FieldP &fp, const AffP *pts,
                                  const u64 *scal, int n, int nw_s, JacP &out,
                                  MsmScratch &S) {
  constexpr int NL = (64 * NW + 51) / 52;
  const F52 &f = g_f52[fp.fid];
  const int nbits = nw_s * 64;
  // cost model in fq-mul units: vectorized data adds ~3 (measured
  // ~0.28 us incl. transposes/scan); the jumped reduce costs ~45 per
  // OCCUPIED bucket (mixed add + gap double-and-add + full add), with
  // expected occupancy K2 (1 - exp(-n/K2)) per window
  int c = 2;
  double best = 1e300;
  for (int cc = 2; cc <= MSM_MAX_C; cc++) {
    const double W = (nbits + cc - 1) / cc + 1;
    const double K2d = (double)(1 << (cc - 1));
    const double occd = K2d * (1.0 - std::exp(-(double)n / K2d));
    const double cost = W * ((double)n * 3.0 + occd * 45.0 + cc * 8.0);
    if (cost < best) { best = cost; c = cc; }
  }
  const int Wtot = (nbits + c - 1) / c + 1;
  const int K2 = 1 << (c - 1);
  const int G = Wtot * K2;

  static bool stats = std::getenv("SCZK_MSM_STATS") != nullptr;
  auto tick = [&]() {
    return stats ? std::chrono::steady_clock::now()
                 : std::chrono::steady_clock::time_point();
  };
  auto ms = [](auto a, auto b) {
    return std::chrono::duration<double, std::milli>(b - a).count();
  };
  auto t0 = tick();

  S.dig.resize((size_t)n * Wtot);
  for (int i = 0; i < n; i++)
    signed_digits(scal + (size_t)i * nw_s, nw_s, c, Wtot,
                  S.dig.data() + (size_t)i * Wtot);

  // convert points into the radix-52 R52 domain, 8 lanes at a time
  S.p52.resize(n);
  V8<NL> cto;
  mm8_broadcast<NL>(f.c_to52, cto);
  {
    u64 tmp[8][2][MAXL52];
    const u64 *rp[8];
    u64 *wp[8];
    for (int i0 = 0; i0 < n; i0 += 8) {
      const int cnt = n - i0 < 8 ? n - i0 : 8;
      for (int k = 0; k < 8; k++) {
        const AffP &P = pts[i0 + (k < cnt ? k : 0)];
        to52(P.x, NW, NL, tmp[k][0]);
        to52(P.y, NW, NL, tmp[k][1]);
        if (k < cnt) S.p52[i0 + k].inf = P.inf;
      }
      V8<NL> v;
      for (int coord = 0; coord < 2; coord++) {
        for (int k = 0; k < 8; k++) rp[k] = tmp[k][coord];
        mm8_load<NL>(rp, v);
        mm8_mul<NL>(f, v, cto, v);
        for (int k = 0; k < cnt; k++)
          wp[k] = coord ? S.p52[i0 + k].y : S.p52[i0 + k].x;
        mm8_store<NL>(v, wp, cnt);
      }
    }
  }

  S.bx.resize((size_t)G * NL);
  S.by.resize((size_t)G * NL);
  S.occ.assign(G, 0);

  // Sorted pairwise tree-reduce.  A naive one-add-per-bucket-per-wave
  // scheme serializes on hot buckets — the TOP windows of 255-bit
  // scalars concentrate thousands of entries into a handful of buckets
  // (the final carry window puts ~n/2 entries into ONE bucket), which
  // cost O(max load) waves.  Instead: counting-sort the (point, window)
  // entries by grid slot, then reduce each slot's entry list pairwise —
  // all pairs of a level are independent, so every level is one batched
  // inversion + one vectorized add sweep, and a load-L bucket finishes
  // in log2(L) levels.  Entries materialize their signed y up front, so
  // the add kernel needs no negation handling at all.
  // Slots are processed in chunks of <= CHUNK entries to bound the
  // coordinate arena.
  auto t1 = tick();
  size_t total_adds = 0;
  int levels_run = 0;
  double inv_ms = 0, apply_ms = 0;
  // counting sort by slot
  S.claimed.assign(G + 1, 0);  // reused as histogram / segment starts
  uint32_t *starts = S.claimed.data();
  size_t m = 0;
  for (int i = 0; i < n; i++) {
    if (S.p52[i].inf) continue;
    const int16_t *di = S.dig.data() + (size_t)i * Wtot;
    for (int w = 0; w < Wtot; w++) {
      const int d = di[w];
      if (!d) continue;
      starts[w * K2 + (d > 0 ? d : -d) - 1]++;
      m++;
    }
  }
  uint32_t acc_cnt = 0;
  for (int k = 0; k <= G; k++) {
    const uint32_t c0 = k < G ? starts[k] : 0;
    starts[k] = acc_cnt;
    acc_cnt += c0;
  }
  S.qpid.resize(m);  // sorted entries: point id
  S.qk.resize(m);    // sorted entries: sign (+1/-1)
  {
    std::vector<uint32_t> &fill = S.jp;  // reuse as per-slot cursor
    fill.assign(starts, starts + G);
    for (int i = 0; i < n; i++) {
      if (S.p52[i].inf) continue;
      const int16_t *di = S.dig.data() + (size_t)i * Wtot;
      for (int w = 0; w < Wtot; w++) {
        const int d = di[w];
        if (!d) continue;
        const int k = w * K2 + (d > 0 ? d : -d) - 1;
        const uint32_t pos = fill[k]++;
        S.qpid[pos] = (uint32_t)i;
        S.qk[pos] = d > 0 ? 1 : -1;
      }
    }
  }

  constexpr int CHUNK = 8192;
  // arena: materialized coords (x, y) per working entry + inf flag
  S.bwx.resize((size_t)2 * CHUNK * NL);
  S.bwy.resize((size_t)2 * CHUNK * NL);
  S.binf.resize(2 * CHUNK);
  S.seg_start.resize(G + 1);
  S.seg_len.resize(G);
  S.idx.resize(2 * CHUNK);
  S.ja.resize(CHUNK);  // job: left entry arena index
  S.jb.resize(CHUNK);  // job: right entry arena index
  S.jo.resize(CHUNK);  // job: output arena index
  S.jdk.resize(CHUNK);
  S.den.resize(((size_t)CHUNK + 8) * NL);
  S.dend.resize((size_t)CHUNK * NL);

  int k0 = 0;
  while (k0 < G) {
    // take slots [k0, k1) with <= CHUNK entries (a single slot may
    // legally exceed CHUNK only if its load > CHUNK: take it alone and
    // spill — handled by capping the level-0 segment pair count)
    int k1 = k0;
    size_t cnt = 0;
    while (k1 < G) {
      const size_t L = starts[k1 + 1] - starts[k1];
      if (cnt && cnt + L > CHUNK) break;
      cnt += L;
      k1++;
      if (cnt >= CHUNK) break;
    }
    if (cnt == 0) { k0 = k1; continue; }
    size_t base = starts[k0];
    while (true) {  // spill loop for oversized single slots
      // materialize up to CHUNK entries of [k0, k1) starting at base
      int nseg = 0;
      size_t w = 0;  // arena write cursor
      for (int k = k0; k < k1; k++) {
        const size_t lo = std::max((size_t)starts[k], base);
        const size_t hi = std::min((size_t)starts[k + 1], base + CHUNK);
        if (lo >= hi) continue;
        S.seg_start[nseg] = (uint32_t)w;
        S.seg_len[nseg] = (uint32_t)(hi - lo);
        nseg++;
        for (size_t e = lo; e < hi; e++, w++) {
          const AffP52 &P = S.p52[S.qpid[e]];
          S.idx[w] = (uint32_t)w;
          std::memcpy(S.bwx.data() + w * NL, P.x, NL * sizeof(u64));
          if (S.qk[e] < 0) neg52_s(f, P.y, S.bwy.data() + w * NL);
          else std::memcpy(S.bwy.data() + w * NL, P.y, NL * sizeof(u64));
          S.binf[w] = 0;
        }
      }
      size_t arena_top = w;
      // pairwise levels until every segment has one survivor
      bool more = true;
      while (more) {
        more = false;
        int na = 0, nd = 0;
        // schedule pass: pair up within each segment
        for (int s = 0; s < nseg; s++) {
          const uint32_t st = S.seg_start[s];
          const uint32_t len = S.seg_len[s];
          if (len < 2) continue;
          uint32_t out = st;
          for (uint32_t t = 0; t + 1 < len; t += 2) {
            const uint32_t ia = S.idx[st + t], ib = S.idx[st + t + 1];
            const u64 *ax = S.bwx.data() + (size_t)ia * NL;
            const u64 *bx2 = S.bwx.data() + (size_t)ib * NL;
            uint32_t io;
            if (S.binf[ia]) {
              io = ib;  // inf + Q = Q
            } else if (S.binf[ib]) {
              io = ia;
            } else if (words_eq(ax, bx2, NL)) {
              const u64 *ay = S.bwy.data() + (size_t)ia * NL;
              const u64 *by2 = S.bwy.data() + (size_t)ib * NL;
              if (!words_eq(ay, by2, NL) || words_zero(ay, NL)) {
                io = (uint32_t)arena_top;  // P + (-P) = inf
                S.binf[arena_top] = 2;     // mark: pure inf output
                arena_top++;
              } else {
                add52_s(f, ay, ay, S.dend.data() + (size_t)nd * NL);  // 2y
                io = (uint32_t)arena_top;
                S.binf[arena_top] = 0;
                S.jdk[nd] = (uint32_t)ia;  // reuse: left operand
                S.ja[CHUNK - 1 - nd] = io; // dbl outputs from the back
                nd++;
                arena_top++;
              }
            } else {
              sub52_s(f, bx2, ax, S.den.data() + (size_t)na * NL);
              S.ja[na] = ia;
              S.jb[na] = ib;
              io = (uint32_t)arena_top;
              S.binf[arena_top] = 0;
              S.jo[na] = io;
              na++;
              arena_top++;
            }
            S.idx[out++] = io;
          }
          if (len & 1) S.idx[out++] = S.idx[st + len - 1];
          S.seg_len[s] = out - st;
          if (S.seg_len[s] > 1) more = true;
        }
        // fix inf marks (2 -> 1 means "is infinity")
        // (binf values: 0 live, 2 fresh inf -> set to 1 below)
        levels_run++;
        if (na) {
          total_adds += na;
          auto ta = tick();
          const int nap = (na + 7) & ~7;
          for (int j = na; j < nap; j++)
            std::memcpy(S.den.data() + (size_t)j * NL, f.one52,
                        NL * sizeof(u64));
          S.borig.resize(((size_t)nap) * NL);
          batch_invert52_ifma<NL>(fp, f, S.den.data(), S.borig.data(), nap, S);
          if (stats) inv_ms += ms(ta, tick());
          auto tb = tick();
          const u64 *rp[8];
          u64 *wp[8], *wyp[8];
          for (int g0 = 0; g0 < na; g0 += 8) {
            const int cc = na - g0 < 8 ? na - g0 : 8;
            V8<NL> ax, ay, bx2, by2, dv, t, lam, x3;
            for (int k = 0; k < 8; k++) {
              const int j = g0 + (k < cc ? k : 0);
              rp[k] = S.bwx.data() + (size_t)S.ja[j] * NL;
            }
            mm8_load<NL>(rp, ax);
            for (int k = 0; k < 8; k++) {
              const int j = g0 + (k < cc ? k : 0);
              rp[k] = S.bwy.data() + (size_t)S.ja[j] * NL;
            }
            mm8_load<NL>(rp, ay);
            for (int k = 0; k < 8; k++) {
              const int j = g0 + (k < cc ? k : 0);
              rp[k] = S.bwx.data() + (size_t)S.jb[j] * NL;
            }
            mm8_load<NL>(rp, bx2);
            for (int k = 0; k < 8; k++) {
              const int j = g0 + (k < cc ? k : 0);
              rp[k] = S.bwy.data() + (size_t)S.jb[j] * NL;
            }
            mm8_load<NL>(rp, by2);
            for (int k = 0; k < 8; k++) {
              const int j = g0 + (k < cc ? k : 0);
              rp[k] = S.borig.data() + (size_t)j * NL;
            }
            mm8_load<NL>(rp, dv);
            mm8_sub<NL>(f, by2, ay, t);     // y2 - y1
            mm8_mul<NL>(f, t, dv, lam);
            mm8_mul<NL>(f, lam, lam, x3);
            mm8_sub<NL>(f, x3, ax, x3);
            mm8_sub<NL>(f, x3, bx2, x3);    // x3 = l^2 - x1 - x2
            mm8_sub<NL>(f, ax, x3, t);      // x1 - x3
            mm8_mul<NL>(f, lam, t, t);
            mm8_sub<NL>(f, t, ay, t);       // y3 = l (x1 - x3) - y1
            for (int k = 0; k < 8; k++) {
              const int j = g0 + (k < cc ? k : 0);
              wp[k] = S.bwx.data() + (size_t)S.jo[j] * NL;
              wyp[k] = S.bwy.data() + (size_t)S.jo[j] * NL;
            }
            mm8_store<NL>(x3, wp, cc);
            mm8_store<NL>(t, wyp, cc);
          }
          if (stats) apply_ms += ms(tb, tick());
        }
        if (nd) {
          // doublings batched + vectorized like the adds — in leader
          // (fake-network) mode the gathered points are one point
          // broadcast N ways, so EVERY tree pair is a doubling
          total_adds += nd;
          const int ndp = (nd + 7) & ~7;
          for (int j = nd; j < ndp; j++)
            std::memcpy(S.dend.data() + (size_t)j * NL, f.one52,
                        NL * sizeof(u64));
          S.borig.resize(((size_t)ndp) * NL);
          batch_invert52_ifma<NL>(fp, f, S.dend.data(), S.borig.data(), ndp, S);
          const u64 *rp[8];
          u64 *wp[8], *wyp[8];
          for (int g0 = 0; g0 < nd; g0 += 8) {
            const int cc = nd - g0 < 8 ? nd - g0 : 8;
            V8<NL> x, y, dv, t, t3, lam, x3;
            for (int k = 0; k < 8; k++) {
              const int j = g0 + (k < cc ? k : 0);
              rp[k] = S.bwx.data() + (size_t)S.jdk[j] * NL;
            }
            mm8_load<NL>(rp, x);
            for (int k = 0; k < 8; k++) {
              const int j = g0 + (k < cc ? k : 0);
              rp[k] = S.bwy.data() + (size_t)S.jdk[j] * NL;
            }
            mm8_load<NL>(rp, y);
            for (int k = 0; k < 8; k++) {
              const int j = g0 + (k < cc ? k : 0);
              rp[k] = S.borig.data() + (size_t)j * NL;
            }
            mm8_load<NL>(rp, dv);
            mm8_mul<NL>(f, x, x, t);            // x^2
            mm8_add<NL>(f, t, t, t3);
            mm8_add<NL>(f, t3, t, t3);          // 3 x^2
            mm8_mul<NL>(f, t3, dv, lam);
            mm8_mul<NL>(f, lam, lam, x3);
            mm8_sub<NL>(f, x3, x, x3);
            mm8_sub<NL>(f, x3, x, x3);          // x3 = l^2 - 2x
            mm8_sub<NL>(f, x, x3, t);
            mm8_mul<NL>(f, lam, t, t);
            mm8_sub<NL>(f, t, y, t);            // y3 = l (x - x3) - y
            for (int k = 0; k < 8; k++) {
              const int j = g0 + (k < cc ? k : 0);
              wp[k] = S.bwx.data() + (size_t)S.ja[CHUNK - 1 - j] * NL;
              wyp[k] = S.bwy.data() + (size_t)S.ja[CHUNK - 1 - j] * NL;
            }
            mm8_store<NL>(x3, wp, cc);
            mm8_store<NL>(t, wyp, cc);
          }
        }
      }
      // survivors -> buckets (merge: a spilled slot may already hold a
      // partial sum from the previous pass — at most one extra scalar
      // merge add per spill round)
      int s = 0;
      for (int k = k0; k < k1; k++) {
        const size_t lo = std::max((size_t)starts[k], base);
        const size_t hi = std::min((size_t)starts[k + 1], base + CHUNK);
        if (lo >= hi) continue;
        const uint32_t iv = S.idx[S.seg_start[s]];
        s++;
        if (S.binf[iv]) continue;
        const u64 *sx = S.bwx.data() + (size_t)iv * NL;
        const u64 *sy = S.bwy.data() + (size_t)iv * NL;
        u64 *BX = S.bx.data() + (size_t)k * NL;
        u64 *BY = S.by.data() + (size_t)k * NL;
        if (!S.occ[k]) {
          std::memcpy(BX, sx, NL * sizeof(u64));
          std::memcpy(BY, sy, NL * sizeof(u64));
          S.occ[k] = 1;
        } else if (words_eq(BX, sx, NL)) {
          if (!words_eq(BY, sy, NL) || words_zero(sy, NL)) {
            S.occ[k] = 0;
          } else {  // doubling (scalar, negligible)
            u64 two_y[MAXL52], dinv[MAXL52], t[MAXL52], t3[MAXL52],
                lam[MAXL52], x3[MAXL52];
            add52_s(f, BY, BY, two_y);
            inv52_one(fp, f, two_y, dinv);
            mont_mul52_s(f, BX, BX, t);
            add52_s(f, t, t, t3);
            add52_s(f, t3, t, t3);
            mont_mul52_s(f, t3, dinv, lam);
            mont_mul52_s(f, lam, lam, x3);
            sub52_s(f, x3, BX, x3);
            sub52_s(f, x3, BX, x3);
            sub52_s(f, BX, x3, t);
            mont_mul52_s(f, lam, t, t);
            sub52_s(f, t, BY, BY);
            std::memcpy(BX, x3, NL * sizeof(u64));
          }
        } else {  // scalar affine merge add into the bucket
          u64 den1[MAXL52], dinv[MAXL52], t[MAXL52], lam[MAXL52],
              x3[MAXL52];
          sub52_s(f, sx, BX, den1);
          inv52_one(fp, f, den1, dinv);
          sub52_s(f, sy, BY, t);
          mont_mul52_s(f, t, dinv, lam);
          mont_mul52_s(f, lam, lam, x3);
          sub52_s(f, x3, BX, x3);
          sub52_s(f, x3, sx, x3);
          sub52_s(f, BX, x3, t);
          mont_mul52_s(f, lam, t, t);
          sub52_s(f, t, BY, BY);
          std::memcpy(BX, x3, NL * sizeof(u64));
        }
      }
      base += CHUNK;
      if (base >= starts[k1]) break;  // chunk fully consumed
    }
    k0 = k1;
  }

  auto t2 = tick();
  // reduce: sum_k (k+1) B_k per window with a run-length-JUMPED suffix
  // scan — only occupied buckets are visited; the running suffix sum is
  // weighted by the gap to the next occupied bucket with one small
  // double-and-add (gap <= K2).  255-bit scalars spread n entries over
  // ~n/ (256/c) per window, so small MSMs have mostly-empty windows and
  // the dense K2-step scan (2 Jacobian adds per slot, occupied or not)
  // dominated their cost.  Buckets convert back to R64/radix-64 here.
  jac_set_inf(fp, out);
  JacP acc, sum, tmp;
  std::memcpy(tmp.z, fp.one_m, sizeof(tmp.z));
  for (int w = Wtot - 1; w >= 0; w--) {
    if (w != Wtot - 1 && !words_zero(out.z, NW))
      for (int b = 0; b < c; b++) jac_double_t<NW>(fp, out, out);
    jac_set_inf(fp, acc);
    jac_set_inf(fp, sum);
    const unsigned char *occ = S.occ.data() + (size_t)w * K2;
    const size_t base = (size_t)w * K2;
    int pending_k = -1;  // occupied index whose suffix span is open
    for (int k = K2 - 1; k >= 0; k--) {
      if (!occ[k]) continue;
      if (pending_k >= 0)
        jac_add_scaled_t<NW>(fp, sum, acc, (uint32_t)(pending_k - k));
      u64 c52[MAXL52];
      mont_mul52_s(f, S.bx.data() + (base + k) * NL, f.one64_52, c52);
      from52(c52, NL, NW, tmp.x);
      mont_mul52_s(f, S.by.data() + (base + k) * NL, f.one64_52, c52);
      from52(c52, NL, NW, tmp.y);
      std::memcpy(tmp.z, fp.one_m, sizeof(tmp.z));
      jac_add_mixed_t<NW>(fp, acc, tmp, acc);
      pending_k = k;
    }
    if (pending_k >= 0) {
      jac_add_scaled_t<NW>(fp, sum, acc, (uint32_t)(pending_k + 1));
      jac_add_t<NW>(fp, out, sum, out);
    }
  }
  if (stats)
    std::fprintf(stderr,
                 "# msm_ifma n=%d c=%d Wtot=%d levels=%d adds=%zu "
                 "setup=%.1fms tree=%.1fms (inv=%.1f apply=%.1f) reduce=%.1fms\n",
                 n, c, Wtot, levels_run, total_adds, ms(t0, t1), ms(t1, t2),
                 inv_ms, apply_ms, ms(t2, tick()));
}
#endif  // SCZK_HAVE_IFMA

// Convert n Jacobian points to affine (z == 0 -> inf flag).  Points
// already affine (z == 1 Montgomery — the pre-normalized SRS bases) are
// copied; projective inputs (e.g. gathered MSM partials in the leader
// maps) are batch-normalized with ONE shared inversion.
template <int NW>
inline void to_affine_batch(const FieldP &f, const JacP *pts, int n,
                            AffP *out, MsmScratch &S) {
  const int nw = fw<NW>(f);
  S.den.resize((size_t)n * nw);
  S.pre.resize((size_t)n * nw);
  S.jk.resize(n);
  int nb = 0;
  for (int i = 0; i < n; i++) {
    if (words_zero(pts[i].z, nw)) {
      out[i].inf = true;
      continue;
    }
    out[i].inf = false;
    if (words_eq(pts[i].z, f.one_m, nw)) {
      std::memcpy(out[i].x, pts[i].x, nw * sizeof(u64));
      std::memcpy(out[i].y, pts[i].y, nw * sizeof(u64));
      continue;
    }
    std::memcpy(S.den.data() + (size_t)nb * nw, pts[i].z, nw * sizeof(u64));
    S.jk[nb] = (uint32_t)i;
    nb++;
  }
  if (!nb) return;
  batch_invert(f, S.den.data(), S.pre.data(), nb);
  for (int j = 0; j < nb; j++) {
    const int i = (int)S.jk[j];
    const u64 *zi = S.den.data() + (size_t)j * nw;
    u64 zi2[MAXW], zi3[MAXW];
    mont_mul_t<NW>(f, zi, zi, zi2);
    mont_mul_t<NW>(f, zi2, zi, zi3);
    mont_mul_t<NW>(f, pts[i].x, zi2, out[i].x);
    mont_mul_t<NW>(f, pts[i].y, zi3, out[i].y);
  }
}

// Window-w base-2^c digit of a scalar; digits may straddle word
// boundaries (reads the next word when needed, guarded at the top end).
inline int msm_digit(const u64 *s, int nw_s, int w, int c) {
  const int bit = w * c;
  const int word = bit / 64;
  const int off = bit % 64;
  u64 v = s[word] >> off;
  if (off + c > 64 && word + 1 < nw_s) v |= s[word + 1] << (64 - off);
  return (int)(v & ((1u << c) - 1));
}

// Pippenger MSM over one batch slot: out = sum_i s[i] * P[i].
// Scalars as raw little-endian u64 words (standard form).
// The window width minimizes the exact op-count model
//   ceil(nbits/c) * (n data adds + 2 (2^c - 1) reduce adds + c doubles)
// — a fixed width (the classic c = 8) pays 510 reduce adds per window
// even on the tiny halving levels the PCS opening chains commit, where
// the reduce then dwarfs the useful work.
template <int NW>
inline void msm_one_t(const FieldP &f, const JacP *pts, const u64 *scal,
                      int n, int nw_s, JacP &out) {
  const int nbits = nw_s * 64;
  int c = 2;
  double best = 1e300;
  for (int cc = 2; cc <= MSM_MAX_C; cc++) {
    const double W = (nbits + cc - 1) / cc;
    const double cost = W * ((double)n + 2.0 * ((1 << cc) - 1) + cc);
    if (cost < best) { best = cost; c = cc; }
  }
  const int nbuckets = (1 << c) - 1;
  const int windows = (nbits + c - 1) / c;
  static thread_local JacP buckets[(1 << MSM_MAX_C) - 1];
  jac_set_inf(f, out);
  for (int w = windows - 1; w >= 0; w--) {
    for (int k = 0; k < nbuckets; k++) jac_set_inf(f, buckets[k]);
    for (int i = 0; i < n; i++) {
      int d = msm_digit(scal + i * nw_s, nw_s, w, c);
      if (d) jac_add_auto_t<NW>(f, buckets[d - 1], pts[i], buckets[d - 1]);
    }
    if (w != windows - 1)
      for (int b = 0; b < c; b++) jac_double_t<NW>(f, out, out);
    JacP acc, sum;
    jac_set_inf(f, acc);
    jac_set_inf(f, sum);
    for (int k = nbuckets - 1; k >= 0; k--) {
      jac_add_t<NW>(f, acc, buckets[k], acc);
      jac_add_t<NW>(f, sum, acc, sum);
    }
    jac_add_t<NW>(f, out, sum, out);
  }
}

// Per-element double-and-add (LSB-first) for batched scalar_mul.
template <int NW>
inline void smul_one_t(const FieldP &f, const JacP &p, const u64 *s, int nw_s,
                       JacP &out) {
  JacP acc, base = p;
  jac_set_inf(f, acc);
  for (int w = 0; w < nw_s; w++) {
    for (int b = 0; b < 64; b++) {
      if ((s[w] >> b) & 1) jac_add_auto_t<NW>(f, acc, base, acc);
      jac_double_t<NW>(f, base, base);
    }
  }
  out = acc;
}

inline void load_jac(const uint32_t *x, const uint32_t *y, const uint32_t *z,
                     size_t i, int L, int nw, JacP &p) {
  load_el(x + i * L, nw, p.x);
  load_el(y + i * L, nw, p.y);
  load_el(z + i * L, nw, p.z);
}

inline void store_jac(const JacP &p, size_t i, int L, int nw, uint32_t *x,
                      uint32_t *y, uint32_t *z) {
  store_el(p.x, nw, x + i * L);
  store_el(p.y, nw, y + i * L);
  store_el(p.z, nw, z + i * L);
}

enum class Op { kMul, kAdd, kSub, kInv };

#ifdef SCZK_HAVE_IFMA
// 8-lane IFMA elementwise Montgomery multiply.  The radix-52 kernel
// computes a*b/R52; one extra broadcast multiply by R52^2/R64 converts
// the result to the library's R64 domain: two vector muls + scalar
// limb repacks per element, ~1.7x over the scalar CIOS loop.
template <int NL>
void mul_loop_ifma(const FieldP &fp, const F52 &f, const uint32_t *pa,
                   const uint32_t *pb, uint32_t *po, size_t n) {
  const int nw = fp.nw;
  const int L = 4 * nw;
  V8<NL> cfix;
  mm8_broadcast<NL>(f.c_to52, cfix);
  u64 tmpa[8][MAXL52], tmpb[8][MAXL52], tmpo[8][MAXL52];
  const u64 *rpa[8], *rpb[8];
  u64 *wo[8];
  for (int k = 0; k < 8; k++) {
    rpa[k] = tmpa[k];
    rpb[k] = tmpb[k];
    wo[k] = tmpo[k];
  }
  u64 w64[MAXW];
  for (size_t i0 = 0; i0 < n; i0 += 8) {
    const int cnt = n - i0 < 8 ? (int)(n - i0) : 8;
    for (int k = 0; k < 8; k++) {
      const size_t i = i0 + (k < cnt ? k : 0);
      load_el(pa + i * L, nw, w64);
      to52(w64, nw, NL, tmpa[k]);
      load_el(pb + i * L, nw, w64);
      to52(w64, nw, NL, tmpb[k]);
    }
    V8<NL> va, vb, vo;
    mm8_load<NL>(rpa, va);
    mm8_load<NL>(rpb, vb);
    mm8_mul<NL>(f, va, vb, vo);   // a b / R52
    mm8_mul<NL>(f, vo, cfix, vo); // * R52^2/R64 / R52 = a b / R64
    mm8_store<NL>(vo, wo, 8);
    for (int k = 0; k < cnt; k++) {
      from52(tmpo[k], NL, nw, w64);
      store_el(w64, nw, po + (i0 + k) * L);
    }
  }
}
#endif  // SCZK_HAVE_IFMA

template <int NW>
void binary_loop_t(Op op, const FieldP &f, const uint32_t *pa,
                   const uint32_t *pb, uint32_t *po, size_t n) {
  const int L = 4 * f.nw;
  u64 wa[MAXW], wb[MAXW], wr[MAXW];
  for (size_t i = 0; i < n; i++) {
    load_el(pa + i * L, f.nw, wa);
    load_el(pb + i * L, f.nw, wb);
    switch (op) {
      case Op::kMul: mont_mul_t<NW>(f, wa, wb, wr); break;
      case Op::kAdd: add_mod_t<NW>(f, wa, wb, wr); break;
      case Op::kSub: sub_mod_t<NW>(f, wa, wb, wr); break;
      default: break;
    }
    store_el(wr, f.nw, po + i * L);
  }
}

ffi::Error binary_op(Op op, int32_t fid, ffi::AnyBuffer a, ffi::AnyBuffer b,
                     ffi::Result<ffi::AnyBuffer> out) {
  if (fid < 0 || fid >= MAX_FIELDS || g_fields[fid].nw == 0)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument, "unknown field id");
  const FieldP &f = g_fields[fid];
  const int L = 4 * f.nw;
  const size_t n = a.element_count() / L;
  ProfScope prof(op == Op::kMul   ? P_MUL
                 : op == Op::kAdd ? P_ADD
                                  : P_SUB,
                 n);
  const uint32_t *pa = reinterpret_cast<const uint32_t *>(a.untyped_data());
  const uint32_t *pb = reinterpret_cast<const uint32_t *>(b.untyped_data());
  uint32_t *po = reinterpret_cast<uint32_t *>(out->untyped_data());
#ifdef SCZK_HAVE_IFMA
  if (op == Op::kMul && g_has_ifma && n >= 16) {
    const F52 &f52 = g_f52[fid];
    if (f.nw == 4 && f52.nl == 5) {
      mul_loop_ifma<5>(f, f52, pa, pb, po, n);
      return ffi::Error::Success();
    }
    if (f.nw == 6 && f52.nl == 8) {
      mul_loop_ifma<8>(f, f52, pa, pb, po, n);
      return ffi::Error::Success();
    }
  }
#endif
  switch (f.nw) {
    case 4: binary_loop_t<4>(op, f, pa, pb, po, n); break;
    case 6: binary_loop_t<6>(op, f, pa, pb, po, n); break;
    default: binary_loop_t<0>(op, f, pa, pb, po, n); break;
  }
  return ffi::Error::Success();
}

ffi::Error MulImpl(int32_t fid, ffi::AnyBuffer a, ffi::AnyBuffer b,
                   ffi::Result<ffi::AnyBuffer> out) {
  return binary_op(Op::kMul, fid, a, b, out);
}

ffi::Error AddImpl(int32_t fid, ffi::AnyBuffer a, ffi::AnyBuffer b,
                   ffi::Result<ffi::AnyBuffer> out) {
  return binary_op(Op::kAdd, fid, a, b, out);
}

ffi::Error SubImpl(int32_t fid, ffi::AnyBuffer a, ffi::AnyBuffer b,
                   ffi::Result<ffi::AnyBuffer> out) {
  return binary_op(Op::kSub, fid, a, b, out);
}

// Batched inversion (Montgomery-in, Montgomery-out; 0 -> 0) via the
// Montgomery batch trick: one Fermat pow for the running product plus
// ~3 multiplies per element — ~100x over per-element Fermat at protocol
// batch sizes.  Serial two-pass structure is exactly right for one core.
ffi::Error InvImpl(int32_t fid, ffi::AnyBuffer a,
                   ffi::Result<ffi::AnyBuffer> out) {
  if (fid < 0 || fid >= MAX_FIELDS || g_fields[fid].nw == 0)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument, "unknown field id");
  const FieldP &f = g_fields[fid];
  const int nw = f.nw;
  const int L = 4 * nw;
  const size_t n = a.element_count() / L;
  ProfScope prof(P_INV, n);
  const uint32_t *pa = reinterpret_cast<const uint32_t *>(a.untyped_data());
  uint32_t *po = reinterpret_cast<uint32_t *>(out->untyped_data());
  std::vector<u64> av((size_t)n * nw), pre((size_t)n * nw);
  std::vector<unsigned char> nz(n);
  u64 run[MAXW];
  std::memcpy(run, f.one_m, sizeof(run));
  for (size_t i = 0; i < n; i++) {
    u64 *wa = av.data() + i * nw;
    load_el(pa + i * L, nw, wa);
    nz[i] = !words_zero(wa, nw);
    std::memcpy(pre.data() + i * nw, run, nw * sizeof(u64));
    if (nz[i]) mont_mul(f, run, wa, run);
  }
  u64 rinv[MAXW];
  mont_inv_one(f, run, rinv);  // (prod of non-zeros)^{-1}
  u64 wr[MAXW];
  for (size_t i = n; i-- > 0;) {
    const u64 *wa = av.data() + i * nw;
    if (nz[i]) {
      mont_mul(f, rinv, pre.data() + i * nw, wr);
      mont_mul(f, rinv, wa, rinv);
    } else {
      std::memset(wr, 0, sizeof(wr));
    }
    store_el(wr, nw, po + i * L);
  }
  return ffi::Error::Success();
}

// Batched G1 linear ops.  Modes (B = batch slots, L = 4 nw u32 limbs):
//   0 MSM:        pts [B, n_in, L], scal [B, n_in, Ls]   -> out [B, L]
//   1 scalar_mul: pts [B, L],       scal [B, Ls]         -> out [B, L]
//   2 sum:        pts [B, n_in, L], scal ignored         -> out [B, L]
//   3 linear_map: pts [B, n_in, L], scal [n_out,n_in,Ls] -> out [B, n_out, L]
template <int NW>
ffi::Error g1_loop_t(const FieldP &f, int32_t mode, int32_t n_in,
                     int32_t n_out, size_t B, const uint32_t *px,
                     const uint32_t *py, const uint32_t *pz,
                     const uint32_t *ps, int Ls, int nw_s, uint32_t *rx,
                     uint32_t *ry, uint32_t *rz) {
  const int L = 4 * f.nw;
  std::vector<JacP> pts(n_in);
  std::vector<u64> sw;
  if (mode == 3) {  // preload the shared scalar matrix
    sw.resize((size_t)n_out * n_in * nw_s);
    for (int o = 0; o < n_out; o++)
      for (int i = 0; i < n_in; i++)
        load_el(ps + ((size_t)o * n_in + i) * Ls, nw_s,
                sw.data() + ((size_t)o * n_in + i) * nw_s);
  }

  // MSM_TINY: below this size per-point double-and-add beats even the
  // batched-affine bucket pass (its per-window reduce is a fixed cost).
  constexpr int MSM_TINY = 4;
  static thread_local MsmScratch S;
  static thread_local std::vector<AffP> apts;
  std::vector<u64> sbatch((mode == 0) ? (size_t)n_in * nw_s
                          : (mode == 1) ? (size_t)nw_s : 1);

  auto msm_any = [&](const u64 *scal, JacP &out) {
    if (n_in < MSM_TINY) {
      jac_set_inf(f, out);
      JacP t;
      for (int i = 0; i < n_in; i++) {
        smul_one_t<NW>(f, pts[i], scal + (size_t)i * nw_s, nw_s, t);
        jac_add_t<NW>(f, out, t, out);
      }
      return;
    }
#ifdef SCZK_HAVE_IFMA
    if constexpr (NW > 0) {
      if (g_has_ifma && f.fid >= 0) {
        msm_one_affine_ifma_t<NW>(f, apts.data(), scal, n_in, nw_s, out, S);
        return;
      }
    }
#endif
    msm_one_affine_t<NW>(f, apts.data(), scal, n_in, nw_s, out, S);
  };

  for (size_t b = 0; b < B; b++) {
    for (int i = 0; i < n_in; i++)
      load_jac(px, py, pz, b * n_in + i, L, f.nw, pts[i]);
    if ((mode == 0 || mode == 3) && n_in >= MSM_TINY) {
      apts.resize(n_in);
      to_affine_batch<NW>(f, pts.data(), n_in, apts.data(), S);
    }
    JacP out;
    switch (mode) {
      case 0: {
        for (int i = 0; i < n_in; i++)
          load_el(ps + (b * n_in + i) * (size_t)Ls, nw_s,
                  sbatch.data() + (size_t)i * nw_s);
        msm_any(sbatch.data(), out);
        store_jac(out, b, L, f.nw, rx, ry, rz);
        break;
      }
      case 1: {
        load_el(ps + b * (size_t)Ls, nw_s, sbatch.data());
        smul_one_t<NW>(f, pts[0], sbatch.data(), nw_s, out);
        store_jac(out, b, L, f.nw, rx, ry, rz);
        break;
      }
      case 2: {
        jac_set_inf(f, out);
        for (int i = 0; i < n_in; i++) jac_add_auto_t<NW>(f, out, pts[i], out);
        store_jac(out, b, L, f.nw, rx, ry, rz);
        break;
      }
      case 3: {
        for (int o = 0; o < n_out; o++) {
          msm_any(sw.data() + (size_t)o * n_in * nw_s, out);
          store_jac(out, b * n_out + o, L, f.nw, rx, ry, rz);
        }
        break;
      }
      default:
        return ffi::Error(ffi::ErrorCode::kInvalidArgument, "bad mode");
    }
  }
  return ffi::Error::Success();
}

ffi::Error G1OpImpl(int32_t fid, int32_t mode, int32_t n_in, int32_t n_out,
                    ffi::AnyBuffer x, ffi::AnyBuffer y, ffi::AnyBuffer z,
                    ffi::AnyBuffer scal, ffi::Result<ffi::AnyBuffer> ox,
                    ffi::Result<ffi::AnyBuffer> oy,
                    ffi::Result<ffi::AnyBuffer> oz) {
  if (fid < 0 || fid >= MAX_FIELDS || g_fields[fid].nw == 0)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument, "unknown field id");
  const FieldP &f = g_fields[fid];
  const int L = 4 * f.nw;
  const size_t B = x.element_count() / ((size_t)L * n_in);
  const uint32_t *px = reinterpret_cast<const uint32_t *>(x.untyped_data());
  const uint32_t *py = reinterpret_cast<const uint32_t *>(y.untyped_data());
  const uint32_t *pz = reinterpret_cast<const uint32_t *>(z.untyped_data());
  const uint32_t *ps = reinterpret_cast<const uint32_t *>(scal.untyped_data());
  uint32_t *rx = reinterpret_cast<uint32_t *>(ox->untyped_data());
  uint32_t *ry = reinterpret_cast<uint32_t *>(oy->untyped_data());
  uint32_t *rz = reinterpret_cast<uint32_t *>(oz->untyped_data());
  ProfScope prof(mode == 0   ? P_MSM
                 : mode == 1 ? P_SMUL
                 : mode == 2 ? P_SUM
                             : P_LMAP,
                 B * (size_t)n_in * (mode == 3 ? (size_t)n_out : 1));

  int Ls = 0, nw_s = 0;
  if (mode == 0 || mode == 1)
    Ls = (int)(scal.element_count() / (B * (size_t)n_in));
  else if (mode == 3)
    Ls = (int)(scal.element_count() / ((size_t)n_out * n_in));
  if (mode != 2) {
    nw_s = Ls / 4;
    if (nw_s <= 0 || nw_s > MAXW || Ls != 4 * nw_s)
      return ffi::Error(ffi::ErrorCode::kInvalidArgument, "bad scalar width");
  }

  switch (f.nw) {
    case 4:
      return g1_loop_t<4>(f, mode, n_in, n_out, B, px, py, pz, ps, Ls, nw_s,
                          rx, ry, rz);
    case 6:
      return g1_loop_t<6>(f, mode, n_in, n_out, B, px, py, pz, ps, Ls, nw_s,
                          rx, ry, rz);
    default:
      return g1_loop_t<0>(f, mode, n_in, n_out, B, px, py, pz, ps, Ls, nw_s,
                          rx, ry, rz);
  }
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SczkG1Op, G1OpImpl,
                              ffi::Ffi::Bind()
                                  .Attr<int32_t>("fid")
                                  .Attr<int32_t>("mode")
                                  .Attr<int32_t>("n_in")
                                  .Attr<int32_t>("n_out")
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Ret<ffi::AnyBuffer>()
                                  .Ret<ffi::AnyBuffer>()
                                  .Ret<ffi::AnyBuffer>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(SczkFieldMul, MulImpl,
                              ffi::Ffi::Bind()
                                  .Attr<int32_t>("fid")
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Ret<ffi::AnyBuffer>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(SczkFieldAdd, AddImpl,
                              ffi::Ffi::Bind()
                                  .Attr<int32_t>("fid")
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Ret<ffi::AnyBuffer>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(SczkFieldSub, SubImpl,
                              ffi::Ffi::Bind()
                                  .Attr<int32_t>("fid")
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Ret<ffi::AnyBuffer>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(SczkFieldInv, InvImpl,
                              ffi::Ffi::Bind()
                                  .Attr<int32_t>("fid")
                                  .Arg<ffi::AnyBuffer>()
                                  .Ret<ffi::AnyBuffer>());

extern "C" {

// Register a field's parameters (called once per field from Python;
// p_words: little-endian u64 words of the modulus).
void sczk_field_init(int32_t fid, const u64 *p_words, int32_t nw) {
  if (fid < 0 || fid >= MAX_FIELDS || nw <= 0 || nw > MAXW) return;
  FieldP &f = g_fields[fid];
  f.fid = fid;
  f.nw = nw;
  std::memcpy(f.p, p_words, nw * sizeof(u64));
  // e = p - 2 (p is odd and > 2, so only word 0 can borrow... p[0] >= 1;
  // handle the general borrow chain anyway)
  u128 borrow = 2;
  for (int i = 0; i < nw; i++) {
    u128 d = (u128)f.p[i] - (u64)borrow;
    f.e[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  // n0inv = -p^{-1} mod 2^64 via Newton iteration
  u64 inv = f.p[0];  // p odd => self-inverse mod 8
  for (int k = 0; k < 6; k++) inv *= 2 - f.p[0] * inv;
  f.n0inv = (u64)(0 - inv);
  // one_m = R mod p = 2^(64 nw) mod p: double 1, 64*nw times
  u64 acc[MAXW] = {0};
  acc[0] = 1;
  for (int s = 0; s < 64 * nw; s++) {
    add_mod(f, acc, acc, acc);
  }
  std::memcpy(f.one_m, acc, sizeof(acc));
  // r3 = R^3 mod p: R2 = R doubled 64*nw times; r3 = mont_mul(R2, R2)
  u64 r2[MAXW];
  std::memcpy(r2, f.one_m, sizeof(r2));
  for (int s = 0; s < 64 * nw; s++) add_mod(f, r2, r2, r2);
  mont_mul(f, r2, r2, f.r3);

  // radix-52 domain constants (IFMA path)
  F52 &f52 = g_f52[fid];
  const int nl = (64 * nw + 51) / 52;
  f52.nl = nl;
  to52(f.p, nw, nl, f52.p52);
  u64 inv52 = f52.p52[0];
  for (int k = 0; k < 6; k++) inv52 *= 2 - f52.p52[0] * inv52;
  f52.n0inv52 = (0 - inv52) & MASK52;
  auto pow2mod52 = [&](int e, u64 *out52) {
    u64 a2[MAXW] = {0};
    a2[0] = 1;
    for (int s = 0; s < e; s++) add_mod(f, a2, a2, a2);
    to52(a2, nw, nl, out52);
  };
  pow2mod52(52 * nl, f52.one52);
  pow2mod52(2 * 52 * nl - 64 * nw, f52.c_to52);
  pow2mod52(64 * nw, f52.one64_52);
  pow2mod52(3 * 52 * nl, f52.r52fix);
}

}  // extern "C"
