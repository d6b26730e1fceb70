// BLS12-381 field arithmetic (Fr: 4, Fq: 6 x 64-bit Montgomery words)
// and G1 point formulas, one element / point per call — the body of the
// GPU kernels (gpu_kernels.cu) and of their host build (host_kernels.cc),
// which the CPU tests run.
//
// Boundary layout: the fields/fr.py contract, uint32 [M, 4*NW] arrays of
// 16-bit little-endian limbs in Montgomery form with R = 2^(64*NW).  NW
// 64-bit words span the same bits, so the Montgomery form (and every
// canonical value < p) is the same number; a lane is repacked on load
// and store.  Formulas mirror curves/g1.py exactly (dbl-2009-l,
// add-2007-bl, madd-2007-bl with the same complete-case selects) and
// every field op returns the canonical value, so results are bit-equal
// to the plain jnp form.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SCZK_HD __host__ __device__ __forceinline__
#else
#define SCZK_HD inline
#endif

namespace sczk {

typedef uint64_t u64;
typedef uint32_t u32;

struct Fq381 {  // BLS12-381 base field
  static constexpr int NW = 6;
  static constexpr u64 INV = 0x89f3fffcfffcfffdULL;  // -p^-1 mod 2^64
  SCZK_HD static u64 p(int i) {
    switch (i) {
      case 0: return 0xb9feffffffffaaabULL;
      case 1: return 0x1eabfffeb153ffffULL;
      case 2: return 0x6730d2a0f6b0f624ULL;
      case 3: return 0x64774b84f38512bfULL;
      case 4: return 0x4b1ba7b6434bacd7ULL;
      default: return 0x1a0111ea397fe69aULL;
    }
  }
  SCZK_HD static u64 one(int i) {  // R mod p
    switch (i) {
      case 0: return 0x760900000002fffdULL;
      case 1: return 0xebf4000bc40c0002ULL;
      case 2: return 0x5f48985753c758baULL;
      case 3: return 0x77ce585370525745ULL;
      case 4: return 0x5c071a97a256ec6dULL;
      default: return 0x15f65ec3fa80e493ULL;
    }
  }
};

struct Fr381 {  // BLS12-381 scalar field
  static constexpr int NW = 4;
  static constexpr u64 INV = 0xfffffffeffffffffULL;
  SCZK_HD static u64 p(int i) {
    switch (i) {
      case 0: return 0xffffffff00000001ULL;
      case 1: return 0x53bda402fffe5bfeULL;
      case 2: return 0x3339d80809a1d805ULL;
      default: return 0x73eda753299d7d48ULL;
    }
  }
  SCZK_HD static u64 one(int i) {
    switch (i) {
      case 0: return 0x00000001fffffffeULL;
      case 1: return 0x5884b7fa00034802ULL;
      case 2: return 0x998c4fefecbc4ff5ULL;
      default: return 0x1824b159acc5056fULL;
    }
  }
};

template <class F>
struct El {
  u64 w[F::NW];
};

typedef El<Fq381> Fq;

struct Pt {
  Fq x, y, z;
};

SCZK_HD u64 mulhi(u64 a, u64 b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (u64)(((unsigned __int128)a * b) >> 64);
#endif
}

// t + a*b + c -> low word; c <- high word (never overflows 128 bits)
SCZK_HD u64 mac(u64 t, u64 a, u64 b, u64& c) {
  u64 lo = a * b;
  u64 hi = mulhi(a, b);
  lo += t;
  hi += (lo < t);
  lo += c;
  hi += (lo < c);
  c = hi;
  return lo;
}

SCZK_HD u64 adc(u64 a, u64 b, u64& carry) {
  u64 s = a + b;
  u64 c1 = s < a;
  u64 s2 = s + carry;
  u64 c2 = s2 < s;
  carry = c1 | c2;
  return s2;
}

SCZK_HD u64 sbb(u64 a, u64 b, u64& borrow) {
  u64 d = a - b;
  u64 b1 = a < b;
  u64 d2 = d - borrow;
  u64 b2 = d < borrow;
  borrow = b1 | b2;
  return d2;
}

// value (< 2p) = t + top * 2^(64 NW)  ->  canonical
template <class F>
SCZK_HD El<F> reduce_once(const u64* t, u64 top) {
  El<F> d;
  u64 borrow = 0;
#pragma unroll
  for (int i = 0; i < F::NW; ++i) d.w[i] = sbb(t[i], F::p(i), borrow);
  El<F> out;
  bool take = top || !borrow;
#pragma unroll
  for (int i = 0; i < F::NW; ++i) out.w[i] = take ? d.w[i] : t[i];
  return out;
}

template <class F>
SCZK_HD El<F> mul(const El<F>& a, const El<F>& b) {
  constexpr int NW = F::NW;
  u64 t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = mac(t[j], a.w[i], b.w[j], c);
    u64 cc = 0;
    t[NW] = adc(t[NW], c, cc);
    t[NW + 1] = cc;
    u64 m = t[0] * F::INV;
    c = 0;
    (void)mac(t[0], m, F::p(0), c);  // low word becomes 0
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j - 1] = mac(t[j], m, F::p(j), c);
    cc = 0;
    t[NW - 1] = adc(t[NW], c, cc);
    t[NW] = t[NW + 1] + cc;
  }
  return reduce_once<F>(t, t[NW]);
}

template <class F>
SCZK_HD El<F> add(const El<F>& a, const El<F>& b) {
  u64 s[F::NW];
  u64 carry = 0;
#pragma unroll
  for (int i = 0; i < F::NW; ++i) s[i] = adc(a.w[i], b.w[i], carry);
  return reduce_once<F>(s, carry);
}

template <class F>
SCZK_HD El<F> sub(const El<F>& a, const El<F>& b) {
  El<F> d;
  u64 borrow = 0;
#pragma unroll
  for (int i = 0; i < F::NW; ++i) d.w[i] = sbb(a.w[i], b.w[i], borrow);
  if (borrow) {
    u64 carry = 0;
#pragma unroll
    for (int i = 0; i < F::NW; ++i) d.w[i] = adc(d.w[i], F::p(i), carry);
  }
  return d;
}

template <class F>
SCZK_HD bool is_zero(const El<F>& a) {
  u64 acc = 0;
#pragma unroll
  for (int i = 0; i < F::NW; ++i) acc |= a.w[i];
  return acc == 0;
}

template <class F>
SCZK_HD El<F> sel(bool c, const El<F>& a, const El<F>& b) {
  El<F> o;
#pragma unroll
  for (int i = 0; i < F::NW; ++i) o.w[i] = c ? a.w[i] : b.w[i];
  return o;
}

SCZK_HD Pt sel(bool c, const Pt& a, const Pt& b) {
  return Pt{sel(c, a.x, b.x), sel(c, a.y, b.y), sel(c, a.z, b.z)};
}

SCZK_HD Fq zero() {
  Fq o;
#pragma unroll
  for (int i = 0; i < Fq381::NW; ++i) o.w[i] = 0;
  return o;
}

SCZK_HD Fq one() {
  Fq o;
#pragma unroll
  for (int i = 0; i < Fq381::NW; ++i) o.w[i] = Fq381::one(i);
  return o;
}

SCZK_HD Pt dbl(const Pt& p) {
  Fq A = mul(p.x, p.x);
  Fq B = mul(p.y, p.y);
  Fq C = mul(B, B);
  Fq t = add(p.x, B);
  t = mul(t, t);
  Fq D0 = sub(sub(t, A), C);
  Fq D = add(D0, D0);
  Fq E = add(add(A, A), A);
  Fq G = mul(E, E);
  Fq X3 = sub(G, add(D, D));
  Fq C2 = add(C, C);
  Fq C4 = add(C2, C2);
  Fq C8 = add(C4, C4);
  Fq Y3 = sub(mul(E, sub(D, X3)), C8);
  Fq YZ = mul(p.y, p.z);
  Fq Z3 = add(YZ, YZ);
  // doubling infinity or a 2-torsion point -> infinity
  Z3 = sel(is_zero(p.z), zero(), Z3);
  return Pt{X3, Y3, Z3};
}

// General or mixed (Z2 in {0, 1}) complete add.  With ``with_double``
// false the doubling branch is skipped and ``is_dbl`` reports the lanes
// that needed it (the caller repairs them).
template <bool MIXED, bool WITH_DOUBLE>
SCZK_HD Pt add_pts(const Pt& p1, const Pt& p2, bool& is_dbl) {
  Fq Z1Z1 = mul(p1.z, p1.z);
  Fq U1, S1, Z2Z2;
  if (MIXED) {
    U1 = p1.x;
    S1 = p1.y;
  } else {
    Z2Z2 = mul(p2.z, p2.z);
    U1 = mul(p1.x, Z2Z2);
    S1 = mul(mul(p1.y, p2.z), Z2Z2);
  }
  Fq U2 = mul(p2.x, Z1Z1);
  Fq S2 = mul(mul(p2.y, p1.z), Z1Z1);
  Fq H = sub(U2, U1);
  Fq r = sub(S2, S1);
  Fq HH = mul(H, H);
  Fq I = add(add(HH, HH), add(HH, HH));
  Fq J = mul(H, I);
  Fq r2 = add(r, r);
  Fq V = mul(U1, I);
  Fq X3 = sub(sub(mul(r2, r2), J), add(V, V));
  Fq SJ = mul(S1, J);
  Fq Y3 = sub(mul(r2, sub(V, X3)), add(SJ, SJ));
  Fq Z3;
  if (MIXED) {
    Fq Z1H = mul(p1.z, H);
    Z3 = add(Z1H, Z1H);
  } else {
    Fq ZS = add(p1.z, p2.z);
    Z3 = mul(sub(sub(mul(ZS, ZS), Z1Z1), Z2Z2), H);
  }
  bool inf1 = is_zero(p1.z);
  bool inf2 = is_zero(p2.z);
  bool same_x = is_zero(H) && !inf1 && !inf2;
  bool r_zero = is_zero(r);
  is_dbl = same_x && r_zero;
  bool is_cancel = same_x && !r_zero;
  Pt out{X3, Y3, Z3};
  if (WITH_DOUBLE && is_dbl) out = dbl(p1);
  if (is_cancel) out = Pt{zero(), one(), zero()};
  if (inf2) out = p1;
  if (inf1) out = p2;
  return out;
}

template <class F>
SCZK_HD El<F> load(const u32* a, int64_t i) {
  const u32* r = a + i * 4 * F::NW;
  El<F> f;
#pragma unroll
  for (int k = 0; k < F::NW; ++k) {
    f.w[k] = (u64)r[4 * k] | ((u64)r[4 * k + 1] << 16) |
             ((u64)r[4 * k + 2] << 32) | ((u64)r[4 * k + 3] << 48);
  }
  return f;
}

template <class F>
SCZK_HD void store(u32* a, int64_t i, const El<F>& f) {
  u32* r = a + i * 4 * F::NW;
#pragma unroll
  for (int k = 0; k < F::NW; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) r[4 * k + j] = (u32)((f.w[k] >> (16 * j)) & 0xFFFF);
  }
}

enum FieldOp { F_MUL = 0, F_ADD = 1, F_SUB = 2 };

// one elementwise field op on lane i of [M, 4*NW] arrays
template <class F, int OP>
SCZK_HD void field_op_lane(const u32* a, const u32* b, u32* o, int64_t i) {
  El<F> x = load<F>(a, i);
  El<F> y = load<F>(b, i);
  El<F> r = OP == F_MUL ? mul(x, y) : (OP == F_ADD ? add(x, y) : sub(x, y));
  store<F>(o, i, r);
}

enum Op {
  OP_ADD = 0,
  OP_ADD_MIXED = 1,
  OP_DOUBLE = 2,
  OP_ADD_MASKED = 3,     // m ? P1 + P2 : P1  (bucket accumulate)
  OP_ADD_RESET = 4,      // m ? P1 + P2 : P2  (dense-MSM segment step)
  OP_ADD_RESET_LAZY = 5  // as OP_ADD_RESET, doubling lanes flagged
};

struct Args {
  const u32* in[6];   // x1 y1 z1 x2 y2 z2 ([M, 24] each)
  const u32* mask;    // [M]
  u32* out[3];        // x3 y3 z3
  u32* flag;          // [M]
  int64_t m;
};

template <int OP>
SCZK_HD void point_op_lane(const Args& a, int64_t i) {
  Pt p1{load<Fq381>(a.in[0], i), load<Fq381>(a.in[1], i), load<Fq381>(a.in[2], i)};
  Pt out;
  bool is_dbl = false;
  if (OP == OP_DOUBLE) {
    out = dbl(p1);
  } else {
    Pt p2{load<Fq381>(a.in[3], i), load<Fq381>(a.in[4], i), load<Fq381>(a.in[5], i)};
    if (OP == OP_ADD) {
      out = add_pts<false, true>(p1, p2, is_dbl);
    } else if (OP == OP_ADD_MIXED) {
      out = add_pts<true, true>(p1, p2, is_dbl);
    } else {
      bool m = a.mask[i] != 0;
      if (OP == OP_ADD_RESET_LAZY) {
        out = sel(m, add_pts<true, false>(p1, p2, is_dbl), p2);
        a.flag[i] = (is_dbl && m) ? 1u : 0u;
      } else {
        Pt s = add_pts<true, true>(p1, p2, is_dbl);
        out = sel(m, s, OP == OP_ADD_MASKED ? p1 : p2);
      }
    }
  }
  store(a.out[0], i, out.x);
  store(a.out[1], i, out.y);
  store(a.out[2], i, out.z);
}

}  // namespace sczk
