"""Vectorized prime-field arithmetic on 16-bit limb vectors.

Design
------
Elements are ``uint32`` arrays of shape ``[..., L]`` holding 16-bit limbs
(little-endian) in Montgomery form, R = 2**(16*L).  All operations are
batched over the leading dimensions.  The ring ops are one custom call
each where a kernel exists — the native FFI on the CPU, the CUDA field
kernels (cuda_kernels.py) for BLS12-381 on the GPU.  The jnp limb code
below is the plain form they are checked against and what other fields
run; its loops come in two forms (backend.unrolled_limbs): unrolled at
trace time, so XLA fuses a whole multiply into one elementwise kernel,
or one ``lax.scan`` over the limb axis, whose HLO stays small (a
``compact`` field always uses the scan).

CIOS Montgomery multiply with redundant columns
-----------------------------------------------
We keep an accumulator ``t`` of L+1 uint32 *columns* (column j carries a
value < 2^32 worth 2^(16 j)).  Iteration i adds ``a_i * b`` (each product
< 2^32, split into lo/hi 16-bit halves), computes
``m = (t0 * n0inv) mod 2^16``, adds ``m * p``, then shifts one column.
Column growth per iteration is at most 4 * (2^16 - 1) plus a small carry,
so over L <= 24 iterations columns stay far below 2^32 — no intermediate
carry chains are needed.  The final value is < 2p, fixed by one
conditional subtract.

No 64-bit integers are used anywhere (JAX runs without x64).

Why this is not a port: arkworks (the reference's L0 layer,
/root/reference/dist-primitive/Cargo.toml:18-24) uses 64-bit limbs with
carry flags — a pattern that does not vectorize on a 32-bit SIMD-lane
machine.  16-bit limbs in uint32 lanes keep every step exact, branch-free
and fully data-parallel across the batch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from .config import LIMB_BITS, LIMB_MASK, FieldSpec, int_to_limbs, limbs_to_int

MASK = jnp.uint32(LIMB_MASK)


class Field:
    """Batched arithmetic for one prime field.

    All methods take/return uint32 arrays shaped ``[..., L]`` in Montgomery
    form unless noted.  The object is hashable / comparable by field name so
    it can be safely closed over by jitted functions.
    """

    def __init__(self, spec: FieldSpec, compact: bool = False):
        """``compact``: always use the scan-form limb loops, regardless of
        backend.  A scan body holding dozens of unrolled multiplies (the
        group law inside scalar_mul/MSM scans) is a ~10^5-op HLO graph
        that compiles for minutes; the scan form compiles in seconds.
        Curve ops therefore use a compact Field for the arithmetic that
        stays outside the fused point kernels (curves/g1.py)."""
        self.spec = spec
        self.compact = compact
        self.L = spec.num_limbs
        self.p = spec.modulus
        self._p_np = spec.p_limbs
        self._n0inv = np.uint32(spec.n0inv)
        self._r_np = spec.r_limbs
        self._r2_np = spec.r2_limbs
        # jit the hot ring ops: protocols instantiate these thousands of
        # times inside combinators (associative_scan retraces its combiner
        # ~2 log n times) — per-shape trace caching keeps trace time flat.
        # pow_const/inv/batch_inv wrap lax.scan closures over their inputs,
        # so they MUST be jitted or every call re-lowers with the input
        # baked in as a constant (a fresh multi-second XLA compile).
        self.add = jax.jit(self.add)
        self.sub = jax.jit(self.sub)
        self.mul = jax.jit(self.mul)
        self.pow_const = jax.jit(self.pow_const, static_argnums=1)
        self.inv = jax.jit(self.inv)
        self.batch_inv = jax.jit(self.batch_inv)

    def _ffi(self):
        """Native CPU kernel module, or None (GPU / no toolchain).

        On the CPU backend field ops lower to single custom-call
        instructions (native/field_ffi.cc) — both a ~100x runtime win
        and the difference between multi-GB and trivial XLA compiles
        for full-protocol graphs.  Checked at trace time.
        """
        return backend.native_ffi()

    def _gpu(self):
        """The CUDA field kernels on the GPU for this field, or None."""
        from .. import cuda_kernels

        if backend.field_kernels() and self.spec.name in cuda_kernels.FIELD_IDS:
            return cuda_kernels
        return None

    def _scan_form(self) -> bool:
        return self.compact or not backend.unrolled_limbs()

    # -- identity / hashing (stable for jit caches) ----------------------
    def __hash__(self):
        return hash((self.spec.name, self.compact))

    def __eq__(self, other):
        return (
            isinstance(other, Field)
            and self.spec.name == other.spec.name
            and self.compact == other.compact
        )

    def __repr__(self):
        return f"Field({self.spec.name}{', compact' if self.compact else ''})"

    # ------------------------------------------------------------------
    # Host conversions
    # ------------------------------------------------------------------
    def to_mont_int(self, x: int) -> np.ndarray:
        """Python int -> Montgomery limb vector (host side)."""
        return int_to_limbs(x * self.spec.r % self.p, self.L)

    def from_mont_limbs(self, limbs) -> int:
        """Montgomery limb vector -> Python int (host side)."""
        return limbs_to_int(np.asarray(limbs)) * self.spec.rinv % self.p

    def array_from_ints(self, xs) -> jnp.ndarray:
        """Nested list/array of Python ints -> [..., L] Montgomery array."""
        xs = np.asarray(xs, dtype=object)
        flat = xs.reshape(-1)
        out = np.empty((flat.shape[0], self.L), dtype=np.uint32)
        for i, v in enumerate(flat):
            out[i] = self.to_mont_int(int(v) % self.p)
        return jnp.asarray(out.reshape(xs.shape + (self.L,)))

    def array_to_ints(self, arr) -> np.ndarray:
        """[..., L] Montgomery array -> object ndarray of Python ints."""
        a = np.asarray(jax.device_get(arr))
        shape = a.shape[:-1]
        flat = a.reshape(-1, self.L)
        out = np.empty((flat.shape[0],), dtype=object)
        for i in range(flat.shape[0]):
            out[i] = self.from_mont_limbs(flat[i])
        return out.reshape(shape)

    # ------------------------------------------------------------------
    # Constants as arrays
    # ------------------------------------------------------------------
    def zeros(self, shape=()) -> jnp.ndarray:
        return jnp.zeros(tuple(shape) + (self.L,), dtype=jnp.uint32)

    def ones(self, shape=()) -> jnp.ndarray:
        one = jnp.asarray(self._r_np)  # 1 in Montgomery form is R mod p
        return jnp.broadcast_to(one, tuple(shape) + (self.L,))

    def const(self, x: int, shape=()) -> jnp.ndarray:
        c = jnp.asarray(self.to_mont_int(x % self.p))
        return jnp.broadcast_to(c, tuple(shape) + (self.L,))

    # ------------------------------------------------------------------
    # Carry handling primitives
    # ------------------------------------------------------------------
    def _carry(self, cols: jnp.ndarray):
        """Propagate carries so every limb is < 2^16.

        ``cols``: [..., L] columns, each < ~2^31 (callers guarantee this).
        Returns (limbs, carry_out) where carry_out sits at position L.
        Backend-dependent like ``mul``: unrolled on the GPU (a lax.scan
        runs one kernel per limb step; unrolled, XLA fuses the chain into
        one memory pass); scan on CPU, where unrolled bodies inflate every
        enclosing scan's compile time.
        """
        if self._scan_form():
            def body(c, col):
                s = col + c
                return s >> LIMB_BITS, s & MASK

            cols_t = jnp.moveaxis(cols, -1, 0)
            carry, out = jax.lax.scan(body, jnp.zeros_like(cols_t[0]), cols_t)
            return jnp.moveaxis(out, 0, -1), carry
        c = jnp.zeros(cols.shape[:-1], jnp.uint32)
        limbs = []
        for j in range(self.L):
            s = cols[..., j] + c
            limbs.append(s & MASK)
            c = s >> LIMB_BITS
        return jnp.stack(limbs, axis=-1), c

    def _sub_limbs(self, a: jnp.ndarray, b_np: np.ndarray):
        """a - b for normalized a and a constant vector b.

        Returns (diff mod 2^(16L), borrow).  Backend-dependent (see _carry).
        """
        if self._scan_form():
            b = jnp.asarray(b_np, dtype=jnp.uint32)

            def body(borrow, ab):
                ai, bi = ab
                d = ai - bi - borrow  # wraps in uint32 when negative
                return (d >> 31) & jnp.uint32(1), d & MASK

            a_t = jnp.moveaxis(a, -1, 0)
            b_t = jnp.broadcast_to(
                b.reshape((self.L,) + (1,) * (a_t.ndim - 1)), a_t.shape
            )
            borrow, out = jax.lax.scan(body, jnp.zeros_like(a_t[0]), (a_t, b_t))
            return jnp.moveaxis(out, 0, -1), borrow
        borrow = jnp.zeros(a.shape[:-1], jnp.uint32)
        out = []
        for j in range(self.L):
            d = a[..., j] - jnp.uint32(int(b_np[j])) - borrow  # wraps in uint32
            borrow = (d >> 31) & jnp.uint32(1)
            out.append(d & MASK)
        return jnp.stack(out, axis=-1), borrow

    def _cond_sub_p(self, limbs: jnp.ndarray, extra: jnp.ndarray) -> jnp.ndarray:
        """Reduce a value < 2p to canonical form.

        value = limbs + extra * 2^(16L), extra in {0, 1}.  When extra = 1
        the borrow of the trial subtraction is absorbed by the extra bit.
        """
        diff, borrow = self._sub_limbs(limbs, self._p_np)
        take_diff = jnp.logical_or(extra > 0, borrow == 0)
        return jnp.where(take_diff[..., None], diff, limbs)

    # ------------------------------------------------------------------
    # Ring operations
    # ------------------------------------------------------------------
    def _kernel_op(self, op: str, a: jnp.ndarray, b: jnp.ndarray):
        """``op`` as one custom call where a kernel exists, else None."""
        ffi = self._ffi()
        if ffi is not None:
            a, b = jnp.broadcast_arrays(a, b)
            return ffi.binary(op, ffi.field_id(self.spec.name), a, b)
        gk = self._gpu()
        if gk is not None:
            a, b = jnp.broadcast_arrays(a, b)
            return gk.field_op(op, self.spec.name, a, b)
        return None

    def plain(self, op: str, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """The jnp limb form of "add" / "sub" / "mul" — what the kernels
        are checked against, and what fields without a kernel run."""
        return {"add": self._add_plain, "sub": self._sub_plain,
                "mul": self._mul_plain}[op](a, b)

    def add(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        out = self._kernel_op("add", a, b)
        return out if out is not None else self._add_plain(a, b)

    def _add_plain(self, a, b):
        limbs, carry = self._carry(a + b)
        return self._cond_sub_p(limbs, carry)

    def sub(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """a - b mod p computed as (a + p) - b with per-column +2^16 bias.

        Backend-dependent carry chain (see _carry)."""
        out = self._kernel_op("sub", a, b)
        return out if out is not None else self._sub_plain(a, b)

    def _sub_plain(self, a, b):
        p = jnp.asarray(self._p_np, dtype=jnp.uint32)
        cols = a + p + (MASK + jnp.uint32(1)) - b  # each column in [1, 2^18)
        if self._scan_form():
            def body(c, col):
                s = col + c  # c is the bias-corrected carry (may be -1)
                return (s >> LIMB_BITS) - jnp.uint32(1), s & MASK

            cols_t = jnp.moveaxis(cols, -1, 0)
            carry, out = jax.lax.scan(body, jnp.zeros_like(cols_t[0]), cols_t)
            limbs = jnp.moveaxis(out, 0, -1)
            return self._cond_sub_p(limbs, carry)
        c = jnp.zeros(cols.shape[:-1], jnp.uint32)
        limbs = []
        for j in range(self.L):
            s = cols[..., j] + c  # c may be 2^32-1 == -1 (bias-corrected)
            limbs.append(s & MASK)
            c = (s >> LIMB_BITS) - jnp.uint32(1)
        limbs = jnp.stack(limbs, axis=-1)
        # value = a + p - b in (0, 2p); carry is its bit at 2^(16L)
        return self._cond_sub_p(limbs, c)

    def neg(self, a: jnp.ndarray) -> jnp.ndarray:
        return self.sub(self.zeros(a.shape[:-1]), a)

    def mul(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Montgomery product  a * b * R^{-1} mod p  (CIOS).

        Backend-dependent: one custom call where a kernel exists (native
        FFI on the CPU, fields/ffi.py; CUDA field kernel on the GPU,
        cuda_kernels.py).  The plain form unrolls the L^2 limb loop at
        trace time on the GPU so XLA fuses the whole multiply into one
        elementwise kernel (a lax.scan runs one kernel per limb step), and
        keeps the scan on the CPU, whose XLA takes ~80 s to compile the
        ~1500-op unrolled graph."""
        out = self._kernel_op("mul", a, b)
        return out if out is not None else self._mul_plain(a, b)

    def _mul_plain(self, a, b):
        if self._scan_form():
            return self._mul_scan(a, b)
        return self._mul_unrolled(a, b)

    def _mul_unrolled(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        a, b = jnp.broadcast_arrays(a, b)
        n0inv = self._n0inv
        L = self.L
        p_ints = [jnp.uint32(int(v)) for v in self._p_np]

        batch_shape = a.shape[:-1]
        t = [jnp.zeros(batch_shape, jnp.uint32) for _ in range(L + 1)]
        for i in range(L):
            ai = a[..., i]
            for j in range(L):
                prod = ai * b[..., j]  # exact 32-bit products of 16-bit limbs
                t[j] = t[j] + (prod & MASK)
                t[j + 1] = t[j + 1] + (prod >> LIMB_BITS)
            m = ((t[0] & MASK) * n0inv) & MASK
            for j in range(L):
                mp = m * p_ints[j]
                t[j] = t[j] + (mp & MASK)
                t[j + 1] = t[j + 1] + (mp >> LIMB_BITS)
            carry = t[0] >> LIMB_BITS
            t = t[1:] + [jnp.zeros(batch_shape, jnp.uint32)]
            t[0] = t[0] + carry
        limbs, carry = self._carry(jnp.stack(t[:L], axis=-1))
        carry = carry + t[L]  # top column joins the carry-out (< 2 total)
        return self._cond_sub_p(limbs, carry)

    def _mul_scan(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        a, b = jnp.broadcast_arrays(a, b)
        p = jnp.asarray(self._p_np, dtype=jnp.uint32)
        n0inv = self._n0inv
        L = self.L

        batch_shape = a.shape[:-1]
        t0 = jnp.zeros(batch_shape + (L + 1,), dtype=jnp.uint32)
        a_t = jnp.moveaxis(a, -1, 0)  # [L, ...]

        def body(t, ai):
            prod = ai[..., None] * b  # [..., L] exact 32-bit products
            t = t.at[..., :L].add(prod & MASK)
            t = t.at[..., 1:].add(prod >> LIMB_BITS)
            m = ((t[..., 0] & MASK) * n0inv) & MASK
            mp = m[..., None] * p
            t = t.at[..., :L].add(mp & MASK)
            t = t.at[..., 1:].add(mp >> LIMB_BITS)
            carry = t[..., 0] >> LIMB_BITS
            t = jnp.concatenate(
                [t[..., 1:], jnp.zeros(batch_shape + (1,), jnp.uint32)], axis=-1
            )
            t = t.at[..., 0].add(carry)
            return t, None

        t, _ = jax.lax.scan(body, t0, a_t)
        limbs, carry = self._carry(t[..., :L])
        carry = carry + t[..., L]  # top column joins the carry-out (< 2 total)
        return self._cond_sub_p(limbs, carry)

    def sqr(self, a: jnp.ndarray) -> jnp.ndarray:
        return self.mul(a, a)

    # ------------------------------------------------------------------
    # Montgomery conversions (device side)
    # ------------------------------------------------------------------
    def encode(self, standard: jnp.ndarray) -> jnp.ndarray:
        """standard-form limbs -> Montgomery form."""
        return self.mul(standard, jnp.asarray(self._r2_np))

    def decode(self, mont: jnp.ndarray) -> jnp.ndarray:
        """Montgomery form -> standard-form limbs."""
        one = jnp.zeros((self.L,), jnp.uint32).at[0].set(1)
        return self.mul(mont, one)

    # ------------------------------------------------------------------
    # Exponentiation / inversion
    # ------------------------------------------------------------------
    def pow_const(self, a: jnp.ndarray, e: int) -> jnp.ndarray:
        """a^e for a fixed Python-int exponent.

        Square-and-multiply expressed as one ``lax.scan`` over the exponent
        bits (MSB first) so the traced graph stays two multiplies deep —
        compile time is constant in the exponent size.
        """
        if e == 0:
            return self.ones(a.shape[:-1])
        bits = jnp.asarray([int(b) for b in bin(e)[2:]], dtype=jnp.uint32)

        def body(acc, bit):
            acc = self.sqr(acc)
            acc_mul = self.mul(acc, a)
            return jnp.where((bit > 0)[..., None], acc_mul, acc), None

        out, _ = jax.lax.scan(body, self.ones(a.shape[:-1]), bits)
        return out

    def inv(self, a: jnp.ndarray) -> jnp.ndarray:
        """Batched inversion by Fermat (a^(p-2)); inv(0) = 0."""
        ffi = self._ffi()
        if ffi is not None:
            return ffi.inv(ffi.field_id(self.spec.name), a)
        return self.pow_const(a, self.p - 2)

    def batch_inv(self, a: jnp.ndarray) -> jnp.ndarray:
        """Invert along the second-to-last axis with the Montgomery trick.

        Uses log-depth prefix/suffix products (associative scans) plus a
        single Fermat inversion of the running product — ~6 multiplies per
        element instead of ~500 (this is the kernel behind the reference's
        ``h = num / den`` hot spot, dhyperplonk.rs:339).  Zero maps to zero.

        On the CPU FFI path the native inv custom call IS a serial batch
        inversion (~3 muls/element, field_ffi.cc InvImpl) — strictly
        better than n·log n scan multiplies on one core.
        """
        if self._ffi() is not None:
            return self.inv(a)
        is_zero = self.is_zero(a)
        safe = jnp.where(is_zero[..., None], self.ones(a.shape[:-1]), a)
        ax = a.ndim - 2
        prefix = jax.lax.associative_scan(self.mul, safe, axis=ax)
        suffix = jax.lax.associative_scan(self.mul, safe, axis=ax, reverse=True)
        total_inv = self.inv(prefix[..., -1:, :])
        ones = self.ones((1,))
        left = jnp.concatenate(
            [jnp.broadcast_to(ones, prefix[..., :1, :].shape), prefix[..., :-1, :]],
            axis=-2,
        )
        right = jnp.concatenate(
            [suffix[..., 1:, :], jnp.broadcast_to(ones, suffix[..., :1, :].shape)],
            axis=-2,
        )
        inv = self.mul(self.mul(left, right), total_inv)
        return jnp.where(is_zero[..., None], self.zeros(a.shape[:-1]), inv)

    # ------------------------------------------------------------------
    # Predicates / reductions
    # ------------------------------------------------------------------
    def is_zero(self, a: jnp.ndarray) -> jnp.ndarray:
        return jnp.all(a == 0, axis=-1)

    def equal(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        return jnp.all(a == b, axis=-1)

    def sum(self, a: jnp.ndarray, axis: int = -2) -> jnp.ndarray:
        """Field sum along ``axis`` (an axis of the batch, not the limb dim).

        Strategy: uint32 *column* sums are exact for up to 2^14 terms
        (columns stay < 2^30); larger reductions fold in chunks.  The
        accumulated columns are then reduced mod p, folding the carry-out
        c at 2^(16L) back in as c * R (one Montgomery multiply by R^2).
        """
        if axis < 0:
            axis = a.ndim + axis
        assert axis != a.ndim - 1, "cannot sum over the limb axis"
        CH = 1 << 14
        while a.shape[axis] > 1:
            n = a.shape[axis]
            take = min(n, CH)
            pad = (-n) % take
            if pad:
                zshape = list(a.shape)
                zshape[axis] = pad
                a = jnp.concatenate([a, jnp.zeros(zshape, a.dtype)], axis=axis)
            shp = list(a.shape)
            shp[axis : axis + 1] = [shp[axis] // take, take]
            cols = jnp.sum(a.reshape(shp), axis=axis + 1)  # exact in uint32
            a = self._reduce_u32_cols(cols)
        return jnp.squeeze(a, axis=axis)

    def _reduce_u32_cols(self, cols: jnp.ndarray) -> jnp.ndarray:
        """Reduce uint32 columns (each < 2^30) to a canonical element."""
        limbs, carry = self._carry(cols)  # carry < 2^16
        carry_el = jnp.zeros(limbs.shape, jnp.uint32).at[..., 0].set(carry)
        # carry * 2^(16L) mod p  ==  mont_mul(carry, R^2) = carry * R mod p
        carry_contrib = self.mul(carry_el, jnp.asarray(self._r2_np))
        # value(limbs) < 2^(16L) = R, which exceeds 2p (R/p ~ 2.2 for Fr,
        # ~9.8 for Fq): a single conditional subtract is NOT enough.
        # Ladder down with p << s (shifts whose subtrahend still fits in
        # 16L bits; larger ones can never trigger since value < 2^(16L)).
        R = 1 << (LIMB_BITS * self.L)
        for s in range((R // self.p).bit_length() - 1, 0, -1):
            if (self.p << s) < R:
                diff, borrow = self._sub_limbs(
                    limbs, int_to_limbs(self.p << s, self.L)
                )
                limbs = jnp.where((borrow == 0)[..., None], diff, limbs)
        limbs = self._cond_sub_p(limbs, jnp.zeros_like(carry))
        return self.add(limbs, carry_contrib)

    # ------------------------------------------------------------------
    # Random elements (host-side deterministic)
    # ------------------------------------------------------------------
    def random(self, shape, seed: int) -> jnp.ndarray:
        """Deterministic pseudo-uniform field elements, Montgomery form.

        Mirrors the reference's `random_evaluations`
        (dist-primitive/src/lib.rs:12) with an explicit seed so runs are
        reproducible.  The top limb is sampled below p's top limb so the
        value is always < p (negligible non-uniformity; inputs generated
        this way are benchmark placeholders, exactly as in the reference).
        """
        shape = tuple(shape)
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        limbs = rng.randint(0, 1 << LIMB_BITS, size=shape + (self.L,)).astype(np.uint32)
        top = int(self._p_np[self.L - 1])
        limbs[..., self.L - 1] %= max(top, 1)
        # encode to Montgomery form on device (vectorized)
        return self.encode(jnp.asarray(limbs))


@functools.lru_cache(maxsize=None)
def get_field(name: str, compact: bool = False) -> Field:
    from .config import FIELDS

    return Field(FIELDS[name], compact=compact)
