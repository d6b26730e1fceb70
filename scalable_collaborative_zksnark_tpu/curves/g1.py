"""Batched short-Weierstrass G1 arithmetic in Jacobian coordinates.

Points are pytrees ``(X, Y, Z)`` of Fq limb arrays shaped ``[..., L]``
(Jacobian: x = X/Z^2, y = Y/Z^3; Z == 0 encodes infinity).  All ops are
complete (branch-free ``where`` selection between the generic-add,
double, and infinity cases) so they can run under ``vmap``/``scan``/
``associative_scan`` with no data-dependent control flow — the shape MSM
and PSS-over-G1 need on an accelerator.  On the GPU each group-law op
is one fused CUDA kernel (cuda_kernels.py); the jnp formulas
below are the plain form it is checked against.

Formulas: standard a=0 Jacobian dbl-2009-l / add-2007-bl (the same
family arkworks uses underneath `Projective` in the reference's
G1 arithmetic; cf. dmsm.rs tests using `ark_bls12_377::G1Projective`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..fields.config import LIMB_BITS
from ..fields.fr import Field, get_field


class PointJ(NamedTuple):
    """Jacobian point batch (pytree of uint32 limb arrays)."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    @property
    def batch_shape(self):
        return self.x.shape[:-1]


try:  # let jax.export serialize pytrees containing PointJ (phase cache)
    jax.export.register_namedtuple_serialization(
        PointJ, serialized_name="sczk.curves.PointJ"
    )
except (AttributeError, ValueError):  # older jax / double registration
    pass


class Curve:
    """y^2 = x^3 + b over a base field (a = 0), with device-batched ops."""

    def __init__(self, name: str, fq: Field, b: int, fr: Field):
        self.name = name
        # Group-law arithmetic always sits inside scans (scalar_mul bits,
        # MSM windows, tree sums), where an unrolled CIOS body per mul
        # inflates compiles to minutes per executable; a compact
        # (scan-form) field keeps those bodies small (see Field.__init__).
        self.fq = get_field(fq.spec.name, compact=True)
        self.fr = fr
        self.b = b
        # trace-once caching for the group law (see Field.__init__ note);
        # scalar_mul wraps scans that close over their
        # inputs and MUST be jitted to avoid per-call re-lowering
        self.add = jax.jit(self.add)
        self.double = jax.jit(self.double)
        self.scalar_mul = jax.jit(self.scalar_mul)

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, Curve) and self.name == other.name

    def _ffi(self):
        """Native CPU kernel module, or None (GPU / no toolchain).

        On CPU, scalar_mul / sum / linear_map / MSM each lower to ONE
        custom call into 64-bit Jacobian arithmetic (native/field_ffi.cc)
        instead of a 256-iteration scan of ~40 field ops per bit — both
        a large runtime win and the difference between minutes and
        seconds of XLA:CPU compile for protocol graphs."""
        return backend.native_ffi()

    def _ffi_fid(self, ffi):
        return ffi.field_id(self.fq.spec.name)

    def _kernel(self, op: str, *pts: PointJ, mask=None):
        """The fused point kernel for ``op`` on the GPU, else None.

        Operands broadcast to one batch shape; returns a PointJ (plus the
        doubling flags for ``add_reset_lazy``)."""
        from .. import cuda_kernels

        if not backend.point_kernels() or self.fq.spec.name != cuda_kernels.FQ:
            return None

        shape = jnp.broadcast_shapes(*(p.x.shape for p in pts))
        coords = [jnp.broadcast_to(a, shape) for p in pts for a in p]
        if mask is not None:
            mask = jnp.broadcast_to(mask, shape[:-1])
        out = cuda_kernels.point_op(op, self.fq.spec.name, coords, mask=mask)
        pt = PointJ(*out[:3])
        return (pt, out[3]) if op == "add_reset_lazy" else pt

    # -- constructors ----------------------------------------------------
    def infinity(self, shape=()) -> PointJ:
        z = self.fq.zeros(shape)
        return PointJ(self.fq.zeros(shape), self.fq.ones(shape), z)

    def from_affine_ints(self, coords) -> PointJ:
        """List of (x, y) int pairs or None (infinity) -> batched PointJ."""
        xs, ys, zs = [], [], []
        for c in coords:
            if c is None:
                xs.append(0)
                ys.append(1)
                zs.append(0)
            else:
                xs.append(c[0])
                ys.append(c[1])
                zs.append(1)
        return PointJ(
            self.fq.array_from_ints(xs),
            self.fq.array_from_ints(ys),
            self.fq.array_from_ints(zs),
        )

    def to_affine_ints(self, pt: PointJ):
        """Batched PointJ -> list of (x, y) tuples or None (host side)."""
        X = self.fq.array_to_ints(pt.x).reshape(-1)
        Y = self.fq.array_to_ints(pt.y).reshape(-1)
        Z = self.fq.array_to_ints(pt.z).reshape(-1)
        out = []
        p = self.fq.p
        for xi, yi, zi in zip(X, Y, Z):
            xi, yi, zi = int(xi), int(yi), int(zi)
            if zi == 0:
                out.append(None)
            else:
                zinv = pow(zi, -1, p)
                out.append((xi * zinv * zinv % p, yi * zinv * zinv * zinv % p))
        return out

    # -- core group law --------------------------------------------------
    def double(self, pt: PointJ) -> PointJ:
        out = self._kernel("double", pt)
        return out if out is not None else self._double_plain(pt)

    def _double_plain(self, pt: PointJ) -> PointJ:
        F = self.fq
        X, Y, Z = pt
        A = F.sqr(X)
        B = F.sqr(Y)
        C = F.sqr(B)
        t = F.sqr(F.add(X, B))
        D = F.add(F.sub(F.sub(t, A), C), F.sub(F.sub(t, A), C))  # 2((X+B)^2-A-C)
        E = F.add(F.add(A, A), A)  # 3A
        G = F.sqr(E)
        X3 = F.sub(G, F.add(D, D))
        C8 = F.add(F.add(F.add(C, C), F.add(C, C)), F.add(F.add(C, C), F.add(C, C)))
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
        Z3 = F.add(F.mul(Y, Z), F.mul(Y, Z))
        # doubling infinity or a 2-torsion (Y=0) point -> infinity
        inf = F.is_zero(Z)
        Z3 = jnp.where(inf[..., None], F.zeros(Z3.shape[:-1]), Z3)
        return PointJ(X3, Y3, Z3)

    def add(self, p1: PointJ, p2: PointJ) -> PointJ:
        out = self._kernel("add", p1, p2)
        return out if out is not None else self._add_plain(p1, p2)

    def _add_plain(self, p1: PointJ, p2: PointJ) -> PointJ:
        F = self.fq
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        Z1Z1 = F.sqr(Z1)
        Z2Z2 = F.sqr(Z2)
        U1 = F.mul(X1, Z2Z2)
        U2 = F.mul(X2, Z1Z1)
        S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
        S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
        H = F.sub(U2, U1)
        r = F.sub(S2, S1)
        HH = F.sqr(H)
        I = F.add(F.add(HH, HH), F.add(HH, HH))  # (2H)^2
        J = F.mul(H, I)
        r2 = F.add(r, r)
        V = F.mul(U1, I)
        X3 = F.sub(F.sub(F.sqr(r2), J), F.add(V, V))
        Y3 = F.sub(F.mul(r2, F.sub(V, X3)), F.add(F.mul(S1, J), F.mul(S1, J)))
        Z3 = F.mul(H, F.sub(F.sub(F.sqr(F.add(Z1, Z2)), Z1Z1), Z2Z2))
        gen = PointJ(X3, Y3, Z3)

        inf1 = F.is_zero(Z1)[..., None]
        inf2 = F.is_zero(Z2)[..., None]
        same_x = jnp.logical_and(F.is_zero(H), jnp.logical_not(F.is_zero(Z1) | F.is_zero(Z2)))
        is_dbl = jnp.logical_and(same_x, F.is_zero(r))[..., None]
        is_cancel = jnp.logical_and(same_x, jnp.logical_not(F.is_zero(r)))[..., None]

        dbl = self._double_plain(p1)

        def sel(a, b, cond):
            return jax.tree.map(lambda u, v: jnp.where(cond, u, v), a, b)

        out = sel(dbl, gen, is_dbl)
        out = sel(self.infinity(X3.shape[:-1]), out, is_cancel)
        out = sel(p1, out, inf2)
        out = sel(p2, out, inf1)
        return out

    def add_mixed(self, p1: PointJ, p2: PointJ) -> PointJ:
        """p1 (Jacobian) + p2 with z2 ∈ {0, 1} (affine or infinity).

        madd-2007-bl: saves ~1/3 of the field muls of the general add.
        Used by the bucket-serial MSM where all input points are
        pre-normalized to affine (msm.py).
        """
        out = self._kernel("add_mixed", p1, p2)
        return out if out is not None else self._add_mixed_plain(p1, p2)

    def _add_mixed_plain(self, p1: PointJ, p2: PointJ) -> PointJ:
        F = self.fq
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        Z1Z1 = F.sqr(Z1)
        U2 = F.mul(X2, Z1Z1)
        S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
        H = F.sub(U2, X1)
        r = F.sub(S2, Y1)
        HH = F.sqr(H)
        I = F.add(F.add(HH, HH), F.add(HH, HH))
        J = F.mul(H, I)
        r2 = F.add(r, r)
        V = F.mul(X1, I)
        X3 = F.sub(F.sub(F.sqr(r2), J), F.add(V, V))
        Y3 = F.sub(F.mul(r2, F.sub(V, X3)), F.add(F.mul(Y1, J), F.mul(Y1, J)))
        Z3 = F.mul(F.add(Z1, Z1), H)  # 2 Z1 H (z2 == 1 by contract)
        gen = PointJ(X3, Y3, Z3)

        inf1 = F.is_zero(Z1)[..., None]
        inf2 = F.is_zero(Z2)[..., None]
        same_x = jnp.logical_and(
            F.is_zero(H), jnp.logical_not(F.is_zero(Z1) | F.is_zero(Z2))
        )
        is_dbl = jnp.logical_and(same_x, F.is_zero(r))[..., None]
        is_cancel = jnp.logical_and(same_x, jnp.logical_not(F.is_zero(r)))[..., None]

        dbl = self._double_plain(p1)

        def sel(a, b, cond):
            return jax.tree.map(lambda u, v: jnp.where(cond, u, v), a, b)

        out = sel(dbl, gen, is_dbl)
        out = sel(self.infinity(X3.shape[:-1]), out, is_cancel)
        out = sel(p1, out, inf2)
        out = sel(p2, out, inf1)
        return out

    def add_mixed_masked(self, p1: PointJ, p2: PointJ, valid) -> PointJ:
        """valid ? p1 + p2(mixed) : p1 — one fused kernel on the GPU.

        This is the bucket-serial MSM accumulate step; fusing the select
        avoids materializing the unselected sum in device memory."""
        out = self._kernel("add_masked", p1, p2, mask=valid)
        if out is not None:
            return out
        return self.point_op_plain("add_masked", p1, p2, mask=valid)

    def add_mixed_reset(self, p1: PointJ, p2: PointJ, same) -> PointJ:
        """same ? p1 + p2(mixed) : p2 — the dense-MSM segment step
        (one fused kernel on the GPU; msm.py::_dense_bucket_sums)."""
        out = self._kernel("add_reset", p1, p2, mask=same)
        if out is not None:
            return out
        return self.point_op_plain("add_reset", p1, p2, mask=same)

    def add_mixed_reset_lazy(self, p1: PointJ, p2: PointJ, same):
        """(same ? p1 + p2 : p2, dbl_flag) without the doubling branch.

        Flagged lanes (x-collision while accumulating — probability
        ~2^-255 for distinct random points) carry garbage; the caller
        repairs them under a lax.cond that almost never runs.  The
        plain form computes the complete add (flag all-False).
        """
        out = self._kernel("add_reset_lazy", p1, p2, mask=same)
        if out is not None:
            return out
        return self.point_op_plain("add_reset_lazy", p1, p2, mask=same)

    def point_op_plain(self, op: str, p1: PointJ, p2: PointJ = None,
                       mask=None):
        """The jnp form of a fused kernel op (cuda_kernels.OPS): what the
        kernel is checked against, on any backend."""
        if op == "double":
            return self._double_plain(p1)
        if op == "add":
            return self._add_plain(p1, p2)
        s = self._add_mixed_plain(p1, p2)
        if op == "add_mixed":
            return s
        if op == "add_masked":
            return self.select(mask, s, p1)
        out = self.select(mask, s, p2)
        if op == "add_reset":
            return out
        return out, jnp.zeros(out.x.shape[:-1], bool)  # add_reset_lazy

    def normalize(self, pt: PointJ) -> PointJ:
        """Jacobian -> affine-or-infinity (z ∈ {0, 1}), batched.

        One batched inversion for the whole array (batch_inv over a
        flattened axis); infinity stays (0, 1, 0).
        """
        F = self.fq
        shape = pt.x.shape[:-1]
        flat = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[-1:]), pt)
        zinv = F.batch_inv(flat.z)  # inv(0) = 0
        zi2 = F.sqr(zinv)
        x = F.mul(flat.x, zi2)
        y = F.mul(flat.y, F.mul(zi2, zinv))
        inf = F.is_zero(flat.z)[..., None]
        one = F.ones(flat.z.shape[:-1])
        z = jnp.where(inf, F.zeros(flat.z.shape[:-1]), one)
        y = jnp.where(inf, one, y)
        x = jnp.where(inf, F.zeros(flat.z.shape[:-1]), x)
        out = PointJ(x, y, z)
        return jax.tree.map(lambda a: a.reshape(shape + a.shape[-1:]), out)

    def neg(self, pt: PointJ) -> PointJ:
        return PointJ(pt.x, self.fq.neg(pt.y), pt.z)

    def select(self, cond, a: PointJ, b: PointJ) -> PointJ:
        """Elementwise select: cond ? a : b  (cond shaped like batch)."""
        c = cond[..., None]
        return jax.tree.map(lambda u, v: jnp.where(c, u, v), a, b)

    # -- reductions ------------------------------------------------------
    def sum(self, pt: PointJ, axis: int = 0) -> PointJ:
        """Tree-reduction point sum along a batch axis."""
        if axis < 0:
            axis = pt.x.ndim - 1 + axis
        ffi = self._ffi()
        if ffi is not None and pt.x.shape[axis] > 1:
            arr = jax.tree.map(lambda a: jnp.moveaxis(a, axis, -2), pt)
            K = arr.x.shape[-2]
            out_shape = arr.x.shape[:-2] + (self.fq.L,)
            ox, oy, oz = ffi.g1_op(
                2, self._ffi_fid(ffi), arr.x, arr.y, arr.z,
                jnp.zeros((4,), jnp.uint32), out_shape, K, 1,
            )
            return PointJ(ox, oy, oz)
        p = pt
        n = p.x.shape[axis]
        while n > 1:
            half = n // 2
            lo = jax.tree.map(lambda a: jax.lax.slice_in_dim(a, 0, half, axis=axis), p)
            hi = jax.tree.map(
                lambda a: jax.lax.slice_in_dim(a, half, 2 * half, axis=axis), p
            )
            s = self.add(lo, hi)
            if n % 2:
                rest = jax.tree.map(
                    lambda a: jax.lax.slice_in_dim(a, 2 * half, n, axis=axis), p
                )
                s = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=axis), s, rest)
                n = half + 1
            else:
                n = half
            p = s
        return jax.tree.map(lambda a: jnp.squeeze(a, axis=axis), p)

    # -- scalar multiplication -------------------------------------------
    def scalar_mul(self, pt: PointJ, scalar_std: jnp.ndarray) -> PointJ:
        """Multiply by per-element scalars given as *standard-form* Fr limbs.

        One scan over scalar bits (MSB first): acc = 2*acc (+ P if bit).
        jitted in __init__ (the scan closes over pt/scalars — see fr.py).
        On CPU: one native custom call (see _ffi).
        """
        ffi = self._ffi()
        if ffi is not None:
            if scalar_std.shape[-1] % 4:  # native kernel wants u64 words
                padl = 4 - scalar_std.shape[-1] % 4
                scalar_std = jnp.concatenate(
                    [
                        scalar_std,
                        jnp.zeros(scalar_std.shape[:-1] + (padl,), jnp.uint32),
                    ],
                    axis=-1,
                )
            bshape = jnp.broadcast_shapes(
                pt.x.shape[:-1], scalar_std.shape[:-1]
            )
            ptb = jax.tree.map(
                lambda a: jnp.broadcast_to(a, bshape + a.shape[-1:]), pt
            )
            sb = jnp.broadcast_to(scalar_std, bshape + scalar_std.shape[-1:])
            ox, oy, oz = ffi.g1_op(
                1, self._ffi_fid(ffi), ptb.x, ptb.y, ptb.z, sb,
                ptb.x.shape, 1, 1,
            )
            return PointJ(ox, oy, oz)
        bshape = jnp.broadcast_shapes(pt.x.shape[:-1], scalar_std.shape[:-1])
        pt = jax.tree.map(
            lambda a: jnp.broadcast_to(a, bshape + a.shape[-1:]), pt
        )
        nbits = scalar_std.shape[-1] * LIMB_BITS
        bit_idx = jnp.arange(nbits - 1, -1, -1, dtype=jnp.uint32)

        def body(acc, t):
            acc = self.double(acc)
            limb = t // LIMB_BITS
            off = t % LIMB_BITS
            bit = (jnp.take(scalar_std, limb, axis=-1) >> off) & jnp.uint32(1)
            return self.select(bit > 0, self.add(acc, pt), acc), None

        acc0 = self.infinity(pt.batch_shape)
        out, _ = jax.lax.scan(body, acc0, bit_idx)
        return out

    def scalar_mul_int(self, pt: PointJ, scalars) -> PointJ:
        """Multiply by host-known int scalars (list broadcastable to batch)."""
        arr = np.asarray(scalars, dtype=object)
        L = self.fr.L
        from ..fields.config import int_to_limbs

        flat = arr.reshape(-1)
        limbs = np.stack([int_to_limbs(int(v) % self.fr.p, L) for v in flat])
        std = jnp.asarray(limbs.reshape(arr.shape + (L,)))
        return self.scalar_mul(pt, std)

    # -- fixed linear maps (PSS over G1) ---------------------------------
    def linear_map(self, matrix_obj: np.ndarray, pts: PointJ) -> PointJ:
        """Apply a fixed [out, in] int matrix over the points axis (-1).

        out[o] = sum_i M[o, i] * P[..., i].  Used for PSS pack/unpack of
        group elements (DomainCoeff genericity, pss.rs:69) and for the
        fused leader reduction in d_msm — each output is a small
        fixed-scalar MSM: one batched double-and-add scan over all
        (o, i) products, then a log2(in) tree sum.  (An earlier bit-mask
        formulation ran an in-axis tree sum inside every one of the 255
        scan steps — ~2000 sequential tiny kernels per call; this one
        runs ~520.)
        """
        n_out, n_in = matrix_obj.shape
        from ..fields.config import int_to_limbs

        Lr = self.fr.L
        scal = np.zeros((n_out, n_in, Lr), dtype=np.uint32)
        for o in range(n_out):
            for i in range(n_in):
                scal[o, i] = int_to_limbs(int(matrix_obj[o, i]) % self.fr.p, Lr)
        ffi = self._ffi()
        if ffi is not None:
            out_shape = pts.x.shape[:-2] + (n_out, self.fq.L)
            ox, oy, oz = ffi.g1_op(
                3, self._ffi_fid(ffi), pts.x, pts.y, pts.z,
                jnp.asarray(scal), out_shape, n_in, n_out,
            )
            return PointJ(ox, oy, oz)
        # [..., out, in] products via the shared double-and-add scan
        ptb = jax.tree.map(
            lambda a: jnp.broadcast_to(
                a[..., None, :, :],
                a.shape[:-2] + (n_out, n_in, a.shape[-1]),
            ),
            pts,
        )
        prods = self.scalar_mul(ptb, jnp.asarray(scal))
        return self.sum(prods, axis=-1)

    # -- validity --------------------------------------------------------
    def is_on_curve(self, pt: PointJ) -> jnp.ndarray:
        """Y^2 == X^3 + b Z^6 (Jacobian), or infinity."""
        F = self.fq
        lhs = F.sqr(pt.y)
        z2 = F.sqr(pt.z)
        z6 = F.mul(F.sqr(z2), z2)
        rhs = F.add(F.mul(F.sqr(pt.x), pt.x), F.mul(F.const(self.b, ()), z6))
        return jnp.logical_or(F.is_zero(pt.z), F.equal(lhs, rhs))

    def equal(self, p1: PointJ, p2: PointJ) -> jnp.ndarray:
        """Projective equality: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3."""
        F = self.fq
        z11, z22 = F.sqr(p1.z), F.sqr(p2.z)
        ex = F.equal(F.mul(p1.x, z22), F.mul(p2.x, z11))
        ey = F.equal(F.mul(F.mul(p1.y, p2.z), z22), F.mul(F.mul(p2.y, p1.z), z11))
        both_inf = jnp.logical_and(F.is_zero(p1.z), F.is_zero(p2.z))
        one_inf = jnp.logical_xor(F.is_zero(p1.z), F.is_zero(p2.z))
        return jnp.where(
            both_inf, True, jnp.where(one_inf, False, jnp.logical_and(ex, ey))
        )


# ---------------------------------------------------------------------------
# Standard instances
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def bls12_381_g1() -> Curve:
    return Curve("bls12_381_g1", get_field("bls12_381_fq"), 4, get_field("bls12_381_fr"))


@functools.lru_cache(maxsize=None)
def bls12_377_g1() -> Curve:
    return Curve("bls12_377_g1", get_field("bls12_377_fq"), 1, get_field("bls12_377_fr"))


# Standard generator of BLS12-381 G1 (draft-irtf-cfrg-pairing-friendly-curves).
BLS12_381_G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
