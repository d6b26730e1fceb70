"""Packed secret sharing (PSS) as batched linear maps.

Semantics follow the reference's ``PackedSharingParams``
(/root/reference/secret-sharing/src/pss.rs:17-171) exactly:

* n = 8l parties, threshold t = l-1;
* ``share``   domain: size n,   no coset offset;
* ``secret``  domain: size 2l,  coset of F.GENERATOR;
* ``secret2`` domain: size 4l,  coset of F.GENERATOR;
* ``pack_from_public``  = share.fft(secret.ifft(secrets))      (pss.rs:93-99)
* ``unpack``            = secret.fft(share.ifft(shares))[:l]   (pss.rs:132-149)
* ``unpack2``           = secret2.fft(share.ifft(shares))[0:2l:2] (pss.rs:153-171)
* ``pack_single``       = pack_from_public(share.fft(secret.ifft([s])))
                          including the arkworks resize-truncation in the
                          second ifft (pss.rs:103-113)

Everything is a *linear* map, so each op is also exposed as a host-built
matrix over Python ints (``*_matrix``).  The batched field path uses the
NTT module (O(n log n) per chunk, vectorized over the whole table); the
matrices drive the group-element variants and the fused party-axis
collective maps (where a leader's unpack→f→repack pipeline becomes one
matrix — no leader bottleneck on a mesh).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..fields.fr import Field
from ..ntt.ntt import Domain, intt, ntt


def _dft_matrix(p: int, size: int, offset: int, g: int) -> np.ndarray:
    """V[i, j] = (offset * g^i)^j  — evaluation matrix (object ints)."""
    V = np.empty((size, size), dtype=object)
    for i in range(size):
        x = offset * pow(g, i, p) % p
        acc = 1
        for j in range(size):
            V[i, j] = acc
            acc = acc * x % p
    return V


def _idft_matrix(p: int, size: int, offset: int, g: int) -> np.ndarray:
    """Vinv[j, i] = offset^{-j} g^{-ij} / size — interpolation matrix."""
    ninv = pow(size, -1, p)
    ginv = pow(g, -1, p)
    oinv = pow(offset, -1, p)
    M = np.empty((size, size), dtype=object)
    for j in range(size):
        scale = pow(oinv, j, p) * ninv % p
        for i in range(size):
            M[j, i] = scale * pow(ginv, i * j, p) % p
    return M


def _matmul_mod(A: np.ndarray, B: np.ndarray, p: int) -> np.ndarray:
    out = np.empty((A.shape[0], B.shape[1]), dtype=object)
    for i in range(A.shape[0]):
        for j in range(B.shape[1]):
            s = 0
            for k in range(A.shape[1]):
                s += A[i, k] * B[k, j]
            out[i, j] = s % p
    return out


class PackedSharingParams:
    """PSS parameters for one field and packing factor l (n = 8l parties)."""

    def __init__(self, field: Field, l: int):
        assert l & (l - 1) == 0 and l >= 1
        self.field = field
        self.l = l
        self.t = l - 1
        self.n = 8 * l
        name = field.spec.name
        gen = field.spec.generator
        self.dom_share = Domain(name, self.n, 1)
        self.dom_secret = Domain(name, 2 * l, gen)
        self.dom_secret2 = Domain(name, 4 * l, gen)

    # -- hashing so jitted closures cache correctly ----------------------
    def __hash__(self):
        return hash((self.field.spec.name, self.l))

    def __eq__(self, other):
        return (
            isinstance(other, PackedSharingParams)
            and self.field == other.field
            and self.l == other.l
        )

    # ------------------------------------------------------------------
    # Field-element path (batched over leading dims; element axis = -2)
    # ------------------------------------------------------------------
    def pack_from_public(self, secrets: jnp.ndarray) -> jnp.ndarray:
        """[..., l, L] secrets -> [..., n, L] shares (deterministic)."""
        coeffs = intt(self.field, self.dom_secret, secrets)
        return ntt(self.field, self.dom_share, coeffs)

    def pack_from_public_rand(self, secrets: jnp.ndarray, seed: int) -> jnp.ndarray:
        """Append t+1 random evaluation points before packing (pss.rs:76-89)."""
        rand = self.field.random(secrets.shape[:-2] + (self.t + 1,), seed)
        ext = jnp.concatenate([secrets, rand], axis=-2)
        coeffs = intt(self.field, self.dom_secret, ext)
        return ntt(self.field, self.dom_share, coeffs)

    def unpack(self, shares: jnp.ndarray) -> jnp.ndarray:
        """[..., n, L] degree-(t+l) shares -> [..., l, L] secrets.

        With ``SCZK_DEBUG_PSS=1`` additionally checks (host-side) that
        the interpolated polynomial's coefficients above degree t+l
        vanish — the reference's debug assertion (pss.rs:137-142) that a
        well-formed degree-(t+l) sharing must satisfy.
        """
        coeffs = intt(self.field, self.dom_share, shares)
        import os

        if os.environ.get("SCZK_DEBUG_PSS"):
            import jax

            if isinstance(coeffs, jax.core.Tracer):
                pass  # host check needs concrete values; skip under jit
            else:
                hi = jax.device_get(coeffs[..., self.t + self.l + 1 :, :])
                if hi.size and hi.any():
                    raise AssertionError(
                        "unpack: coefficients above degree t+l are non-zero "
                        "(not a valid degree-(t+l) packed sharing; "
                        "pss.rs:137-142 debug assertion)"
                    )
        evals = ntt(self.field, self.dom_secret, coeffs)
        return evals[..., : self.l, :]

    def unpack2(self, shares: jnp.ndarray) -> jnp.ndarray:
        """[..., n, L] degree-2(t+l) shares -> [..., l, L] secrets."""
        coeffs = intt(self.field, self.dom_share, shares)
        evals = ntt(self.field, self.dom_secret2, coeffs)
        return evals[..., 0 : 2 * self.l : 2, :]

    def pack_single(self, secret: jnp.ndarray) -> jnp.ndarray:
        """[..., L] one secret -> [..., n, L] regular (single-secret) shares.

        Mirrors pss.rs:103-113 including the double application of the
        packing transform (the second ifft truncates the n intermediate
        values to the 2l secret-domain size, exactly like arkworks'
        ``resize``).
        """
        evals = secret[..., None, :]  # [., 1, L]; intt zero-pads to 2l
        coeffs = intt(self.field, self.dom_secret, evals)
        mid = ntt(self.field, self.dom_share, coeffs)  # [., n, L]
        # second pack: intt truncates mid to the 2l secret-domain size
        return self.pack_from_public(mid)

    def pack_single_reconstructible(self, secret: jnp.ndarray) -> jnp.ndarray:
        """[..., L] one secret -> [..., n, L] valid single-secret shares.

        DOCUMENTED DEVIATION from pss.rs:103-113: the reference applies the
        packing transform *twice* (the trailing ``pack_from_public_in_place``
        call), which mixes evaluation domains and yields shares that no
        longer reconstruct the secret under ``unpack`` (verified against
        the reference semantics in tests).  This variant performs the
        single transform — shares are evaluations of the degree-(t+l)
        polynomial with value ``secret`` at secret-slot 0 and 0 at the
        other secret slots, so ``unpack`` returns [s, 0, ..., 0].  Cost
        and communication are identical; pss2ss uses this variant so the
        collaborative sumcheck transcripts verify.
        """
        evals = secret[..., None, :]
        coeffs = intt(self.field, self.dom_secret, evals)
        return ntt(self.field, self.dom_share, coeffs)

    def pack_single_reconstructible_vector(self) -> np.ndarray:
        """[n] object-int vector u: shares_j = u_j * secret (single transform)."""
        p = self.field.p
        l, n = self.l, self.n
        g_share = self.field.spec.root_of_unity(n) if n > 1 else 1
        g_sec = self.field.spec.root_of_unity(2 * l)
        off = self.field.spec.generator
        V_share = _dft_matrix(p, n, 1, g_share)
        Vi_sec = _idft_matrix(p, 2 * l, off, g_sec)
        u = _matmul_mod(V_share[:, : 2 * l], Vi_sec[:, :1], p)
        return u[:, 0]

    # ------------------------------------------------------------------
    # Host-side exact linear maps (object-int matrices, cached)
    # ------------------------------------------------------------------
    @functools.cached_property
    def _mats(self):
        p = self.field.p
        l, n = self.l, self.n
        g_share = self.field.spec.root_of_unity(n) if n > 1 else 1
        g_sec = self.field.spec.root_of_unity(2 * l)
        g_sec2 = self.field.spec.root_of_unity(4 * l)
        off = self.field.spec.generator

        V_share = _dft_matrix(p, n, 1, g_share)  # [n, n] coeff->share evals
        Vi_share = _idft_matrix(p, n, 1, g_share)  # [n, n] share evals->coeffs
        V_sec = _dft_matrix(p, 2 * l, off, g_sec)
        Vi_sec = _idft_matrix(p, 2 * l, off, g_sec)
        V_sec2 = _dft_matrix(p, 4 * l, off, g_sec2)

        # pack: secrets(l) -> coeffs(2l) -> shares(n)
        pack = _matmul_mod(V_share[:, : 2 * l], Vi_sec[:, :l], p)  # [n, l]
        # unpack: shares(n) -> coeffs(n)[:2l] -> secret evals(2l)[:l]
        unpack = _matmul_mod(V_sec[:l, :], Vi_share[: 2 * l, :], p)  # [l, n]
        # unpack2: shares(n) -> coeffs(n)[:4l] -> secret2 evals[0:2l:2]
        unpack2 = _matmul_mod(V_sec2[0 : 2 * l : 2, :], Vi_share[: 4 * l, :], p)  # [l, n]
        # pack_single: s -> [s,0...] -> coeffs -> share evals(n) -> truncate 2l
        #              -> coeffs -> share evals(n)
        first = _matmul_mod(V_share[:, : 2 * l], Vi_sec[:, :1], p)  # [n, 1]
        mid = first[: 2 * l, :]
        psingle = _matmul_mod(
            _matmul_mod(V_share[:, : 2 * l], Vi_sec, p), mid, p
        )  # [n, 1]
        return {
            "pack": pack,
            "unpack": unpack,
            "unpack2": unpack2,
            "pack_single": psingle[:, 0],
        }

    def pack_matrix(self) -> np.ndarray:
        """[n, l] object-int matrix: shares = pack @ secrets."""
        return self._mats["pack"]

    def unpack_matrix(self) -> np.ndarray:
        return self._mats["unpack"]

    def unpack2_matrix(self) -> np.ndarray:
        return self._mats["unpack2"]

    def pack_single_vector(self) -> np.ndarray:
        """[n] object-int vector u: shares_j = u_j * secret."""
        return self._mats["pack_single"]

    # ------------------------------------------------------------------
    # Group-element path (points: pytrees of Fq limb arrays; see curves.g1)
    # ------------------------------------------------------------------
    def pack_from_public_group(self, curve, secrets):
        """Pack G1 points: [., l] points -> [., n] share points.

        Applies the exact same linear map as the field path (DomainCoeff
        genericity in pss.rs:69 — FFT over group elements), realized as a
        fixed-scalar multi-scalar combination per output share.
        """
        return curve.linear_map(self.pack_matrix(), secrets)

    def unpack_group(self, curve, shares):
        return curve.linear_map(self.unpack_matrix(), shares)

    def unpack2_group(self, curve, shares):
        return curve.linear_map(self.unpack2_matrix(), shares)

    # G2 (host-exact): G2 lives only on the SRS/verify side
    # (dpoly_comm.rs powers_of_g2), so the DomainCoeff genericity of
    # pss.rs:69 is realized for it with host-int affine points.
    def pack_from_public_g2(self, pts):
        """[l] host G2 affine points -> [n] share points."""
        from ..curves.host_curve import g2_linear_map

        return g2_linear_map(self.pack_matrix(), pts)

    def unpack_g2(self, shares):
        from ..curves.host_curve import g2_linear_map

        return g2_linear_map(self.unpack_matrix(), shares)

    def unpack2_g2(self, shares):
        from ..curves.host_curve import g2_linear_map

        return g2_linear_map(self.unpack2_matrix(), shares)
