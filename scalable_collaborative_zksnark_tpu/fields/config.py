"""Field specifications for the collaborative zkSNARK framework.

A field element lives on-device as an array of 16-bit limbs stored in
``uint32`` lanes, least-significant limb first, in Montgomery form with
R = 2**(16 * num_limbs).  16-bit limbs are chosen so that a limb product
(<= (2**16-1)**2) fits exactly in a uint32 lane and so that redundant
column accumulation during CIOS Montgomery multiplication never overflows
(see fields/fr.py for the bound analysis).

Reference parity: the reference implementation uses arkworks' Rust bigint
arithmetic for BLS12-377 (unit tests) and BLS12-381 (benchmarks); see
e.g. /root/reference/dist-primitive/Cargo.toml and
/root/reference/secret-sharing/src/pss.rs:181.  The moduli, multiplicative
generators, and two-adicity below are the standard published curve
constants (identical to arkworks' `Fr`/`Fq` configurations); roots of
unity are derived from them at import time.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, num_limbs: int) -> np.ndarray:
    """Little-endian 16-bit limb decomposition of a Python int."""
    assert 0 <= x < (1 << (LIMB_BITS * num_limbs))
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(num_limbs)],
        dtype=np.uint32,
    )


def limbs_to_int(limbs) -> int:
    """Recompose a little-endian limb vector (any per-limb magnitude) to int."""
    out = 0
    for i, v in enumerate(np.asarray(limbs, dtype=np.uint64).tolist()):
        out += int(v) << (LIMB_BITS * i)
    return out


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field for limb-vector arithmetic."""

    name: str
    modulus: int
    # Smallest multiplicative generator (matches arkworks GENERATOR) —
    # used as the coset offset of PSS secret domains (pss.rs:46,50).
    generator: int
    num_limbs: int = 0
    two_adicity: int = field(init=False, default=0)

    def __post_init__(self):
        p = self.modulus
        if self.num_limbs == 0:
            nl = (p.bit_length() + LIMB_BITS - 1) // LIMB_BITS
            object.__setattr__(self, "num_limbs", nl)
        s = 0
        t = p - 1
        while t % 2 == 0:
            t //= 2
            s += 1
        object.__setattr__(self, "two_adicity", s)

    # ---- host-side (Python int) helpers --------------------------------
    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def r(self) -> int:
        """Montgomery radix R = 2^(16 * num_limbs) mod p."""
        return (1 << (LIMB_BITS * self.num_limbs)) % self.modulus

    @property
    def r2(self) -> int:
        return pow(1 << (LIMB_BITS * self.num_limbs), 2, self.modulus)

    @property
    def n0inv(self) -> int:
        """-p^{-1} mod 2^16 (per-limb Montgomery factor)."""
        return (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @property
    def rinv(self) -> int:
        return pow(1 << (LIMB_BITS * self.num_limbs), -1, self.modulus)

    @functools.lru_cache(maxsize=None)
    def root_of_unity(self, order: int) -> int:
        """Primitive `order`-th root of unity (order must be a power of 2).

        Derived exactly as arkworks does: GENERATOR^((p-1)/2^s) is the
        2^s-th two-adic root; smaller orders square it down.
        """
        assert order & (order - 1) == 0, "order must be a power of two"
        log = order.bit_length() - 1
        assert log <= self.two_adicity, f"no root of unity of order {order}"
        t = (self.modulus - 1) >> self.two_adicity
        root = pow(self.generator, t, self.modulus)
        for _ in range(self.two_adicity - log):
            root = root * root % self.modulus
        return root

    # ---- numpy constant tables -----------------------------------------
    @property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.num_limbs)

    @property
    def pneg_limbs(self) -> np.ndarray:
        """2^(16L) - p  (used for the carry-out comparison trick)."""
        return int_to_limbs((1 << (LIMB_BITS * self.num_limbs)) - self.modulus, self.num_limbs)

    @property
    def r_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r, self.num_limbs)

    @property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r2, self.num_limbs)


# ---------------------------------------------------------------------------
# Standard fields (constants identical to arkworks configurations).
# ---------------------------------------------------------------------------

# BLS12-381 scalar field (arkworks ark-bls12-381 Fr: GENERATOR = 7).
BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    modulus=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    generator=7,
)

# BLS12-381 base field (arkworks ark-bls12-381 Fq: GENERATOR = 2).
BLS12_381_FQ = FieldSpec(
    name="bls12_381_fq",
    modulus=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    generator=2,
)

# BLS12-377 scalar field (arkworks ark-bls12-377 Fr: GENERATOR = 22,
# two-adicity 47) — the field used by the reference's unit tests
# (secret-sharing/src/pss.rs:181).
BLS12_377_FR = FieldSpec(
    name="bls12_377_fr",
    modulus=0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
    generator=22,
)

# BLS12-377 base field (arkworks ark-bls12-377 Fq: GENERATOR = 15).
BLS12_377_FQ = FieldSpec(
    name="bls12_377_fq",
    modulus=0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    generator=15,
)

FIELDS = {
    f.name: f
    for f in (BLS12_381_FR, BLS12_381_FQ, BLS12_377_FR, BLS12_377_FQ)
}
