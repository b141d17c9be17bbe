"""FhewU8: an encrypted 8-bit integer as little-endian FhewBool lanes
(`learn_fhe_tpu/models/fhew/uint8.py`, reference
`scheme/fhew/src/fhew/uint8.rs`).

The values are the reference circuits' (wrapping add/sub/neg, schoolbook
low-8 multiply, restoring division, `uint8.rs:50-163`), in the JAX
package's gate compositions around the 3-input majority gate, round for
round: the same gates in the same `gate_many` batches, so the outputs are
bit-identical to the JAX package's. Every round is one batched LUT
bootstrap (`gates.gate_batch`): ripple add/sub one round per bit,
wrapping_neg a 3-round Sklansky tree and one xor round, wrapping_mul all 36
partial products in one round and then Wallace 3:2 compression, div_rem
the conditional subtracts with the shared suffix-ANDs of -rhs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from . import rlwe
from .boolean import FhewBool, gate_many
from .bootstrapping import BootstrapKey, BootstrapParams
from .lwe import LweCiphertext
from .rlwe import RlweCiphertext


def _ripple_add(a_bits, b_bits, carry_in=None):
    """Majority-chain ripple adder over aligned bit lists.

    Returns (sum_bits, carry_out). One seed round (all half-xors, plus the
    chain seed a0&b0 when there is no carry-in), then ONE round per chained
    bit: [majority(a_i, b_i, c_i), xor(t_i, c_i)] — the carry for bit i+1
    and the sum of bit i share a bootstrap.
    """
    n = len(a_bits)
    assert len(b_bits) == n and n >= 1
    xors = [("xor", a_bits[i], b_bits[i]) for i in range(n)]
    if carry_in is None:
        seeds = gate_many(xors + [("and", a_bits[0], b_bits[0])])
        t, carry = seeds[:n], seeds[n]
        out = [t[0]]  # c_0 = 0
        start = 1
    else:
        t = gate_many(xors)
        carry = carry_in
        out = []
        start = 0
    for i in range(start, n):
        c_next, s = gate_many(
            [("majority", a_bits[i], b_bits[i], carry), ("xor", t[i], carry)]
        )
        out.append(s)
        carry = c_next
    return out, carry


def _ripple_sub(a_bits, b_bits, borrow_in=None):
    """Majority-chain ripple subtractor: borrow-out = majority(~a, b, borrow)
    (NOT is linear, so ~a is free). Mirrors `_ripple_add`."""
    n = len(a_bits)
    assert len(b_bits) == n and n >= 1
    xors = [("xor", a_bits[i], b_bits[i]) for i in range(n)]
    if borrow_in is None:
        seeds = gate_many(xors + [("and", ~a_bits[0], b_bits[0])])
        t, borrow = seeds[:n], seeds[n]
        out = [t[0]]
        start = 1
    else:
        t = gate_many(xors)
        borrow = borrow_in
        out = []
        start = 0
    for i in range(start, n):
        b_next, d = gate_many(
            [("majority", ~a_bits[i], b_bits[i], borrow), ("xor", t[i], borrow)]
        )
        out.append(d)
        borrow = b_next
    return out, borrow


@dataclass
class FhewU8:
    bits: list[FhewBool]  # little-endian, length 8

    @classmethod
    def sk_encrypt(cls, params, key, sk, v, rng) -> "FhewU8":
        """v: an int, or an integer array: an array gives a VECTORIZED
        encrypted u8 (one FhewU8 holding V values), whose every gate runs
        lane-parallel across the V values in one bootstrap."""
        v = np.asarray(v, dtype=np.uint64)
        return cls(
            [
                FhewBool.sk_encrypt(params, key, sk, (v >> np.uint64(i)) & 1 == 1, rng)
                for i in range(8)
            ]
        )

    @classmethod
    def pk_encrypt(
        cls,
        params: BootstrapParams,
        key: BootstrapKey,
        pk: RlweCiphertext,
        v: int,
        rng: np.random.Generator,
    ) -> "FhewU8":
        """All 8 bit-planes RLWE-encrypted as one batched (8, N) encryption
        and one sample-extract (per bit the semantics of `boolean.rs:27-35`)."""
        const = torch.zeros((8, params.n), dtype=torch.int64, device=pk.a.device)
        const[:, 0] = torch.tensor([(v >> i) & 1 for i in range(8)], device=pk.a.device)
        ct = rlwe.pk_encrypt(params.rlwe, pk, rlwe.encode(params.rlwe, const), rng)
        ext = rlwe.sample_extract(params.rlwe, ct, 0)
        return cls([FhewBool(LweCiphertext(ext.a[i], ext.b[i]), params, key) for i in range(8)])

    def decrypt(self, sk):
        """int for scalar, uint array for vectorized encrypted u8."""
        bits = [np.asarray(b.decrypt(sk)) for b in self.bits]
        out = sum(b.astype(np.uint64) << np.uint64(i) for i, b in enumerate(bits))
        return int(out) if np.ndim(out) == 0 else out.astype(np.uint8)

    def share_decrypt(self, sk, rng):
        return [b.share_decrypt(sk, rng) for b in self.bits]

    def decryption_share_merge(self, shares: Iterable[list]) -> int:
        per_bit = list(zip(*shares))
        return sum(
            int(b.decryption_share_merge(list(s))) << i
            for i, (b, s) in enumerate(zip(self.bits, per_bit))
        )

    # -- arithmetic (`uint8.rs:50-163`) ---------------------------------------

    def __invert__(self) -> "FhewU8":
        return FhewU8([~b for b in self.bits])

    def wrapping_neg(self) -> "FhewU8":
        """-v = ~v + 1: the carry into bit i is AND(~v_0 .. ~v_{i-1}), so all
        carries are prefix-ANDs of ~v — a 3-round Sklansky tree plus one
        batched xor round (4 rounds total vs 7 for the serial chain)."""
        v = self.bits
        nv = [~b for b in v]  # linear, no bootstrap
        p01, p23, p45 = gate_many(
            [("and", nv[0], nv[1]), ("and", nv[2], nv[3]), ("and", nv[4], nv[5])]
        )
        P2, P3, p46 = gate_many(
            [("and", p01, nv[2]), ("and", p01, p23), ("and", p45, nv[6])]
        )
        P4, P5, P6 = gate_many(
            [("and", P3, nv[4]), ("and", P3, p45), ("and", P3, p46)]
        )
        carries = [nv[0], p01, P2, P3, P4, P5, P6]  # carry into bits 1..7
        sums = gate_many([("xor", nv[i + 1], carries[i]) for i in range(7)])
        # s_0 = ~v_0 ^ 1 = v_0 (free)
        return FhewU8([v[0]] + list(sums))

    def overflowing_add(self, rhs: "FhewU8") -> tuple["FhewU8", FhewBool]:
        out, carry = _ripple_add(self.bits, rhs.bits)
        return FhewU8(out), carry

    def carrying_add(self, rhs: "FhewU8", carry: FhewBool) -> tuple["FhewU8", FhewBool]:
        out, c = _ripple_add(self.bits, rhs.bits, carry)
        return FhewU8(out), c

    def wrapping_add(self, rhs: "FhewU8") -> "FhewU8":
        return self.overflowing_add(rhs)[0]

    def overflowing_sub(self, rhs: "FhewU8") -> tuple["FhewU8", FhewBool]:
        out, borrow = _ripple_sub(self.bits, rhs.bits)
        return FhewU8(out), borrow

    def borrowing_sub(self, rhs: "FhewU8", borrow: FhewBool) -> tuple["FhewU8", FhewBool]:
        out, b = _ripple_sub(self.bits, rhs.bits, borrow)
        return FhewU8(out), b

    def wrapping_sub(self, rhs: "FhewU8") -> "FhewU8":
        return self.overflowing_sub(rhs)[0]

    def wrapping_mul(self, rhs: "FhewU8") -> "FhewU8":
        """Schoolbook product keeping only the low 8 bits (`uint8.rs:119-131`).

        All 36 partial-product ANDs run as ONE batched bootstrap; the
        accumulation is Wallace 3:2 compression — each layer compresses every
        column's triples with full adders whose half-xors + majorities batch
        into one round and whose sum-xors batch into a second — then a final
        2-row majority-chain add."""
        lhs, rhs_b = self.bits, rhs.bits
        pp_specs = [
            ("and", lhs[j], rhs_b[i - j]) for i in range(8) for j in range(i + 1)
        ]
        pp_flat = gate_many(pp_specs)
        cols: list[list[FhewBool]] = []
        pos = 0
        for i in range(8):
            cols.append(pp_flat[pos : pos + i + 1])
            pos += i + 1

        while max(len(c) for c in cols) > 2:
            plan = []  # (column, x, y, z) per 3:2 compressor
            nxt: list[list[FhewBool]] = [[] for _ in range(8)]
            for i in range(8):
                c = cols[i]
                k = len(c) // 3
                for g in range(k):
                    plan.append((i, c[3 * g], c[3 * g + 1], c[3 * g + 2]))
                nxt[i].extend(c[3 * k :])
            half = gate_many(
                [
                    g
                    for (_, x, y, z) in plan
                    for g in (("xor", x, y), ("majority", x, y, z))
                ]
            )
            sums = gate_many(
                [("xor", half[2 * j], plan[j][3]) for j in range(len(plan))]
            )
            for j, (i, _, _, _) in enumerate(plan):
                nxt[i].append(sums[j])
                if i + 1 < 8:
                    nxt[i + 1].append(half[2 * j + 1])  # carry into next column
            cols = nxt

        # final 2-row add over columns of height 1-2 (wrapping: carry out of
        # bit 7 is dropped, so bit 7 needs only its sum)
        two = [i for i in range(8) if len(cols[i]) == 2]
        seed_carry: FhewBool | None = None
        ts: dict[int, FhewBool] = {}
        if two:
            # the first 2-bit column seeds the carry chain, so its AND rides
            # in the same round as all the half-xors
            res = gate_many(
                [("xor", cols[i][0], cols[i][1]) for i in two]
                + [("and", cols[two[0]][0], cols[two[0]][1])]
            )
            ts = dict(zip(two, res[: len(two)]))
            seed_carry = res[len(two)]
        out: list[FhewBool] = []
        carry: FhewBool | None = None
        for i in range(8):
            c = cols[i]
            if carry is None:
                if len(c) == 1:
                    out.append(c[0])
                elif i == 7:
                    out.append(ts[i])
                else:
                    out.append(ts[i])
                    carry = seed_carry
            elif len(c) == 1:
                if i == 7:
                    out.append(c[0] ^ carry)
                else:
                    s, cy = gate_many([("xor", c[0], carry), ("and", c[0], carry)])
                    out.append(s)
                    carry = cy
            elif i == 7:
                out.append(ts[i] ^ carry)
            else:
                cy, s = gate_many(
                    [("majority", c[0], c[1], carry), ("xor", ts[i], carry)]
                )
                out.append(s)
                carry = cy
        return FhewU8(out)

    def div_rem(self, rhs: "FhewU8") -> tuple["FhewU8", "FhewU8"]:
        """Restoring division via select-based conditional subtract
        (`uint8.rs:133-152`).

        Each iteration adds -rhs to the m-bit partial remainder; the borrow
        then has to cross positions m..7 where the remainder is implicitly
        zero, i.e. carry_out = carry_m & AND(-rhs[m..7]). Those suffix-ANDs
        are shared across iterations, so they are built ONCE by a 3-round
        tree instead of 8-m serial ANDs inside every iteration."""
        lhs = self.bits
        nr = rhs.wrapping_neg().bits
        # suffix ANDs S_k = AND(nr[k..7]) for k = 1..7 (S_7 = nr[7] is free)
        s6, a45, a23 = gate_many(
            [("and", nr[6], nr[7]), ("and", nr[4], nr[5]), ("and", nr[2], nr[3])]
        )
        s4, s5, a123 = gate_many(
            [("and", a45, s6), ("and", nr[5], s6), ("and", nr[1], a23)]
        )
        s1, s2, s3 = gate_many(
            [("and", a123, s4), ("and", a23, s4), ("and", nr[3], s4)]
        )
        suffix = {1: s1, 2: s2, 3: s3, 4: s4, 5: s5, 6: s6, 7: nr[7]}

        q: list[FhewBool] = []
        r: list[FhewBool] = []
        for i in range(8):
            r.insert(0, lhs[7 - i])
            m = len(r)
            d, carry = _ripple_add(r, nr[:m])
            if m < 8:
                carry = carry & suffix[m]
            # batched select row: r = carry ? d : r (all 2m ANDs together)
            not_carry = ~carry
            flat = gate_many(
                [("and", not_carry, rj) for rj in r] + [("and", carry, dj) for dj in d]
            )
            ors = gate_many([("or", flat[t], flat[m + t]) for t in range(m)])
            r = list(ors)
            q.insert(0, carry)
        return FhewU8(q), FhewU8(r)

    def wrapping_div(self, rhs: "FhewU8") -> "FhewU8":
        return self.div_rem(rhs)[0]

    def wrapping_rem(self, rhs: "FhewU8") -> "FhewU8":
        return self.div_rem(rhs)[1]

    __add__ = wrapping_add
    __sub__ = wrapping_sub
    __mul__ = wrapping_mul
    __truediv__ = wrapping_div
    __floordiv__ = wrapping_div
    __mod__ = wrapping_rem
