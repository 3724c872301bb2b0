"""Batched prime-field arithmetic: lazy-redundant 16-bit limbs, Montgomery
form, guard-limb headroom (the PyTorch counterpart of the JAX package's
ops/field.py).

Layout: a field-element batch is an int32 tensor of shape [n_limbs, B],
limbs on the leading axis, batch on the last.

  LAZY REDUNDANT REPRESENTATION. add/sub/neg/small-scalar ops are plain
  elementwise int32 arithmetic. Limbs may grow to |l| < 2^26 and the value
  may drift within (-LAZY_P_BUDGET p, LAZY_P_BUDGET p). All normalization
  happens inside the Montgomery multiply, which adds the offset
  LAZY_P_BUDGET * p and renormalizes.

  GUARD LIMB. Each field has one 16-bit limb beyond its modulus, so that
  inputs below 2 * LAZY_P_BUDGET * p still give outputs < 2p. Multiply
  outputs are canonical limbs (< 2^16) of a value < 2p.

The kernels carry every multiply and zero test, each behind a wrapper that
routes by the tensor's device: a CPU tensor goes to the plain PyTorch
version beside the kernel, a CUDA tensor to the kernel (csrc/), anything
else raises. There is no fallback from the card to the plain version.

  mont_mul        lazy a, b -> canonical limbs of (A B + m p) / R, where
                  A = a + 256p, B = b + 256p and m = -A B p^-1 mod R; in
                  32-bit words inside, mixed radix (see _mul_words_plain)
  mont_mul_tc     the same function in separated form, with the two
                  constant-operand products of the reduction on the tensor
                  cores; `mul` uses it under mul_kernel("tc") or with
                  CELO_MUL_MXU=1 in the environment
  mont_mul_shape  mont_mul's kernel at n = 25 with the threads per block
                  chosen by the caller (scripts/prof_field.py's sweep)
  mont_redc       lazy x -> canonical limbs of (X + m p) / R, X = x + 256p
                  and m = -X p^-1 mod R; the same rounds as mont_mul
                  without the a_i B rows (see _redc_words_plain)
  f12_cyclo_sq    the cyclotomic squaring of an Fq12 batch, 30 mont_mul
                  products and their limb-wise combination in one launch;
                  its plain version is ops/tower.py's composition
                  (f12_cyclo_sq_plain)
  f12_mul         the Fq12 multiply of two batches (or the square of
                  one), 54 mont_mul products and their limb-wise
                  combination in one launch; its plain version is
                  ops/tower.py's composition (f12_mul_plain)

_mul_plain and _redc_plain, in 16-bit radix, are the oracles the word-form
plain versions are tested against: another digit order, the same integer.

Host oracle: hostmath/fp.py.
"""

import ctypes
import os
from contextlib import contextmanager

import numpy as np
import torch

from ..hostmath.params import P, R, BW6_P
from ..utils.tree import tree_leaves
from . import kernels

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
WORD_BITS = 32  # the word-form multiplies pack two limbs to a word
WORD_MASK = (1 << WORD_BITS) - 1
LAZY_P_BUDGET = 256  # |value| < LAZY_P_BUDGET * p between multiplies


def int_to_limbs(v: int, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = (v >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def limbs_to_int(limbs) -> int:
    v = 0
    for i, l in enumerate(np.asarray(limbs, dtype=np.int64)):
        v += int(l) << (LIMB_BITS * i)
    return v


def _sub_limbs_u32(a: torch.Tensor, b: torch.Tensor):
    """(a - b) on canonical [n, B] limbs, as int64 tensors: returns
    (diff, borrow), diff canonical mod 2^(16n) and borrow 1 where a < b."""
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    diff = torch.empty_like(a)
    borrow = torch.zeros_like(a[0])
    for k in range(a.shape[0]):
        v = a[k] - b[k] - borrow
        borrow = (v < 0).to(torch.int64)
        diff[k] = v & LIMB_MASK
    return diff, borrow


def _as_numpy(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class FieldSpec:
    """Constants of one prime field (with guard limb)."""

    def __init__(self, modulus: int, name: str):
        self.modulus = modulus
        self.name = name
        self.bits = modulus.bit_length()
        self.n = (self.bits + LIMB_BITS - 1) // LIMB_BITS + 1
        self.mont_r = (1 << (LIMB_BITS * self.n)) % modulus
        self.mont_r2 = self.mont_r * self.mont_r % modulus
        self.n0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.n0inv32 = (-pow(modulus, -1, 1 << WORD_BITS)) % (1 << WORD_BITS)
        nprime = (-pow(modulus, -1, 1 << (LIMB_BITS * self.n))) % (
            1 << (LIMB_BITS * self.n)
        )
        self.p_limbs = int_to_limbs(modulus, self.n)
        # p in 32-bit words, for the word-form multiplies: ceil(n / 2) words
        self.n_words = (self.n + 1) // 2
        self.p_words = np.array(
            [(modulus >> (WORD_BITS * j)) & WORD_MASK for j in range(self.n_words)],
            dtype=np.int64,
        )
        self.nprime_limbs = int_to_limbs(nprime, self.n)
        self.offset_limbs = int_to_limbs(LAZY_P_BUDGET * modulus, self.n)
        # CIOS soundness: inputs < 2*BUDGET*p must give outputs < 2p
        assert (2 * LAZY_P_BUDGET) ** 2 * modulus < (1 << (LIMB_BITS * self.n)), name
        self._columns = {}

    # --- host-side conversions (I/O boundary only) ------------------------
    def to_mont(self, v: int) -> np.ndarray:
        return int_to_limbs(v * self.mont_r % self.modulus, self.n)

    def from_mont(self, limbs) -> int:
        return limbs_to_int(limbs) * pow(self.mont_r, -1, self.modulus) % self.modulus

    def pack(self, values, device) -> torch.Tensor:
        """Iterable of ints -> [n, B] int32 Montgomery tensor (canonical)."""
        m, r = self.modulus, self.mont_r
        return self._tensor(self._limbs_from_ints([int(v) * r % m for v in values]), device)

    def pack_raw(self, values, device) -> torch.Tensor:
        """Iterable of ints in [0, p) -> RAW (non-Montgomery) [n, B] limbs."""
        return self._tensor(self._limbs_from_ints([int(v) for v in values]), device)

    @staticmethod
    def _tensor(arr: np.ndarray, device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    def _limbs_from_ints(self, ints) -> np.ndarray:
        nb = 2 * self.n
        buf = b"".join(v.to_bytes(nb, "little") for v in ints)
        return (
            np.frombuffer(buf, dtype="<u2").reshape(-1, self.n).T.astype(np.int32)
        )

    def unpack_raw(self, arr) -> list:
        """RAW canonical [n, B] limbs -> list of ints."""
        a = _as_numpy(arr).astype(np.uint16).astype("<u2")
        buf = a.T.tobytes()
        nb = 2 * self.n
        return [
            int.from_bytes(buf[i * nb : (i + 1) * nb], "little")
            for i in range(a.shape[-1])
        ]

    def unpack(self, arr) -> list:
        """[n, ...] -> flat list of ints (standard form, mod p applied).
        Handles lazy limbs (possibly negative): the value splits into a
        low-16 plane and an offset-biased high plane, each recombined with
        one bytes pass, then one host mulmod by R^-1."""
        flat = _as_numpy(arr).astype(np.int64).reshape(self.n, -1)
        B = flat.shape[1]
        nb = 2 * self.n
        lo = (flat & 0xFFFF).astype("<u2").T.tobytes()
        hi = ((flat >> 16) + (1 << 15)).astype("<u2").T.tobytes()
        bias = sum(1 << (15 + 16 * (i + 1)) for i in range(self.n))
        rinv, m = pow(self.mont_r, -1, self.modulus), self.modulus
        ifb = int.from_bytes
        return [
            (ifb(lo[i * nb : (i + 1) * nb], "little")
             + (ifb(hi[i * nb : (i + 1) * nb], "little") << 16) - bias)
            * rinv % m
            for i in range(B)
        ]

    # --- device constants ---------------------------------------------------
    def column(self, limbs: np.ndarray, device, dtype=torch.int32) -> torch.Tensor:
        """Constant limbs as an [n, 1] tensor, cached per device: a
        constant is copied to the card once, not once per use."""
        device = torch.device(device)
        key = (limbs.tobytes(), device, dtype)
        col = self._columns.get(key)
        if col is None:
            col = torch.as_tensor(limbs.astype(np.int64), dtype=dtype,
                                  device=device).reshape(self.n, 1)
            self._columns[key] = col
        return col

    def zeros(self, batch_shape, device) -> torch.Tensor:
        return torch.zeros((self.n, *batch_shape), dtype=torch.int32, device=device)

    def ones(self, batch_shape, device) -> torch.Tensor:
        return self.const(1, batch_shape, device)

    def const(self, v: int, batch_shape, device) -> torch.Tensor:
        """Montgomery constant broadcast (a view, not a copy) to the batch."""
        c = self.column(self.to_mont(v % self.modulus), device)
        return c.reshape(self.n, *([1] * len(batch_shape))).expand(
            self.n, *batch_shape
        )


FQ = FieldSpec(P, "fq377")
FR = FieldSpec(R, "fr253")
FQ761 = FieldSpec(BW6_P, "fq761")


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels (int64: m * p_j and the column sums
# overflow int32, and torch.uint32 lacks most CPU operations)
# ---------------------------------------------------------------------------

def _normalize_plain(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Lazy [n, B] limbs -> canonical int64 limbs of (value + 256p) mod R:
    one signed ripple, exact for any |limb| < 2^26."""
    t = x.to(torch.int64) + spec.column(spec.offset_limbs, x.device, torch.int64)
    out = torch.empty_like(t)
    carry = torch.zeros_like(t[0])
    for k in range(spec.n):
        v = t[k] + carry
        carry = v >> LIMB_BITS  # arithmetic shift: floor division
        out[k] = v & LIMB_MASK
    return out


def _carry_out(spec: FieldSpec, cols: torch.Tensor) -> torch.Tensor:
    """Nonnegative int64 columns of a value < R -> canonical int32 limbs."""
    out = torch.empty((spec.n, cols.shape[1]), dtype=torch.int32, device=cols.device)
    carry = torch.zeros_like(cols[0])
    for k in range(spec.n):
        v = cols[k] + carry
        out[k] = (v & LIMB_MASK).to(torch.int32)
        carry = v >> LIMB_BITS
    return out


def _mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 16-bit-radix multiply, the oracle of the word-form kernels; a, b:
    [n, B] int32. The same integer as the JAX package's mul_conv, in
    absolute-column CIOS form: row i adds a_i * b and m_i * p
    at columns i..i+n-1 and carries column i's high part into column i+1;
    columns n..2n then hold (A B + m p) / R."""
    n, B = spec.n, a.shape[1]
    ab = _normalize_plain(spec, torch.cat([a, b], dim=1))
    an, bn = ab[:, :B], ab[:, B:]
    p = spec.column(spec.p_limbs, a.device, torch.int64)
    T = torch.zeros((2 * n + 1, B), dtype=torch.int64, device=a.device)
    for i in range(n):
        T[i : i + n] += an[i] * bn
        m = (T[i] * spec.n0inv) & LIMB_MASK
        T[i : i + n] += m * p
        T[i + 1] += T[i] >> LIMB_BITS
    return _carry_out(spec, T[n:])


def _words(limbs16: torch.Tensor) -> torch.Tensor:
    """[n, B] canonical limbs, n odd -> the n // 2 full 32-bit words
    (limb 2j | limb 2j+1 << 16); the top limb stays a half word."""
    return limbs16[0:-1:2] + (limbs16[1::2] << LIMB_BITS)


def _word_rounds(spec: FieldSpec, T: torch.Tensor, row=None,
                 digits: list = None) -> torch.Tensor:
    """The word-form kernels' mixed-radix rounds on T, [2n + 1, B] int64
    16-bit-radix columns that start out holding the value to reduce.
    Rounds 0 .. n // 2 - 1 start at column 2i: T += row(i) (when `row` is
    given: mont_mul's a_i B), m_i = T_0 n0inv32 mod 2^32, T += m_i p, drop 32
    bits; the last round starts at column n - 1 with m = T_0 n0inv mod 2^16
    and drops 16 bits. Together they divide by 2^(32 (n // 2) + 16) = R, and
    the digits m_i concatenate to m = -T p^-1 mod R (appended to `digits`,
    when given, as [B] tensors). A round's carries are deferred: a column
    stays below 2^55. Returns the canonical limbs of the result."""
    n = spec.n
    p = spec.column(spec.p_limbs, T.device, torch.int64)
    for i in range(n // 2):
        k = 2 * i  # the limb where word i starts
        if row is not None:
            T[k : k + n] += row(i)
        t0 = (T[k] & WORD_MASK) + ((T[k + 1] & LIMB_MASK) << LIMB_BITS)
        # t0 n0inv32 wraps in int64; its low 32 bits are right all the same
        m = (t0 * spec.n0inv32) & WORD_MASK
        T[k : k + n] += m * p
        T[k + 1] += T[k] >> LIMB_BITS  # T_0 is now 0 mod 2^32: drop it
        T[k + 2] += T[k + 1] >> LIMB_BITS
        if digits is not None:
            digits.append(m)
    if row is not None:
        T[n - 1 : 2 * n - 1] += row(n // 2)
    m = ((T[n - 1] & LIMB_MASK) * spec.n0inv) & LIMB_MASK
    T[n - 1 : 2 * n - 1] += m * p
    T[n] += T[n - 1] >> LIMB_BITS
    if digits is not None:
        digits.append(m)
    return _carry_out(spec, T[n:])


def _mul_words_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
                     digits: list = None) -> torch.Tensor:
    """The plain version of mont_mul (and mont_mul_shape): the kernel's
    rounds one by one (_word_rounds), round i adding A's 32-bit word i
    times B, the last round A's top limb times B. m = -A B p^-1 mod R. A
    word product is two 32 x 16 products (32 x 32 bits overflow int64)."""
    n, B = spec.n, a.shape[1]
    ab = _normalize_plain(spec, torch.cat([a, b], dim=1))
    an, bn = ab[:, :B], ab[:, B:]
    aw = _words(an)
    T = torch.zeros((2 * n + 1, B), dtype=torch.int64, device=a.device)
    return _word_rounds(
        spec, T, lambda i: (aw[i] if i < n // 2 else an[n - 1]) * bn, digits)


def _redc_words_plain(spec: FieldSpec, x: torch.Tensor,
                      digits: list = None) -> torch.Tensor:
    """The plain version of mont_redc: the kernel's rounds one by one
    (_word_rounds) on X = x + 256p with no row added, so the result is
    (X + m p) / R with m = -X p^-1 mod R, _redc_plain's integer."""
    n, B = spec.n, x.shape[1]
    T = torch.zeros((2 * n + 1, B), dtype=torch.int64, device=x.device)
    T[:n] = _normalize_plain(spec, x)
    return _word_rounds(spec, T, None, digits)


def _product_words_plain(an: torch.Tensor, bn: torch.Tensor) -> torch.Tensor:
    """[n, B] canonical limbs x2 -> the 2n canonical limbs of the full
    product, word row by word row as the kernels' phase A forms it."""
    n, B = an.shape
    aw = _words(an)
    T = torch.zeros((2 * n, B), dtype=torch.int64, device=an.device)
    for i in range(n // 2):
        T[2 * i : 2 * i + n] += aw[i] * bn
    T[n - 1 : 2 * n - 1] += an[n - 1] * bn
    carry = torch.zeros_like(T[0])
    for k in range(2 * n):
        v = T[k] + carry
        T[k] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    return T


def tc_weights(spec: FieldSpec, rows_to: int = 1, depth_to: int = 1):
    """The weight matrices of the separated Montgomery form over 8-bit
    pieces, as numpy uint8: W1[k, i] = n'8[k - i] for k < 2n (the low
    product only: mod R) and W2[k, i] = p8[k - i] for k < 4n (the full
    product), 0 <= k - i < 2n, zero elsewhere. Rows are padded with zeros
    to a multiple of `rows_to`, columns to a multiple of `depth_to`."""
    n2 = 2 * spec.n

    def pieces8(limbs):
        out = []
        for l in limbs:
            out += [int(l) & 0xFF, int(l) >> 8]
        return out

    def toeplitz(w8, rows):
        pad_r = -(-rows // rows_to) * rows_to
        pad_c = -(-n2 // depth_to) * depth_to
        W = np.zeros((pad_r, pad_c), dtype=np.uint8)
        for k in range(rows):
            for i in range(n2):
                if 0 <= k - i < n2:
                    W[k, i] = w8[k - i]
        return W

    return (toeplitz(pieces8(spec.nprime_limbs), n2),
            toeplitz(pieces8(spec.p_limbs), 2 * n2))


def _pieces(limbs16: torch.Tensor) -> torch.Tensor:
    """[n, B] canonical 16-bit limbs -> [2n, B] 8-bit pieces, low first."""
    n, B = limbs16.shape
    return torch.stack([limbs16 & 0xFF, limbs16 >> 8], dim=1).reshape(2 * n, B)


def _mul_tc_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of mont_mul_tc, in the kernel's phases: T = A B
    in 32-bit words; m = (T mod R) N' mod R and m p as matrix products
    over 8-bit pieces; one ripple. The matrix products run
    in float64, which is exact here (every sum is below 2^23) and is the
    one type torch.matmul takes on both the CPU and the card for this."""
    n, B = spec.n, a.shape[1]
    dev = a.device
    key = ("tc_plain", dev)
    Ws = spec._columns.get(key)
    if Ws is None:
        Ws = spec._columns[key] = tuple(
            torch.from_numpy(W.astype(np.float64)).to(dev) for W in tc_weights(spec)
        )
    W1, W2 = Ws

    def matmul(W, pieces):
        return torch.matmul(W, pieces.to(torch.float64)).to(torch.int64)

    ab = _normalize_plain(spec, torch.cat([a, b], dim=1))
    an, bn = ab[:, :B], ab[:, B:]
    # phase A: T = A B in words; all 2n limbs canonical
    T = _product_words_plain(an, bn)
    # phase B: m = (T mod R) N' mod R; the carry beyond n limbs is dropped
    m8 = matmul(W1, _pieces(T[:n]))
    m16 = torch.empty((n, B), dtype=torch.int64, device=dev)
    carry = torch.zeros_like(T[0])
    for j in range(n):
        v = m8[2 * j] + (m8[2 * j + 1] << 8) + carry
        m16[j] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    # phase C: m p, all 4n radix-2^8 columns
    mp8 = matmul(W2, _pieces(m16))
    # final: (T + m p) / R; columns n..2n-1 are the result
    out = torch.empty((n, B), dtype=torch.int32, device=dev)
    carry = torch.zeros_like(T[0])
    for k in range(2 * n):
        v = T[k] + mp8[2 * k] + (mp8[2 * k + 1] << 8) + carry
        carry = v >> LIMB_BITS
        if k >= n:
            out[k - n] = (v & LIMB_MASK).to(torch.int32)
    return out


def _redc_plain(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """REDC(x + 256p) in 16-bit radix, the oracle of mont_redc: the
    canonical limbs of (X + m p) / R."""
    n, B = spec.n, x.shape[1]
    p = spec.column(spec.p_limbs, x.device, torch.int64)
    T = torch.zeros((2 * n + 1, B), dtype=torch.int64, device=x.device)
    T[:n] = _normalize_plain(spec, x)
    for i in range(n):
        m = (T[i] * spec.n0inv) & LIMB_MASK
        T[i : i + n] += m * p
        T[i + 1] += T[i] >> LIMB_BITS
    return _carry_out(spec, T[n:])


# ---------------------------------------------------------------------------
# Kernel wrappers: route by device, count launches
# ---------------------------------------------------------------------------

class _KernelWrapper:
    """A kernel's entry point. `launches` counts the kernel launches (and
    nothing else: calls on CPU tensors go to the plain version), and
    `launches_by_n` splits them by limb count (the kernel's template N)."""

    name = ""

    def __init__(self):
        self.launches = 0
        self.launches_by_n = {}
        self._consts = {}

    def _launched(self, spec: FieldSpec):
        self.launches += 1
        self.launches_by_n[spec.n] = self.launches_by_n.get(spec.n, 0) + 1

    def _constants(self, spec: FieldSpec) -> "kernels.FieldConstants":
        c = self._consts.get(spec.name)
        if c is None:
            c = self._consts[spec.name] = kernels.FieldConstants(spec)
        return c

    @staticmethod
    def _check(spec: FieldSpec, *ts):
        dev = ts[0].device
        for t in ts:
            if t.device != dev:
                raise ValueError(f"operands on {t.device} and {dev}")
            if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != spec.n:
                raise ValueError(
                    f"expected [{spec.n}, B] int32, got {tuple(t.shape)} {t.dtype}"
                )
        if any(t.shape != ts[0].shape for t in ts):
            raise ValueError("operand shapes differ")
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        return dev.type == "cuda"


class _MontMul(_KernelWrapper):
    name = "mont_mul"

    def __call__(self, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
        if not self._check(spec, a, b):
            return _mul_words_plain(spec, a, b)
        a, b = a.contiguous(), b.contiguous()
        out = torch.empty_like(a)
        kernels.launch_mont_mul(self._constants(spec), a, b, out)
        self._launched(spec)
        return out


class _MontRedc(_KernelWrapper):
    name = "mont_redc"

    def __call__(self, spec: FieldSpec, x: torch.Tensor):
        if not self._check(spec, x):
            return _redc_words_plain(spec, x)
        x = x.contiguous()
        out = torch.empty_like(x)
        kernels.launch_mont_redc(self._constants(spec), x, out)
        self._launched(spec)
        return out


class _MontMulTc(_KernelWrapper):
    name = "mont_mul_tc"

    def __init__(self):
        super().__init__()
        self._weights = {}

    def weights(self, spec: FieldSpec, device):
        """W1, W2 as u8 tensors on the card, padded as the kernel reads
        them (rows to 16, depth to 32), built once per field and card."""
        key = (spec.name, device)
        w = self._weights.get(key)
        if w is None:
            w = self._weights[key] = tuple(
                torch.from_numpy(W).to(device).contiguous()
                for W in tc_weights(spec, rows_to=16, depth_to=32)
            )
        return w

    def __call__(self, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
        if not self._check(spec, a, b):
            return _mul_tc_plain(spec, a, b)
        a, b = a.contiguous(), b.contiguous()
        out = torch.empty_like(a)
        w1, w2 = self.weights(spec, a.device)
        kernels.launch_mont_mul_tc(self._constants(spec), a, b, out, w1, w2)
        self._launched(spec)
        return out


class _MontMulShape(_KernelWrapper):
    name = "mont_mul_shape"

    def __call__(self, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
                 threads: int):
        if spec.n != 25 or threads not in kernels.SHAPE_THREADS:
            raise ValueError(
                f"mont_mul_shape takes n = 25 and {kernels.SHAPE_THREADS} "
                f"threads a block, got n = {spec.n}, {threads}"
            )
        if not self._check(spec, a, b):
            return _mul_words_plain(spec, a, b)
        a, b = a.contiguous(), b.contiguous()
        out = torch.empty_like(a)
        kernels.launch_mont_mul_shape(self._constants(spec), a, b, out, threads)
        self._launched(spec)
        return out


class _F12Kernel(_KernelWrapper):
    """An Fq12 kernel over `spec` (FQ: the kernels are built for n = 25
    alone): it reads each operand's 12 coefficients where they lie (any
    strides; broadcast batches as expanded views) and writes one
    [12, n, B] tensor whose rows come back as the result's leaves. CPU
    tensors go to the plain version, the composition that the kernel
    replaces. A subclass gives `_plain(*trees)` and `_launch(spec,
    operands, out)`, operands being each tree's 12 [n, B] views."""

    @staticmethod
    def operands(spec: FieldSpec, trees):
        """Each tree's 12 coefficients as [n, B] views of its leaves, which
        the kernel reads where they lie (B: the broadcast batch, flattened;
        a broadcast leaf has lane stride 0), and the batch's shape."""
        leaves = [tree_leaves(t) for t in trees]
        batch = torch.broadcast_shapes(*(x.shape[1:] for ls in leaves for x in ls))
        return [[x.expand(spec.n, *batch).reshape(spec.n, -1) for x in ls]
                for ls in leaves], batch

    def __call__(self, spec: FieldSpec, *trees):
        leaves = [tree_leaves(t) for t in trees]
        flat = [x for ls in leaves for x in ls]
        dev = flat[0].device
        if any(x.device != dev for x in flat):
            raise ValueError(f"operands on {sorted({str(x.device) for x in flat})}")
        if dev.type == "cpu":
            return self._plain(*trees)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if any(len(ls) != 12 for ls in leaves) or any(
                x.dtype != torch.int32 or x.dim() < 2 or x.shape[0] != spec.n
                for x in flat):
            raise ValueError(f"expected Fq12 trees of 12 [{spec.n}, ...] int32 tensors")
        operands, batch = self.operands(spec, trees)
        out = torch.empty((12, spec.n, operands[0][0].shape[1]), dtype=torch.int32,
                          device=dev)
        if out.shape[2]:
            self._launch(spec, operands, out)
            self._launched(spec)
        o = out.reshape(12, spec.n, *batch)
        return tuple(tuple((o[6 * h + 2 * s], o[6 * h + 2 * s + 1]) for s in range(3))
                     for h in range(2))


class _F12CycloSq(_F12Kernel):
    """The cyclotomic squaring of an Fq12 batch, ops/tower.py::f12_cyclo_sq:
    one launch of csrc/cyclo_sq.cu's kernel on the card; plain version
    tower.f12_cyclo_sq_plain."""

    name = "f12_cyclo_sq"

    def __init__(self):
        super().__init__()
        self._ones = {}

    def _one(self, spec: FieldSpec):
        """The Montgomery one's limbs as the C interface takes them."""
        one = self._ones.get(spec.name)
        if one is None:
            one = self._ones[spec.name] = (ctypes.c_int32 * spec.n)(
                *(int(v) for v in spec.to_mont(1)))
        return one

    def _plain(self, a):
        from .tower import f12_cyclo_sq_plain  # the tower builds on this module

        return f12_cyclo_sq_plain(a)

    def _launch(self, spec: FieldSpec, operands, out):
        kernels.launch_f12_cyclo_sq(self._constants(spec), operands[0], self._one(spec), out)


class _F12Mul(_F12Kernel):
    """The Fq12 multiply of two batches, ops/tower.py::f12_mul: one launch
    of csrc/f12_mul.cu's kernel on the card, whose square form (b is a,
    leaf for leaf: f12_sq) reads the one operand once; plain version
    tower.f12_mul_plain."""

    name = "f12_mul"

    def __call__(self, spec: FieldSpec, a, b):
        if a is b or all(x is y for x, y in zip(tree_leaves(a), tree_leaves(b))):
            return super().__call__(spec, a)
        return super().__call__(spec, a, b)

    def _plain(self, a, b=None):
        from .tower import f12_mul_plain  # the tower builds on this module

        return f12_mul_plain(a, a if b is None else b)

    def _launch(self, spec: FieldSpec, operands, out):
        kernels.launch_f12_mul(self._constants(spec), operands, out)


mont_mul = _MontMul()
mont_redc = _MontRedc()
mont_mul_tc = _MontMulTc()
mont_mul_shape = _MontMulShape()
f12_cyclo_sq = _F12CycloSq()
f12_mul = _F12Mul()
KERNELS = (mont_mul, mont_redc, mont_mul_tc, mont_mul_shape, f12_cyclo_sq, f12_mul)

# which kernel `mul` uses: "cios" (mont_mul) or "tc" (mont_mul_tc). None
# until first use, when CELO_MUL_MXU=1 in the environment selects "tc", as
# it selects the tensor-unit multiply in the JAX package
_MUL_KERNELS = {"cios": mont_mul, "tc": mont_mul_tc}
_mul_choice = None


def selected_mul():
    global _mul_choice
    if _mul_choice is None:
        _mul_choice = "tc" if os.environ.get("CELO_MUL_MXU", "0") == "1" else "cios"
    return _MUL_KERNELS[_mul_choice]


@contextmanager
def mul_kernel(name: str):
    """Within the block every field multiply goes through the named
    kernel: "cios" (mont_mul) or "tc" (mont_mul_tc)."""
    global _mul_choice
    if name not in _MUL_KERNELS:
        raise ValueError(f"mul_kernel takes 'cios' or 'tc', got {name!r}")
    prev, _mul_choice = _mul_choice, name
    try:
        yield
    finally:
        _mul_choice = prev


def reset_launches():
    for k in KERNELS:
        k.launches = 0
        k.launches_by_n = {}


# ---------------------------------------------------------------------------
# Field-op namespaces
# ---------------------------------------------------------------------------

def make_field_ops(spec: FieldSpec):
    n = spec.n

    # --- lazy ops: single elementwise int32 instructions ------------------
    def add(a, b):
        return a + b

    def sub(a, b):
        return a - b

    def neg(a):
        return -a

    def mul_small(a, k: int):
        # audited ceiling: 12 * (sum of a few canonical limbs) < 2^26,
        # the lazy-normalize bound (largest user: BW6 G2's b3 = 12)
        assert 0 <= k <= 12
        return a * k

    def select(c, a, b):
        return torch.where(c[None], a, b)

    # --- multiply (erases lazy drift; output canonical < 2p) --------------
    def _flat_pair(a, b):
        batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        a = a.expand(n, *batch).reshape(n, -1)
        b = b.expand(n, *batch).reshape(n, -1)
        return a, b, batch

    def mul(a, b):
        a, b, batch = _flat_pair(a, b)
        return selected_mul()(spec, a, b).reshape(n, *batch)

    def mul_many(pairs):
        """Many independent products in ONE kernel launch (batch concat)."""
        if len(pairs) == 1:
            return [mul(pairs[0][0], pairs[0][1])]
        batch = torch.broadcast_shapes(
            *[torch.broadcast_shapes(a.shape[1:], b.shape[1:]) for a, b in pairs]
        )
        A = torch.cat([a.expand(n, *batch) for a, _ in pairs], dim=-1)
        Bm = torch.cat([b.expand(n, *batch) for _, b in pairs], dim=-1)
        C = mul(A, Bm)
        w = batch[-1]
        return [C[..., i * w : (i + 1) * w] for i in range(len(pairs))]

    def sq(a):
        return mul(a, a)

    # --- Montgomery reduction (REDC): half a multiply ----------------------
    def redc_many(vals):
        """Stacked REDC: lazy values -> canonical limbs of REDC(v + 256p),
        each < 2p, in ONE kernel launch for k values."""
        batch = torch.broadcast_shapes(*[v.shape[1:] for v in vals])
        assert len(batch) == 1, "field batch must be 1-D"
        A = torch.cat([v.expand(n, *batch) for v in vals], dim=-1)
        out = mont_redc(spec, A)
        w = batch[-1]
        return [out[..., i * w : (i + 1) * w] for i in range(len(vals))]

    # --- mod-p semantic predicates ------------------------------------------
    def canon2p(a):
        """Lazy value -> canonical limbs with value < 2p (mod p preserved):
        Montgomery-multiply by R (the Montgomery form of 1)."""
        return mul(a, spec.ones(a.shape[1:], a.device))

    def is_zero(a):
        return is_zero_many([a])[0]

    def eq(a, b):
        return is_zero(a - b)

    def is_zero_many(vals):
        """Stacked zero-tests (x == 0 mod p iff REDC(x) in {0, p}):
        ONE half-multiply launch for k values."""
        outs = redc_many(vals)
        pl_ = spec.column(spec.p_limbs, outs[0].device)
        return [((z == 0).all(dim=0)) | ((z == pl_).all(dim=0)) for z in outs]

    def reduce_2p(a):
        """Canonical-limb value < 2p -> [0, p): one conditional subtract."""
        z = a.to(torch.int64)
        p = spec.column(spec.p_limbs, a.device, torch.int64)
        d = torch.empty_like(z)
        carry = torch.zeros_like(z[0])
        for k in range(n):
            v = z[k] - p[k] + carry
            carry = v >> LIMB_BITS
            d[k] = v & LIMB_MASK
        return torch.where((carry < 0)[None], z, d).to(torch.int32)

    def to_canonical(a):
        """Full reduction to [0, p): canon2p then one conditional subtract."""
        return reduce_2p(canon2p(a))

    # --- raw (non-Montgomery) boundary ----------------------------------------
    _r2_raw = int_to_limbs(spec.mont_r2, n)

    def from_raw(a):
        """RAW canonical limbs (value < p) -> Montgomery form:
        mont_mul(v, R^2) = v*R."""
        r2 = spec.column(_r2_raw, a.device)
        return mul(a, r2.reshape(n, *([1] * (a.dim() - 1))).expand(a.shape))

    def to_raw(a):
        """Montgomery (lazy ok) -> RAW canonical limbs in [0, p)."""
        return reduce_2p(redc_many([a])[0])

    def pow_const(a, e: int):
        """a^e for a fixed python-int exponent: 4-bit fixed windows (a table
        a^0..a^15, then 4 squarings and ONE multiply per window), with the
        window digits static Python ints."""
        if e == 0:
            return spec.ones(a.shape[1:], a.device)
        if e.bit_length() <= 8:
            result = None
            base = a
            while e > 0:
                if e & 1:
                    result = base if result is None else mul(result, base)
                e >>= 1
                if e:
                    base = sq(base)
            return result
        W = 4
        nb = e.bit_length()
        nw = (nb + W - 1) // W
        digits = [(e >> (W * (nw - 1 - i))) & ((1 << W) - 1) for i in range(nw)]
        table = [spec.ones(a.shape[1:], a.device), a]
        for _ in range(2, 1 << W):
            table.append(mul(table[-1], a))
        res = table[digits[0]]
        for d in digits[1:]:
            for _ in range(W):
                res = sq(res)
            res = mul(res, table[d])
        return res

    def inv(a):
        """a^(p-2): batched, branch-free. inv(0) = 0."""
        return pow_const(a, spec.modulus - 2)

    def legendre_is_qr(a):
        l = pow_const(a, (spec.modulus - 1) // 2)
        return eq(l, spec.ones(a.shape[1:], a.device))

    class Ops:
        pass

    ops = Ops()
    ops.spec = spec
    ops.n = n
    ops.add = add
    ops.sub = sub
    ops.neg = neg
    ops.mul = mul
    ops.mul_many = mul_many
    ops.sq = sq
    ops.mul_small = mul_small
    ops.redc_many = redc_many
    ops.is_zero = is_zero
    ops.is_zero_many = is_zero_many
    ops.eq = eq
    ops.select = select
    ops.canon2p = canon2p
    ops.reduce_2p = reduce_2p
    ops.to_canonical = to_canonical
    ops.from_raw = from_raw
    ops.to_raw = to_raw
    ops.pow_const = pow_const
    ops.inv = inv
    ops.legendre_is_qr = legendre_is_qr
    ops.zeros = spec.zeros
    ops.ones = spec.ones
    ops.const = spec.const
    return ops


fq = make_field_ops(FQ)
fr = make_field_ops(FR)
fq761 = make_field_ops(FQ761)
_OPS_BY_SPEC = {FQ.name: fq, FR.name: fr, FQ761.name: fq761}


def ops_for(spec: FieldSpec):
    """Field-op namespace for one of the module's FieldSpec singletons."""
    return _OPS_BY_SPEC[spec.name]
