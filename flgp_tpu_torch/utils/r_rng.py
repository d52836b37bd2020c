"""Bit-exact re-implementation of R's default RNG stream.

The reference R package's README golden numbers are produced by R scripts
beginning with ``set.seed(1234)``; the data points,
train/test split, and observation noise all come from R's Mersenne-Twister
stream.  To demonstrate parity on the *identical* data, this module
re-implements the exact stream semantics of R >= 3.6.0 (the behavior, not the
code): MT19937 with R's ``RNG_Init`` 69069-scramble seeding, ``unif_rand``
fixup, ``runif``, inversion ``rnorm`` (AS 241 quantile), and rejection-method
``sample.int``.

A copy of ``flgp_tpu.utils.r_rng`` (plain Python and NumPy), kept here so
that the port runs without the JAX package; tests/test_torch_rstream.py holds
the two streams equal.
"""

from __future__ import annotations

import math

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
_I2_32M1 = 2.328306437080797e-10  # 1/(2^32 - 1), R's fixup constant
_BIG = 134217728  # 2^27, rnorm inversion split


def _qnorm(p: float) -> float:
    """Standard normal quantile, Wichura's AS 241 PPND16 (R's qnorm)."""
    q = p - 0.5
    if abs(q) <= 0.425:
        r = 0.180625 - q * q
        num = (((((((2509.0809287301226727 * r + 33430.575583588128105) * r
                    + 67265.770927008700853) * r + 45921.953931549871457) * r
                  + 13731.693765509461125) * r + 1971.5909503065514427) * r
                + 133.14166789178437745) * r + 3.387132872796366608)
        den = (((((((5226.495278852545703 * r + 28729.085735721942674) * r
                    + 39307.89580009271061) * r + 21213.794301586595867) * r
                  + 5394.1960214247511077) * r + 687.1870074920579083) * r
                + 42.313330701600911252) * r + 1.0)
        return q * num / den
    r = p if q < 0 else 1.0 - p
    r = math.sqrt(-math.log(r))
    if r <= 5.0:
        r = r - 1.6
        num = (((((((7.7454501427834140764e-4 * r + 0.0227238449892691845833) * r
                    + 0.24178072517745061177) * r + 1.27045825245236838258) * r
                  + 3.64784832476320460504) * r + 5.7694972214606914055) * r
                + 4.6303378461565452959) * r + 1.42343711074968357734)
        den = (((((((1.05075007164441684324e-9 * r + 5.475938084995344946e-4) * r
                    + 0.0151986665636164571966) * r + 0.14810397642748007459) * r
                  + 0.68976733498510000455) * r + 1.6763848301838038494) * r
                + 2.05319162663775882187) * r + 1.0)
    else:
        r = r - 5.0
        num = (((((((2.01033439929228813265e-7 * r + 2.71155556874348757815e-5) * r
                    + 0.0012426609473880784386) * r + 0.026532189526576123093) * r
                  + 0.29656057182850489123) * r + 1.7848265399172913358) * r
                + 5.4637849111641143699) * r + 6.6579046435011037772)
        den = (((((((2.04426310338993978564e-15 * r + 1.4215117583164458887e-7) * r
                    + 1.8463183175100546818e-5) * r + 7.868691311456132591e-4) * r
                  + 0.0148753612908506148525) * r + 0.13692988092273580531) * r
                + 0.59983220655588793769) * r + 1.0)
    val = num / den
    return -val if q < 0 else val


class RRng:
    """R's default RNG: Mersenne-Twister + Inversion + Rejection sampling."""

    def __init__(self, seed: int):
        # RNG_Init: 50 initial scrambles, then 625 words (i_seed[0] = mti
        # slot, discarded; FixupSeeds forces mti = N on init).
        s = seed & 0xFFFFFFFF
        for _ in range(50):
            s = (69069 * s + 1) & 0xFFFFFFFF
        state = []
        for _ in range(625):
            s = (69069 * s + 1) & 0xFFFFFFFF
            state.append(s)
        self._mt = state[1:]
        self._mti = _N

    def _next_u32(self) -> int:
        mt = self._mt
        if self._mti >= _N:
            for kk in range(_N):
                y = (mt[kk] & _UPPER) | (mt[(kk + 1) % _N] & _LOWER)
                nxt = mt[kk + _M] if kk + _M < _N else mt[kk + _M - _N]
                mt[kk] = nxt ^ (y >> 1) ^ (_MATRIX_A if y & 1 else 0)
            self._mti = 0
        y = mt[self._mti]
        self._mti += 1
        y ^= y >> 11
        y = (y ^ ((y << 7) & 0x9D2C5680)) & 0xFFFFFFFF
        y = (y ^ ((y << 15) & 0xEFC60000)) & 0xFFFFFFFF
        y ^= y >> 18
        return y

    def unif_rand(self) -> float:
        x = self._next_u32() * 2.3283064365386963e-10  # / 2^32
        if x <= 0.0:
            return 0.5 * _I2_32M1
        if 1.0 - x <= 0.0:
            return 1.0 - 0.5 * _I2_32M1
        return x

    def runif(self, n: int, a: float = 0.0, b: float = 1.0) -> np.ndarray:
        out = np.empty(n)
        for i in range(n):
            u = self.unif_rand()
            while u <= 0.0 or u >= 1.0:
                u = self.unif_rand()
            out[i] = a + (b - a) * u
        return out

    def norm_rand(self) -> float:
        u1 = self.unif_rand()
        u1 = int(_BIG * u1) + self.unif_rand()
        return _qnorm(u1 / _BIG)

    def rnorm(self, n: int, mean: float = 0.0, sd: float = 1.0) -> np.ndarray:
        return np.array([mean + sd * self.norm_rand() for _ in range(n)])

    def _rbits(self, bits: int) -> int:
        v = 0
        for _ in range(0, bits + 1, 16):
            v1 = int(math.floor(self.unif_rand() * 65536))
            v = 65536 * v + v1
        return v & ((1 << bits) - 1)

    def unif_index(self, dn: int) -> int:
        """R_unif_index, rejection method (sample.kind = "Rejection")."""
        if dn <= 0:
            return 0
        bits = int(math.ceil(math.log2(dn)))
        while True:
            dv = self._rbits(bits)
            if dv < dn:
                return dv

    def sample_int(self, n: int, k: int) -> np.ndarray:
        """sample.int(n, k) without replacement, 1-based like R."""
        x = list(range(n))
        out = np.empty(k, dtype=np.int64)
        avail = n
        for i in range(k):
            j = self.unif_index(avail)
            out[i] = x[j] + 1
            avail -= 1
            x[j] = x[avail]
        return out
