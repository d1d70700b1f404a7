"""Deterministic drand48 replica.

The reference aligner draws uniform variates with POSIX drand48()
(randef.h:19-20) when selecting among equal-best repeat mappings
(results.c:2298, results.c:2532, resultpairs.c:737).  To reproduce its
output bit-for-bit under `-r <seed>`, we re-implement the documented
48-bit LCG: X' = (a*X + c) mod 2^48 with a=0x5DEECE66D, c=0xB;
srand48(s) sets X = (s << 16) | 0x330E.
"""

_A = 0x5DEECE66D
_C = 0xB
_M = 1 << 48


class Drand48:
    def __init__(self, seed: int = 0):
        self.srand48(seed)

    def srand48(self, seed: int) -> None:
        self._x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def drand48(self) -> float:
        self._x = (_A * self._x + _C) % _M
        return self._x / float(_M)


# Global stream mirroring the reference's process-wide srand48/drand48.
_global = Drand48(0)
_seeded = False


def ranseed(seed: int) -> None:
    """RANSEED(s) (randef.h:19): seed<=0 means calendar time."""
    global _seeded
    if seed <= 0:
        import time

        _global.srand48(int(time.time()))
    else:
        _global.srand48(seed)
    _seeded = True


def randraw_uniform_1() -> float:
    return _global.drand48()


def is_seeded() -> bool:
    return _seeded
