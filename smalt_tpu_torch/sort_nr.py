"""Exact replica of the reference's paired-array quicksort.

sort2UINTarraysByQuickSort (sort.c:236-330) is a Numerical-Recipes
style quicksort (median-of-three, insertion sort below 7 elements).
It is NOT stable, and the permutation it applies to tied keys is what
downstream seed-rank selection and candidate-depth cutoffs observe
(hashhit.c:1035, segment.c:1741).  To reproduce the reference's output
bit-for-bit we replay the identical algorithm.

The pure-Python path is exact; `paired_sort` tries a compiled C
extension first (smalt_tpu/native) and falls back to Python.
"""
from __future__ import annotations

import numpy as np

MAXSTACKSIZE = 60
MINARRSIZE = 7

try:
    from .native import nrsort as _nrsort_ext  # optional C extension
except Exception:  # pragma: no cover - extension optional
    _nrsort_ext = None


def paired_sort(arr: np.ndarray, brr: np.ndarray):
    """Sort `arr` ascending, permuting `brr` alongside, with the exact
    permutation of sort2UINTarraysByQuickSort.  Returns new arrays."""
    a = np.array(arr, copy=True)
    b = np.array(brr, copy=True)
    n = len(a)
    if n < 2:
        return a, b
    if _nrsort_ext is not None and a.dtype == np.uint32 and b.dtype == np.uint32:
        _nrsort_ext.sort2(a, b)
        return a, b
    _paired_sort_py(a, b)
    return a, b


def _paired_sort_py(a, b) -> None:
    n = len(a)
    i_left, i_right = 0, n - 1
    stack = []
    while True:
        if i_right - i_left < MINARRSIZE:
            for j in range(i_left + 1, i_right + 1):
                pa = a[j]
                pb = b[j]
                i = j - 1
                while i >= i_left and a[i] > pa:
                    a[i + 1] = a[i]
                    b[i + 1] = b[i]
                    i -= 1
                a[i + 1] = pa
                b[i + 1] = pb
            if not stack:
                return
            i_right = stack.pop()
            i_left = stack.pop()
        else:
            i_middle = (i_left + i_right) >> 1
            a[i_middle], a[i_left + 1] = a[i_left + 1], a[i_middle]
            b[i_middle], b[i_left + 1] = b[i_left + 1], b[i_middle]
            if a[i_left] > a[i_right]:
                a[i_left], a[i_right] = a[i_right], a[i_left]
                b[i_left], b[i_right] = b[i_right], b[i_left]
            if a[i_left + 1] > a[i_right]:
                a[i_left + 1], a[i_right] = a[i_right], a[i_left + 1]
                b[i_left + 1], b[i_right] = b[i_right], b[i_left + 1]
            if a[i_left] > a[i_left + 1]:
                a[i_left], a[i_left + 1] = a[i_left + 1], a[i_left]
                b[i_left], b[i_left + 1] = b[i_left + 1], b[i_left]
            i = i_left + 1
            j = i_right
            pa = a[i_left + 1]
            pb = b[i_left + 1]
            while True:
                i += 1
                while a[i] < pa:
                    i += 1
                j -= 1
                while a[j] > pa:
                    j -= 1
                if j < i:
                    break
                a[i], a[j] = a[j], a[i]
                b[i], b[j] = b[j], b[i]
            a[i_left + 1] = a[j]
            b[i_left + 1] = b[j]
            a[j] = pa
            b[j] = pb
            # push larger subarray, iterate over smaller (sort.c:318-328)
            if i_right - i + 1 >= j - i_left:
                stack.append(i)
                stack.append(i_right)
                i_right = j - 1
            else:
                stack.append(i_left)
                stack.append(j - 1)
                i_left = i
