"""A device mesh driven by one process, and its collectives over `ip`.

Counterpart of `shard_map` over a ('dp', 'ip') `jax.sharding.Mesh` in
smalt_tpu/parallel/mesh.py.  One Python thread drives every member: it
enqueues each member's work in turn on that member's device, and CUDA
launches are asynchronous, so members on several cards overlap without
threads (and the kernel build and launch counters need no new locks).
Every mesh shape also runs with several members on one device, e.g. all
on cuda:0 or all on the CPU, which is how one card holds the sharded
paths.

A collective over `ip` is a function of the list of the ip members'
tensors, in member order, that returns each member's result on that
member's device.  Reductions run in member order on integer tensors, so
results are exact.  `Mesh.moved` counts the bytes the collectives move
between members, as members on separate cards would move them: a psum or
pmax gathers ip - 1 inputs onto the first member and sends the result
back to the other ip - 1, an all_gather sends each input to the other
ip - 1 members.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


class Mesh:
    """A dp x ip grid of torch devices: `devices[i][j]` is the member at
    dp row i, ip column j.  Reads split over dp; the index is replicated
    or range-sharded over ip."""

    def __init__(self, dp: int, ip: int, devices: Sequence):
        if dp < 1 or ip < 1:
            raise ValueError(f"mesh {dp},{ip}: both sizes must be >= 1")
        devs = [torch.device(d) for d in devices]
        if len(devs) != dp * ip:
            raise ValueError(f"mesh {dp},{ip} needs {dp * ip} devices, "
                             f"got {len(devs)}")
        self.dp, self.ip = dp, ip
        self.devices = [devs[i * ip:(i + 1) * ip] for i in range(dp)]
        self.moved = 0

    def __repr__(self) -> str:
        return f"Mesh({self.dp}, {self.ip}, {self.key()[2]})"

    def key(self) -> tuple:
        """(dp, ip, device names): what a cached step is keyed on."""
        return (self.dp, self.ip,
                tuple(str(d) for row in self.devices for d in row))

    def _count(self, xs, copies: int) -> None:
        self.moved += copies * sum(x.numel() * x.element_size() for x in xs)

    def psum(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Elementwise sum over the members, on every member."""
        return self._reduce(xs, torch.add)

    def pmax(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Elementwise maximum over the members, on every member."""
        return self._reduce(xs, torch.maximum)

    def _reduce(self, xs, op):
        self._check(xs)
        acc = xs[0]
        for x in xs[1:]:
            acc = op(acc, x.to(acc.device, non_blocking=True))
        self._count(xs[:1], 2 * (len(xs) - 1))
        return [acc.to(x.device, non_blocking=True) for x in xs]

    def all_gather(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every member's tensor stacked on a new first axis, in member
        order, on every member."""
        self._check(xs)
        self._count(xs, len(xs) - 1)
        return [torch.stack([y.to(x.device, non_blocking=True) for y in xs])
                for x in xs]

    def _check(self, xs) -> None:
        if len(xs) != self.ip:
            raise ValueError(f"a collective over ip takes {self.ip} "
                             f"tensors, got {len(xs)}")
