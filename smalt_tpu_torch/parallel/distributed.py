"""Several hosts, one `map --fast` run: the rendezvous, and the SAM shards.

Counterpart of smalt_tpu/parallel/distributed.py.  The input stripes at
batch granularity (host h maps the batches b with b % n_hosts == h), so no
host needs another host's reads; each host writes its own SAM shard and a
sidecar of its batches' byte extents, and `merge_shards` restores the
single-host byte order by global batch number.  ShardWriter and
merge_shards are the reference's code, unchanged.

A run is multi-host when these variables are set (the reference's names):
  SMALT_TPU_COORD=host:port    address of the rendezvous (rank 0 serves it)
  SMALT_TPU_NPROCS=N           number of processes
  SMALT_TPU_PROCID=i           this process's rank
`maybe_init_distributed` joins a torch.distributed group on them (gloo,
for the rendezvous only: nothing else crosses the group); without
SMALT_TPU_COORD it does nothing.  Each host drives its own cards (a mesh
of this host's devices).
"""
from __future__ import annotations

import json
import os
from typing import Optional, TextIO, Tuple


def maybe_init_distributed() -> Tuple[int, int]:
    """Join the process group the SMALT_TPU_* variables describe.
    Returns (rank, world size); (0, 1) without creating a group when
    SMALT_TPU_COORD is unset."""
    coord = os.environ.get("SMALT_TPU_COORD")
    if not coord:
        return 0, 1
    import torch.distributed as dist
    nprocs = int(os.environ.get("SMALT_TPU_NPROCS", "1"))
    procid = int(os.environ.get("SMALT_TPU_PROCID", "0"))
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=nprocs, rank=procid)
    return dist.get_rank(), dist.get_world_size()


def end_distributed() -> None:
    """Leave the group maybe_init_distributed joined, if any."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class ShardWriter:
    """SAM shard + batch-extent sidecar for one host.

    write_batch(text) appends one batch's records and logs its byte
    extent; close() writes `<path>.batches.json` with the global batch
    numbers this shard holds."""

    def __init__(self, path: str, host_id: int, n_hosts: int):
        self.path = path
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._fp: TextIO = open(path, "w")
        self._extents = []          # (global_batch_no, start, end)
        self._pos = 0

    def write_batch(self, global_batch_no: int, text: str) -> None:
        self._fp.write(text)
        end = self._pos + len(text)
        self._extents.append((global_batch_no, self._pos, end))
        self._pos = end

    def close(self) -> None:
        self._fp.close()
        with open(self.path + ".batches.json", "w") as f:
            json.dump({"host": self.host_id, "n_hosts": self.n_hosts,
                       "extents": self._extents}, f)


def merge_shards(shard_paths, out, header: Optional[str] = None) -> int:
    """Round-robin the per-batch extents of all shards back into global
    batch order; byte-identical to the single-host output.  Returns the
    number of batches merged."""
    shards = []
    for p in shard_paths:
        with open(p + ".batches.json") as f:
            meta = json.load(f)
        shards.append((p, meta["extents"]))
    if header:
        out.write(header)
    merged = {}
    for p, extents in shards:
        with open(p) as f:
            data = f.read()
        for bno, s, e in extents:
            if bno in merged:
                raise ValueError(f"batch {bno} present in two shards")
            merged[bno] = data[s:e]
    for bno in sorted(merged):
        out.write(merged[bno])
    return len(merged)
