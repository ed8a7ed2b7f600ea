"""Device mesh for doc-sharded serving.

Counterpart of ``evdr_tpu/parallel/mesh.py``. The parallel axis is the
DOCUMENT axis of the index: pages shard across devices ("docs"), queries
replicate, and each shard's top-k candidates are merged. A 2D mesh adds a
query data-parallel axis ("dp"): each dp group holds the whole index
sharded over its ``docs`` devices and answers its slice of the queries.

PyTorch has no single-process device mesh, so :class:`DeviceMesh` is a
small frozen record: the global shard grid's shape and axis names, the
devices of the shards this process holds (global shards ``rank * n_local``
to ``rank * n_local + n_local - 1``, in row-major grid order) and, across
processes, the ``torch.distributed`` groups. A mesh may repeat a device
(four ``cuda:0`` shards, or four CPU shards): the shards are then separate
tensors on one device, which is how one card or the CPU runs a mesh of
several shards. :func:`make_mesh` itself never repeats a device.

``TRANSFER_BYTES`` counts the bytes a search moves between devices, by
kind: ``queries`` (what a search sends out to each shard's device: the
queries, their masks, pruned search's candidate ids; ``parallel/topk.
_on``), ``candidates`` (top-k candidates and rerank scores
to the first device, :func:`gather_blocks`) and ``scores`` (whole score
blocks, ``sharded_maxsim``). A copy whose source is its destination
counts nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch

from evdr_tpu_torch.utils.timing import span

DOC_AXIS = "docs"
DP_AXIS = "dp"

# bytes moved between devices since the process started, by kind
TRANSFER_BYTES = {"queries": 0, "candidates": 0, "scores": 0}


def same_device(a, b) -> bool:
    """Whether devices ``a`` and ``b`` are one (an index left out is 0:
    a CPU tensor reports ``cpu`` whatever ``cpu:<n>`` made it)."""
    a, b = torch.device(a), torch.device(b)
    return (a.type, a.index or 0) == (b.type, b.index or 0)


def count_transfer(kind: Optional[str], x: torch.Tensor, src, dst) -> None:
    """Add ``x``'s bytes to ``TRANSFER_BYTES[kind]`` where it moves from
    device ``src`` to another device ``dst`` (no ``kind``: not counted)."""
    if kind is not None and not same_device(src, dst):
        TRANSFER_BYTES[kind] += x.numel() * x.element_size()


def transfer_bytes() -> int:
    """Every kind's bytes moved between devices so far."""
    return sum(TRANSFER_BYTES.values())


@dataclass(frozen=True)
class DeviceMesh:
    devices: Tuple[torch.device, ...]  # this process's shards, in grid order
    shape: Tuple[int, ...]             # (docs,) or (dp, docs), global
    axis_names: Tuple[str, ...] = (DOC_AXIS,)
    # across processes: the data group (candidates, score blocks, rows),
    # the gloo group of the coordinator's host broadcasts, this process's
    # rank and the world size, and the data group's backend
    group: Any = None
    ctrl_group: Any = None
    rank: int = 0
    world: int = 1
    backend: Optional[str] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} does not match axes "
                             f"{self.axis_names}")
        if self.size != self.world * len(self.devices):
            raise ValueError(
                f"{len(self.devices)} local devices x {self.world} "
                f"processes != {self.size} shards of {self.shape}")

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    @property
    def n_doc_shards(self) -> int:
        return int(self.shape[-1])

    @property
    def dp(self) -> int:
        return int(self.shape[0]) if DP_AXIS in self.axis_names else 1

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def multiprocess(self) -> bool:
        """Whether the shards meet over a process group (a group of one
        process included: its collectives still run on the backend)."""
        return self.group is not None

    def local_shards(self) -> List[Tuple[int, int, torch.device]]:
        """(dp row, doc column, device) of each shard this process holds."""
        base = self.rank * self.n_local
        d = self.n_doc_shards
        return [((base + i) // d, (base + i) % d, dev)
                for i, dev in enumerate(self.devices)]


def _devices(n: int, device) -> List[torch.device]:
    from evdr_tpu_torch.engine import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        have = [torch.device("cpu")]
    elif dev.index is not None:
        have = [dev]
    else:
        have = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if n > len(have):
        raise ValueError(f"need {n} devices, have {len(have)}")
    return have[:n]


def make_mesh(n_devices: Optional[int] = None, device="cuda"
              ) -> DeviceMesh:
    """1D doc mesh over the first ``n_devices`` GPUs (default: all of them).
    ``device='cpu'`` has one device, so only a mesh of one."""
    if n_devices is None:
        n_devices = (1 if torch.device(device).type == "cpu"
                     else max(1, torch.cuda.device_count()))
    devs = _devices(int(n_devices), device)
    return DeviceMesh(tuple(devs), (len(devs),), (DOC_AXIS,))


def make_mesh_2d(dp: int, docs: int, device="cuda") -> DeviceMesh:
    """2D mesh: ``dp`` query groups x ``docs`` doc shards, row-major over
    the first ``dp * docs`` GPUs."""
    devs = _devices(int(dp) * int(docs), device)
    return DeviceMesh(tuple(devs), (int(dp), int(docs)), (DP_AXIS, DOC_AXIS))


def mesh_of(devices: Sequence, dp: int = 1) -> DeviceMesh:
    """A one-process mesh over the given devices, repeats allowed (e.g.
    ``mesh_of(["cuda:0"] * 4)``, or ``mesh_of(["cpu"] * 4, dp=2)`` for a
    2 x 2 mesh): ``dp`` groups of ``len(devices) // dp`` doc shards."""
    devs = tuple(torch.device(d) for d in devices)
    if dp == 1:
        return DeviceMesh(devs, (len(devs),), (DOC_AXIS,))
    if len(devs) % dp:
        raise ValueError(f"{len(devs)} devices do not split into {dp} "
                         "groups")
    return DeviceMesh(devs, (int(dp), len(devs) // int(dp)),
                      (DP_AXIS, DOC_AXIS))


def gather_blocks(blocks: Sequence[torch.Tensor], mesh: DeviceMesh,
                  dst, kind: Optional[str] = None) -> List[torch.Tensor]:
    """Every shard's block on ``dst``, in global shard order: this
    process holds ``blocks``, one per local shard, all of one shape and
    dtype. One process moves them; across processes they are all-gathered
    on the mesh's data group (a collective: every process calls it with
    blocks of the same shape). gloo takes host tensors, so CUDA blocks
    are staged through host memory there; NCCL takes them on the card.
    Blocks travel as their raw bytes, since neither backend carries every
    dtype (gloo refuses int16, the bits of bf16 tokens). A search's
    gathers name their ``kind``: the bytes that arrive from other devices
    count there (``TRANSFER_BYTES``). The copies run in the span
    ``evdr.mesh.gather``."""
    with span("evdr.mesh.gather"):
        if not mesh.multiprocess:
            for dev, b in zip(mesh.devices, blocks):
                count_transfer(kind, b, dev, dst)
            return [b.to(dst) for b in blocks]
        return _all_gather_blocks(blocks, mesh, dst, kind)


def _all_gather_blocks(blocks, mesh: DeviceMesh, dst, kind: str):
    import torch.distributed as dist

    local = torch.stack([b.to(dst) for b in blocks])
    dtype = local.dtype
    local = local.view(torch.uint8)
    if mesh.backend == "gloo":
        local = local.cpu()
    out = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(out, local, group=mesh.group)
    if kind is not None:
        TRANSFER_BYTES[kind] += (mesh.world - 1) * local.numel()
    full = torch.cat(out).to(dst).view(dtype)
    return list(full.unbind(0))
