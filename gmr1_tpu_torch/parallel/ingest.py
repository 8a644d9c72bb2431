"""Shared ingest step of the multi-device forms: overlapped shards ->
analysis -> reshard.

Counterpart of gmr1_tpu/parallel/ingest.py, used by both multi-device
consumers: `parallel.transponder` (the fixed-schedule transponders) and
`rx.wideband.WidebandReceiver(mesh=...)` (the application).

  1. Time-parallel analysis: each device owns a contiguous wideband
     block.  The p*M filter-history samples (the overlap-save halo) are
     prepended to each shard by the host (`overlapped_shards`), which
     holds the raw stream anyway.
  2. Reshard: the channel bank flips from time-sharded to
     carrier-sharded.  JAX's tiled all_to_all(split_axis=1,
     concat_axis=0) becomes column blocks moved between devices: device
     j receives, for every shard i in ascending order, shard i's columns
     [j*M/D, (j+1)*M/D), concatenated along rows, so column c lives on
     device c // (M/D).  The bank travels as bf16 (round to nearest
     even, as XLA rounds) unless bf16_reshard=False.
  3. The caller consumes the carrier-sharded rows (RRC resample, demod,
     decode), device by device.

Two forms of the device set:

  * `Mesh`: one process and an ordered list of torch devices, one shard
    each.  A device may repeat (several shards on one card; the CPU
    tests' eight CPU shards).  The moves are tensor copies: peer copies
    over NVLink or PCIe on a multi-card host, no copy at all where two
    shards share a device.
  * a torch.distributed process group: one shard per rank and one
    `all_to_all_single` (gloo on the CPU, NCCL on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import checked_device


class Mesh:
    """Counterpart of a one-axis jax.sharding.Mesh: an ordered list of
    torch devices, shard i on devices[i].

    Mesh() takes every CUDA device and raises without CUDA;
    Mesh(["cpu"] * 8) is eight CPU shards, Mesh(["cuda:0"] * 2) two
    shards on one card."""

    def __init__(self, devices=None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Mesh() takes every CUDA device, but "
                    "torch.cuda.is_available() is false (pass the devices, "
                    "e.g. Mesh(['cpu'] * 8))")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devs = []
        for d in devices:
            d = checked_device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def put(self, shards: np.ndarray) -> list[torch.Tensor]:
        """(D, ...) host shards -> shard i on devices[i]."""
        return [torch.from_numpy(np.ascontiguousarray(s)).to(d)
                for s, d in zip(shards, self.devices)]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


class ShardedRows:
    """A tensor split along axis 0 into equal contiguous blocks, block j
    on its own device: the counterpart of a jax.Array sharded P(axis)
    over its first axis.  `device` is the first block's device, where the
    receivers' phases run."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.per = self.parts[0].shape[0]

    @property
    def shape(self) -> tuple:
        return (self.per * len(self.parts), *self.parts[0].shape[1:])

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def owners(self, rows):
        """Split global row indices rows (C,) by the block that holds
        them: yields (j, sel, local), sel indexing rows (on rows.device)
        and local the rows within block j (on its device)."""
        own = torch.div(rows, self.per, rounding_mode="floor").cpu()
        for j, part in enumerate(self.parts):
            sel = torch.nonzero(own == j).flatten()
            if len(sel):
                sel = sel.to(rows.device)
                yield j, sel, (rows[sel] - j * self.per).to(part.device)

    def take(self, rows, device=None) -> torch.Tensor:
        """Rows (global indices) gathered onto `device` (the first
        block's by default); only the rows taken move."""
        device = self.device if device is None else torch.device(device)
        rows = torch.as_tensor(np.asarray(rows), dtype=torch.int64,
                               device=device)
        p0 = self.parts[0]
        out = torch.empty((rows.shape[0], *p0.shape[1:]), dtype=p0.dtype,
                          device=device)
        for j, sel, local in self.owners(rows):
            out[sel] = self.parts[j][local].to(device)
        return out

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on one device (tests and checks only)."""
        device = self.device if device is None else torch.device(device)
        return torch.cat([p.to(device) for p in self.parts])


def overlapped_shards(x, tail, halo_len: int, d: int):
    """Host-side halo duplication: x (D*n_local, 2) planar + carried
    tail (halo_len, 2) -> ((D, halo_len + n_local, 2), new_tail).

    Shard i gets [x[i*n_local - halo_len : i*n_local] | its block];
    shard 0's left edge is the PREVIOUS step's tail, so streaming is
    sample-exact across steps.  Works on numpy arrays or tensors."""
    is_t = isinstance(x, torch.Tensor)
    n_local = x.shape[0] // d
    if x.shape[0] != d * n_local:
        raise ValueError(f"{x.shape[0]} samples do not split into {d} shards")
    parts = []
    for i in range(d):
        left = tail if i == 0 else x[i * n_local - halo_len:i * n_local]
        blk = x[i * n_local:(i + 1) * n_local]
        parts.append(torch.cat([left, blk]) if is_t
                     else np.concatenate([left, blk], axis=0))
    return (torch.stack(parts) if is_t else np.stack(parts)), x[-halo_len:]


def analyze_reshard(ana, mesh, shards, bf16_reshard: bool = True):
    """One ingest step: analysis of every time shard, then the reshard
    to carrier-sharded rows.

    ana:    channelizer PFBAnalyzer
    mesh:   a `Mesh` (shards: one (p*M + n_local, 2) block per device,
            the halo already prepended, see overlapped_shards) or a
            torch.distributed ProcessGroup (shards: this rank's block)
    Returns the (M/D, R_total, 2) float32 carrier rows: a list, one per
    mesh device (on it), or this rank's tensor."""
    if not isinstance(mesh, Mesh):
        return _analyze_reshard_group(ana, mesh, shards, bf16_reshard)
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for {mesh}")
    d = mesh.size
    if ana.m % d:
        raise ValueError(f"M={ana.m} does not split over {d} devices")
    ml = ana.m // d
    banks = []
    for dev, xh in zip(mesh.devices, shards):
        bank = ana.block(xh.to(dev))                    # (R_local, M, 2)
        banks.append(bank.to(torch.bfloat16) if bf16_reshard else bank)
    out = []
    for j, dev in enumerate(mesh.devices):
        # torch.cat always writes a new tensor: shards that share a device
        # (a repeated mesh entry) never alias a received block
        bank_c = torch.cat([b[:, j * ml:(j + 1) * ml].to(dev) for b in banks])
        out.append(bank_c.to(torch.float32).permute(1, 0, 2))
    return out


def _analyze_reshard_group(ana, group, xh_local, bf16_reshard: bool):
    """analyze_reshard over a process group: one shard per rank, and one
    all_to_all_single from time-sharded to carrier-sharded rows."""
    import torch.distributed as dist
    d = dist.get_world_size(group)
    if ana.m % d:
        raise ValueError(f"M={ana.m} does not split over {d} ranks")
    ml = ana.m // d
    bank = ana.block(xh_local)                          # (R_local, M, 2)
    r_local = bank.shape[0]
    send = bank.reshape(r_local, d, ml, 2).permute(1, 0, 2, 3).contiguous()
    if bf16_reshard:
        # the bf16 bits travel as bytes, which every backend moves (gloo
        # refuses bf16 and int16)
        send = send.to(torch.bfloat16).view(torch.uint8)
    recv = torch.empty_like(send)                    # (D, R_local, Ml, .)
    dist.all_to_all_single(recv, send, group=group)
    if bf16_reshard:
        recv = recv.view(torch.bfloat16).to(torch.float32)
    return recv.reshape(d * r_local, ml, 2).permute(1, 0, 2)


def ici_bytes_per_step(ana, r_local: int, d: int,
                       bf16_reshard: bool = True) -> int:
    """Per-device reshard bytes a step: the bank exchange ((D-1)/D of the
    local bank each way).  The halo rides the host upload.  On the card
    these are peer copies (NVLink or PCIe), not ICI; the name is JAX's."""
    elt = 2 if bf16_reshard else 4
    return 2 * r_local * ana.m * 2 * elt * (d - 1) // d
