"""Multi-process execution over ``torch.distributed``, port of
:mod:`swmhd_tpu.parallel.multihost`.

One process per tile of the domain decomposition. :func:`initialize`
joins the process group that ``torchrun`` describes in the environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) and picks the backend from the device
layout, once, and logs it:

- **NCCL** when every rank of a host has a card of its own
  (``torch.cuda.set_device(LOCAL_RANK)`` before the group starts);
- **gloo** on the CPU, or when ranks share a card: NCCL refuses two
  ranks on one card, and gloo cannot send CUDA tensors, so the
  collectives below stage CUDA tensors through host memory on gloo.

Nothing switches the backend afterwards. With no process group (one
process), every collective here is a no-op on the local data.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess

import torch
import torch.distributed as dist

logger = logging.getLogger("swmhd_tpu_torch")

# Tags of the two halo messages along one axis, so the two messages
# between the same pair of ranks (two tiles on a periodic axis) stay apart.
TAG_LOW, TAG_HIGH = 1, 2


def initialize(device: str = "cuda") -> torch.device:
    """Join the process group of ``torchrun``'s environment and return this
    rank's device: ``cuda:LOCAL_RANK`` on NCCL, a shared card
    (``cuda:LOCAL_RANK % device_count``) or the CPU on gloo. ``device``
    is ``"cuda"`` or ``"cpu"``; ``"cuda"`` without CUDA raises."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' but CUDA is not available "
                               "(pass device='cpu' for the CPU)")
        n_cards = torch.cuda.device_count()
        if local_world <= n_cards:
            backend = "nccl"
            dev = torch.device("cuda", local_rank)
            why = f"{local_world} ranks on {n_cards} cards, one each"
        else:
            backend = "gloo"
            dev = torch.device("cuda", local_rank % n_cards)
            why = (f"{local_world} ranks share {n_cards} card(s); halo "
                   f"slabs are staged through host memory")
        torch.cuda.set_device(dev)
    else:
        backend, dev, why = "gloo", torch.device("cpu"), "CPU tensors"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world, **kwargs)
    dist.barrier()
    if rank == 0:
        logger.info("process group: %d ranks, backend %s (%s)", world,
                    backend, why)
    return dev


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _staged(t: torch.Tensor) -> bool:
    """Does this tensor cross the group through host memory (gloo with a
    CUDA tensor)?"""
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over all ranks (a new tensor on ``t``'s device)."""
    if world_size() == 1:
        return t
    buf = t.detach().cpu().clone() if _staged(t) else t.clone()
    dist.all_reduce(buf, op=op)
    return buf.to(t.device)


def all_gather(t: torch.Tensor):
    """``[t of rank 0, t of rank 1, ...]``, each on ``t``'s device."""
    if world_size() == 1:
        return [t]
    src = t.detach().contiguous()
    if _staged(t):
        src = src.cpu()
    bufs = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(bufs, src)
    return [b.to(t.device) for b in bufs]


def exchange(send_low, send_high, low_rank: int, high_rank: int):
    """Send ``send_low`` to ``low_rank`` and ``send_high`` to ``high_rank``
    (either may be None: nothing goes that way); return ``(from_low,
    from_high)``, what ``low_rank`` sent up and ``high_rank`` sent down,
    shaped like the slab this rank sent the other way.

    The receives are posted in the order of the sends they match, and
    each message carries a tag saying which way it goes: when both
    neighbours are the same rank (two tiles on a periodic axis), NCCL
    matches the messages by order and gloo by tag."""
    ops, recv = [], {}
    like = send_low if send_low is not None else send_high
    staged = _staged(like)

    def out(t):
        t = t.contiguous()
        return t.cpu() if staged else t

    if send_low is not None:
        ops.append(dist.P2POp(dist.isend, out(send_low), low_rank,
                              tag=TAG_LOW))
    if send_high is not None:
        ops.append(dist.P2POp(dist.isend, out(send_high), high_rank,
                              tag=TAG_HIGH))
    if send_high is not None:   # high_rank's low slab, sent with TAG_LOW
        recv["high"] = torch.empty(send_high.shape, dtype=like.dtype,
                                   device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, recv["high"], high_rank,
                              tag=TAG_LOW))
    if send_low is not None:
        recv["low"] = torch.empty(send_low.shape, dtype=like.dtype,
                                  device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, recv["low"], low_rank,
                              tag=TAG_HIGH))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    got = {k: v.to(like.device) for k, v in recv.items()}
    return got.get("low"), got.get("high")


def process_local_slab(mesh, Nx: int, Ny: int):
    """``((x0, x1), (y0, y1))``: the global index bounds of this rank's
    tile, the slab it writes in sharded I/O."""
    ix, iy = mesh.coords(rank())
    nx, ny = Nx // mesh.px, Ny // mesh.py
    return (ix * nx, (ix + 1) * nx), (iy * ny, (iy + 1) * ny)


def shutdown() -> None:
    """Leave the process group, after a barrier; a no-op without one."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def sync(tag: str = "") -> None:
    """Barrier over all ranks; a no-op for one process. ``tag`` names the
    barrier in logs."""
    if world_size() > 1:
        logger.debug("barrier %s", tag)
        dist.barrier()


def run_checked(cmd, env=None, timeout=600, cwd=None,
                stderr=subprocess.STDOUT) -> str:
    """Run ``cmd`` (a launcher of ranks, or any command) in a process group
    of its own, with ``env`` added to the environment, and return its
    standard output (the errors too, unless ``stderr`` keeps them apart).
    On a timeout the whole group is killed, so no rank outlives it; a
    timeout or a nonzero exit raises ``RuntimeError`` with the tail of
    the output."""
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=stderr,
                         text=True, cwd=cwd,
                         env=dict(os.environ, **(env or {})),
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
        raise RuntimeError(f"{' '.join(cmd)} did not end within {timeout} s")
    if p.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {p.returncode}:\n"
                           f"{out[-6000:]}"
                           + (f"\n{err[-3000:]}" if err else ""))
    return out
