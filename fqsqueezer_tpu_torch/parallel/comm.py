"""The ranks of a mesh: their collectives and their launcher.

A mesh archive's dp shards can run on several processes, one rank each
(parallel.mesh_pipeline and parallel.sharded with a `comm`): rank r of R
holds dp shards [r * dp / R, (r + 1) * dp / R) and runs them in turn, as
the one-process path runs all dp of them. The ranks meet where the
reference's mesh gathers over its dp axis (jax.lax.all_gather(..., "dp",
tiled=True)): a batch's shard events, the routed exchange's kept event
lists, and at a group flush the shards' words, counts and lane states. The
gather here is that: every rank's tensor, concatenated in rank order,
which is shard order. Every rank holds the whole state.

Backends, taken from the device, never one in place of another:

  nccl   CUDA tensors, one card a rank (rank r on cuda:r)
  gloo   the CPU, or ranks that share one CUDA card (a test arrangement:
         their tensors are staged through host memory here)

launch() spawns the ranks (torch.multiprocessing's spawn method), each
running fn(comm, *args) with fn a function of this package, so that a
rank imports the port and nothing else (it checks its sys.modules). They
meet on a FileStore in a temporary directory of the call's own, so calls
side by side never collide on a port, and the process group has a
timeout. If a rank raises, every rank is ended and the caller gets one
line, RankError("rank r: <its error>"); launch() returns the ranks'
results in rank order.
"""
from __future__ import annotations

import datetime
import json
import os
import pickle
import shutil
import sys
import tempfile
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
PG_TIMEOUT_S = 600          # a collective's wait for the slowest rank
_FOREIGN = ("jax", "jaxlib", "fqsqueezer_tpu")


class RankError(RuntimeError):
    """A rank of launch() failed; the message is one line."""


class Comm(NamedTuple):
    """A rank's place in its process group: rank of world, the device its
    tensors live on, and whether its collectives stage them through host
    memory (gloo with a CUDA device)."""
    rank: int
    world: int
    device: torch.device
    staged: bool


def shards(comm, dp: int) -> range:
    """The dp shards this rank holds: all of them without a comm."""
    if comm is None:
        return range(dp)
    if dp % comm.world:
        raise ValueError(f"{comm.world} ranks cannot split a dp {dp} mesh: "
                         f"the ranks must divide dp")
    n = dp // comm.world
    return range(comm.rank * n, (comm.rank + 1) * n)


def lead(comm) -> bool:
    """Whether this process does the I/O: one process alone, or rank 0."""
    return comm is None or comm.rank == 0


def _all_gather(comm: Comm, buf: torch.Tensor) -> torch.Tensor:
    """[world, n] of every rank's 1-D buf, rank order, on comm.device."""
    if comm.staged:
        host = buf.cpu()
        out = [torch.empty_like(host) for _ in range(comm.world)]
        dist.all_gather(out, host)
        return torch.stack(out).to(comm.device)
    if buf.device.type == "cuda":
        out = buf.new_empty((comm.world, buf.numel()))
        dist.all_gather_into_tensor(out, buf)
        return out
    out = [torch.empty_like(buf) for _ in range(comm.world)]
    dist.all_gather(out, buf)
    return torch.stack(out)


def _leaves(tree, out):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _leaves(t, out)
    elif tree is not None:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return None if tree is None else next(it)


def gather_tree(comm, tree):
    """Every rank's tree of tensors (nested tuples and lists, None leaves
    kept), each leaf concatenated along dim 0 over the ranks in rank order
    (0-d leaves stacked): one collective for the whole tree, its leaves
    packed as bytes. Every rank must pass leaves of the same shapes and
    dtypes. Without a comm the tree comes back as it is."""
    if comm is None:
        return tree
    leaves = _leaves(tree, [])
    parts, spans, at = [], [], 0
    for t in leaves:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % 8          # keeps every leaf 8-byte aligned
        parts.append(b)
        if pad:
            parts.append(b.new_zeros((pad,)))
        spans.append((at, b.numel()))
        at += b.numel() + pad
    if at == 0:
        return tree
    g = _all_gather(comm, torch.cat(parts).to(comm.device))
    out = []
    for t, (a, n) in zip(leaves, spans):
        per = [g[r, a:a + n].view(t.dtype).reshape(t.shape)
               for r in range(comm.world)]
        out.append(torch.stack(per) if t.dim() == 0 else torch.cat(per))
    return _rebuild(tree, iter(out))


def gather_padded(comm, t: torch.Tensor, counts) -> torch.Tensor:
    """The 1-D tensors of every rank, whose lengths differ, concatenated
    in rank order: each padded to the longest, gathered, then cut back.
    counts: every rank's length, in rank order (known to every rank, e.g.
    from a gather_tree of the word counts)."""
    if comm is None:
        return t
    counts = [int(c) for c in counts]
    if counts[comm.rank] != t.numel():
        raise ValueError(f"rank {comm.rank}: {t.numel()} elements, its "
                         f"count says {counts[comm.rank]}")
    m = max(counts)
    if m == 0:
        return t.new_zeros((0,))
    pad = torch.cat([t.reshape(-1), t.new_zeros((m - t.numel(),))])
    g = gather_tree(comm, pad.reshape(1, m))
    return torch.cat([g[r, :c] for r, c in enumerate(counts)])


def barrier(comm) -> None:
    """Wait until every rank gets here: after rank 0 closes a file that
    the ranks read next (one gather of a word)."""
    if comm is not None:
        gather_tree(comm, torch.zeros((1,), dtype=torch.int32,
                                      device=comm.device))


# --- the launcher ---------------------------------------------------------------

def _rank_devices(world: int, backend: str, device=None) -> list:
    """The device of each rank: nccl one card a rank, cuda:0 .. cuda:R-1
    (`device` must be None); gloo `device` for every rank, the CPU or one
    CUDA card they share. Raises ValueError, one line, where the machine
    cannot hold the ranks so: nothing falls back to another backend."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: use one of {BACKENDS}")
    if world < 1:
        raise ValueError(f"{world} ranks")
    if backend == "nccl":
        if device is not None:
            raise ValueError("nccl puts rank r on cuda:r; name no device")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < world:
            raise ValueError(f"nccl needs one CUDA card a rank: {world} "
                             f"ranks, torch sees {n} card(s)")
        return [torch.device("cuda", r) for r in range(world)]
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(f"gloo ranks on {dev}: no CUDA device is "
                             f"visible to torch")
        dev = torch.device("cuda", dev.index or 0)
    return [dev] * world


def launch(fn, args=(), world: int = 1, backend: str = "gloo", device=None,
           timeout: float | None = None) -> list:
    """Run fn(comm, *args) on `world` spawned ranks (see _rank_devices for
    backend and device) and return their results in rank order. fn must be
    a module-level function of this package and its args and result
    picklable. A rank that raises, dies or outlives `timeout` seconds ends
    every rank, and the call raises RankError with one line: the first
    error a rank reported (others then fail in their collectives)."""
    devices = _rank_devices(world, backend, device)
    threads = max(1, torch.get_num_threads() // world)
    tmp = tempfile.mkdtemp(prefix="fqtz_ranks.")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world, backend, str(devices[r]), tmp, fn, tuple(args), threads))
        for r in range(world)]
    t_end = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while True:
            reports = _reports(tmp, world)
            if reports:
                _, r, msg = min(reports)
                raise RankError(f"rank {r}: {msg}")
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                break
            dead = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if dead:
                time.sleep(0.2)       # its report may still be landing
                reports = _reports(tmp, world)
                if reports:
                    _, r, msg = min(reports)
                    raise RankError(f"rank {r}: {msg}")
                r, c = dead[0]
                raise RankError(f"rank {r} exited with code {c} and no "
                                f"report")
            if t_end is not None and time.monotonic() > t_end:
                raise RankError(f"the {world} ranks did not finish within "
                                f"{timeout} s")
            time.sleep(0.02)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.out"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def _reports(tmp: str, world: int) -> list:
    """[(time, rank, one-line error)] of the ranks that reported one."""
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            out.append((d["t"], r, d["msg"]))
    return out


def _foreign_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in _FOREIGN)


def _rank_main(rank, world, backend, device, tmp, fn, args, threads):
    """A spawned rank: join the group, run fn, write its result, or
    report its error in one line and exit 1 at once."""
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        comm = Comm(rank, world, dev, backend == "gloo" and dev.type == "cuda")
        result = fn(comm, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        foreign = _foreign_modules()
        if foreign:
            raise RuntimeError(f"the rank imported {foreign[:5]}")
        part = os.path.join(tmp, f"rank{rank}.out.part")
        with open(part, "wb") as f:
            pickle.dump(result, f)
        os.replace(part, os.path.join(tmp, f"rank{rank}.out"))
        dist.destroy_process_group()
    except Exception as e:     # the rank's boundary: reported, then exit
        msg = " ".join(f"{type(e).__name__}: {e}".split())
        part = os.path.join(tmp, f"rank{rank}.err.part")
        with open(part, "w") as f:
            json.dump({"t": time.time(), "msg": msg}, f)
        os.replace(part, os.path.join(tmp, f"rank{rank}.err"))
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
