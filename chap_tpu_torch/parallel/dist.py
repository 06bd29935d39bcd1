"""Data parallelism over ranks with torch.distributed (port of
chap_tpu/parallel/mesh.py for every trainer, the 2D eval and the
sliding-window eval).

The contract: W ranks compute what one process computes over the global
batch, which is what chap_tpu's mesh computes (its sharded step is one GSPMD
program, so the step on a mesh is the one-device step over the global
batch, tests/test_parallel.py). The same seed gives at W = 1 and at W = 2
the same metrics, parameters, BN running statistics, GradSim scores,
checkpoints and eval scores, up to float32 summation order.

The port's step is eager and runs on each rank, so every sum over rows that
the one-process step takes becomes a global sum:
  * BatchNorm in train mode normalises with the statistics of every rank's
    rows (each rank's count, mean and sum of squared deviations gathered
    with one all-reduce and combined alike on every rank) and all-reduces
    the two cotangent sums of its backward (models/layers.py);
  * K1's per-class statistics are all-reduced between its kernel and the
    compose (ops/fused_losses.py); the means over rows (CE, the VAT
    divergence, the channel-dropout rescale) are all-reduced (sum, count);
  * the GradSim gradients are summed before the cosine, and the parameter
    gradients once after ``backward`` (``all_reduce_grads``), summed and not
    averaged, since the loss is already the global one.
No DistributedDataParallel wrapper: its reducer cannot follow a step that
runs several forwards and takes ``autograd.grad`` before ``backward``, and
SyncBatchNorm keeps the unbiased running variance and refuses CPU tensors.

The two reductions differ in their backward, and both are the identity at
W = 1, so only a W > 1 run tells them apart. The loss is replicated (every
rank computes the same scalar and seeds its backward with 1):
  * ``all_reduce_replicated``: a statistic whose consumer is replicated (K1's
    compose, a mean) already receives the full cotangent on every rank, so
    its backward is the identity; an all-reduce there would scale the
    gradient by W;
  * ``all_reduce_partial``: a statistic whose consumer is rank-local (BN's
    normalised rows) receives only the local part of its cotangent, which
    its backward all-reduces.

Every rank runs the same program, so the collectives stay in lockstep, also
when ``optim.remat`` recomputes a forward in the backward: no collective may
sit behind a rank-dependent branch. Only ``all_reduce`` and ``broadcast``
are used, which gloo also takes for CUDA tensors, so two gloo ranks on one
card run the same code as NCCL ranks on many; a gather is an all-reduce of a
zero-filled buffer of the global shape. At W = 1 every helper here is the
identity and issues no collective.

Layout (``rank_rows``): W must divide ``data.batch_size``, as chap_tpu's
mesh requires (chap_tpu/train/trainer_2d.py:46-50). chap_tpu gives each
process a contiguous slice of the global [labeled ; unlabeled] batch, which
its one global program reassembles (mesh.py ProcessLocalBatchSampler). The
port's per-rank eager step pairs rows by index across the CHAP batch's four
roles (img_a, img_b, uimg_a, uimg_b of s = labeled_bs / 2 rows each), so it
deals pair-stream units instead: unit 2p is stream a's pair (img_a[p],
uimg_a[p]) and unit 2p + 1 stream b's (img_b[p], uimg_b[p]), U = 2s units,
and rank r holds units [floor(r U / W), floor((r + 1) U / W)). Every pairing
of the step (the BCP mix, the mix losses, a row's pseudo-labels, K2 maps and
top-k mask) stays inside a unit, so no row crosses ranks and no collective
is added; each pass gets one row a unit. A rank's two streams may differ
by one row, and where U < W a rank may hold none (LA's batch 4 at W = 4):
it still issues every collective. When W divides s this is rank r's rows
[r s/W, (r+1) s/W) of every role. A batch of one stream (the supervised
step, cps) is a contiguous 1/W of its rows. ``roles`` names the stream of
each equal role of a batch: ``CHAP_ROLES`` (0, 1, 0, 1), the teacher's
[uimg_a ; uimg_b] (0, 1), the student's mixed [b ; a] (1, 0), ``ONE_ROLE``.
The ACAL and ablation batches, [labeled_bs labeled ; B - labeled_bs
unlabeled], pair no row with another (each row's two decoders are compared
on that row), so ``Halves(labeled_bs)`` deals each half on its own: rank r
holds rows [floor(r n / W), floor((r + 1) n / W)) of a half of n rows, for
any labeled_bs; a rank may hold rows of one half only, or none.
"""
from __future__ import annotations

import contextlib
import datetime
import logging
import multiprocessing as mp
import os
import tempfile
import time
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from chap_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

# the stream of each role of a CHAP batch [img_a ; img_b ; uimg_a ; uimg_b],
# each s = labeled_bs / 2 rows; and of a batch of one stream
CHAP_ROLES = (0, 1, 0, 1)
ONE_ROLE = (0,)


class Halves(NamedTuple):
    """The layout of a [labeled ; unlabeled] batch whose two halves are
    dealt each on its own (the ACAL and ablation batches; module
    docstring), given where ``roles`` is: ``labeled`` leading rows, the
    rest unlabeled."""
    labeled: int


# a batch's layout: its roles' streams, or Halves
Layout = Union[Sequence[int], Halves]


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """W: the process group's size, 1 without a group."""
    return dist.get_world_size() if _active() else 1


def rank() -> int:
    return dist.get_rank() if _active() else 0


def is_main() -> bool:
    """Rank 0, the rank that writes files and logs."""
    return rank() == 0


def _local_device(device: torch.device, rank_: int) -> torch.device:
    """``cuda:LOCAL_RANK`` for a bare ``cuda`` (torchrun's local rank, else
    the rank modulo the cards this host has)."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank_ % torch.cuda.device_count()
    return torch.device("cuda", index)


def init_distributed(cfg, device: Optional[Union[str, torch.device]] = None
                     ) -> Tuple[int, int, torch.device]:
    """Join the process group that is already initialised, or else one from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR ...): NCCL when
    ``device`` is CUDA, gloo on the CPU. Without either, W = 1, nothing is
    initialised and ``device`` comes back as it is. Returns (rank, world,
    local_device); in a group on the card the local device is
    ``cuda:LOCAL_RANK``, and it becomes the current device.

    ``parallel.num_devices`` 0 means the world size (chap_tpu's "all visible
    devices"); any other value must equal W. ``parallel.dcn_axis_size`` must
    divide W and changes nothing: ranks are flat (logged once)."""
    device = resolve_device(device)
    if not _active() and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(_local_device(device, int(os.environ["RANK"])))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    rank_, world = rank(), world_size()
    local = _local_device(device, rank_) if _active() else device
    if _active() and local.type == "cuda":
        torch.cuda.set_device(local)
    par = cfg.parallel
    if par.num_devices not in (0, world):
        raise ValueError(f"parallel.num_devices={par.num_devices} but the "
                         f"process group has {world} rank(s): 0 means all of "
                         f"them, any other value must equal the world size "
                         f"(data parallelism, ROADMAP item 16, runs one "
                         f"process per card: torchrun --nproc_per_node "
                         f"{par.num_devices} ...)")
    if par.dcn_axis_size < 1 or world % par.dcn_axis_size:
        raise ValueError(f"parallel.dcn_axis_size={par.dcn_axis_size} must "
                         f"divide the world size {world}")
    if par.dcn_axis_size > 1:
        logger.info("parallel.dcn_axis_size=%d: chap_tpu's outer multi-slice "
                    "mesh axis; ranks are flat here, so it changes nothing",
                    par.dcn_axis_size)
    return rank_, world, local


@contextlib.contextmanager
def process_group(cfg, device: Optional[Union[str, torch.device]] = None):
    """``init_distributed`` for an entry point: yields (rank, world,
    local_device) and destroys the process group at exit, also on error,
    if it was created here."""
    created = not _active()
    try:
        yield init_distributed(cfg, device)
    finally:
        if created and _active():
            dist.destroy_process_group()


def describe() -> str:
    """The process group in one line, for the logs."""
    if not _active():
        return "one process"
    return (f"backend {dist.get_backend()}, rank {rank()} of {world_size()}")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (no autograd) and return it; inside
    ``record_collectives`` it also appends (numel, dtype) to the record."""
    if world_size() > 1:
        if all_reduce_.record is not None:
            all_reduce_.record.append((t.numel(), t.dtype))
        dist.all_reduce(t)
    return t


all_reduce_.record = None


@contextlib.contextmanager
def record_collectives():
    """Yield a list that receives (numel, dtype) of every all-reduce made
    inside the block: the sequence every rank must issue alike."""
    previous, all_reduce_.record = all_reduce_.record, []
    try:
        yield all_reduce_.record
    finally:
        all_reduce_.record = previous


class _AllReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad


class _AllReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone())


def all_reduce_replicated(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks; backward the identity (the consumer is
    replicated, see the module docstring). The identity at W = 1."""
    return _AllReduceReplicated.apply(x) if world_size() > 1 else x


def all_reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks; backward an all-reduce sum of the cotangent (the
    consumer is rank-local). The identity at W = 1."""
    return _AllReducePartial.apply(x) if world_size() > 1 else x


def global_sums(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` summed over the ranks with one all-reduce (float32,
    ``all_reduce_replicated``), back in its own shape and dtype; the inputs
    themselves at W = 1."""
    if world_size() == 1:
        return xs
    flat = all_reduce_replicated(torch.cat([x.reshape(-1).float() for x in xs]))
    out, start = [], 0
    for x in xs:
        out.append(flat[start:start + x.numel()].view(x.shape).to(x.dtype))
        start += x.numel()
    return tuple(out)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch (x's elements on every
    rank), differentiable; ``x.mean()`` at W = 1. A bf16 ``x`` is summed in
    float32 and rounded once, as its mean at W = 1 is."""
    if world_size() == 1:
        return x.mean()
    count = torch.full((), float(x.numel()), device=x.device)
    total = all_reduce_replicated(torch.stack([x.sum(dtype=torch.float32),
                                               count]))
    return (total[0] / total[1]).to(x.dtype)


def gather_rows(x: torch.Tensor, rows: int,
                roles: Layout = ONE_ROLE) -> torch.Tensor:
    """The global batch of ``rows`` rows on every rank, from each rank's
    rows ``x`` of it (``rank_rows`` with ``roles``), in global row order:
    an all-reduce (float32, exact: every element is one rank's value plus
    zeros) of a zero-filled buffer of the global shape, back in x's dtype.
    No autograd; ``x`` itself at W = 1."""
    if world_size() == 1:
        return x
    buf = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    idx = rank_rows(rows, roles)
    if idx:
        buf[torch.tensor(idx, device=x.device)] = x.detach().float()
    return all_reduce_(buf).to(x.dtype)


def sum_tensors(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, with one all-reduce of one flat
    bucket (no autograd); the tensors themselves at W = 1."""
    tensors = list(tensors)
    if world_size() == 1 or not tensors:
        return tensors
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors]))
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view_as(t))
        start += t.numel()
    return out


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Sum the parameters' gradients over the ranks in one flat bucket
    (summed, not averaged: each rank holds its rows' part of the global
    loss's gradient), in place. Parameters without a gradient are skipped;
    every rank has the same ones."""
    if world_size() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for g, total in zip(grads, sum_tensors(grads)):
        g.copy_(total)


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; nothing at W = 1."""
    if world_size() > 1:
        dist.broadcast(t, src)
    return t


def broadcast_state(module: torch.nn.Module, src: int = 0) -> bool:
    """Copy rank ``src``'s parameters and buffers to every rank (one
    broadcast per dtype). Returns whether anything on this rank changed:
    ranks that built the module from the same seed hold the same values."""
    if world_size() == 1:
        return False
    tensors = list(module.parameters()) + list(module.buffers())
    changed = False
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        got = broadcast_(flat.clone(), src)
        if not torch.equal(got, flat):
            changed = True
            start = 0
            with torch.no_grad():
                for t in group:
                    t.copy_(got[start:start + t.numel()].view_as(t))
                    start += t.numel()
    return changed


def broadcast_array(value: np.ndarray, device: torch.device,
                    src: int = 0) -> np.ndarray:
    """Rank ``src``'s float array on every rank (``value`` gives the shape
    on the others); ``value`` itself at W = 1."""
    if world_size() == 1:
        return value
    t = torch.as_tensor(np.asarray(value, np.float64), device=device).clone()
    return broadcast_(t, src).cpu().numpy()


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def check_batch(batch_size: int, world: int, what: str) -> None:
    """W must divide the global batch, as chap_tpu's mesh requires;
    ValueError stating the rule otherwise."""
    if batch_size % world:
        raise ValueError(
            f"{what}: {world} ranks cannot share a batch of {batch_size}: W "
            f"must divide data.batch_size (chap_tpu's rule; here W in "
            f"{[w for w in range(1, batch_size + 1) if batch_size % w == 0]})")


def check_halves(batch_size: int, labeled_bs: int, world: int, what: str,
                 replay: bool = False) -> None:
    """The rule of a [labeled ; unlabeled] batch dealt by ``Halves``: W
    must divide ``data.batch_size`` (``check_batch``), and where the ACAL
    replay runs (``replay``, semi.acal) also labeled_bs and the unlabeled
    B - labeled_bs, as chap_tpu's trainer_share.py:86-90 asserts;
    ValueError stating the rule otherwise."""
    check_batch(batch_size, world, what)
    unlabeled = batch_size - labeled_bs
    if replay and (labeled_bs % world or unlabeled % world):
        allowed = [w for w in range(1, batch_size + 1) if not (
            batch_size % w or labeled_bs % w or unlabeled % w)]
        raise ValueError(
            f"{what}: {world} ranks cannot share the ACAL replay batch: with "
            f"semi.acal, W must divide data.labeled_bs {labeled_bs} and the "
            f"unlabeled {unlabeled} rows as well as data.batch_size "
            f"(chap_tpu's rule; here W in {allowed})")


def stream_rows(s: int, stream: int = 0, streams: int = 1,
                rank_: Optional[int] = None, world: Optional[int] = None
                ) -> range:
    """The positions p < ``s`` of ``stream`` (of ``streams``) whose unit
    streams * p + stream rank ``rank_`` of ``world`` holds (module
    docstring): a contiguous range, possibly empty."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    units = streams * s
    lo, hi = rank_ * units // world, (rank_ + 1) * units // world
    return range(-(-(lo - stream) // streams), -(-(hi - stream) // streams))


def half_rows(rows: int, labeled: int, rank_: Optional[int] = None,
              world: Optional[int] = None) -> Tuple[range, range]:
    """The rows that rank ``rank_`` of ``world`` holds of each half of a
    [labeled ; rows - labeled] batch (``Halves``), as positions within that
    half: [floor(r n / W), floor((r + 1) n / W)) of each half of n rows."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    return tuple(range(rank_ * n // world, (rank_ + 1) * n // world)
                 for n in (labeled, rows - labeled))


def rank_rows(rows: int, roles: Layout = ONE_ROLE,
              rank_: Optional[int] = None, world: Optional[int] = None
              ) -> List[int]:
    """The global rows that rank ``rank_`` of ``world`` holds of a batch of
    ``rows`` made of len(roles) equal roles, ``roles`` giving each one's
    stream (of 0 .. max(roles)), in role order; or, for ``Halves``, its
    rows of each half in turn (module docstring)."""
    if isinstance(roles, Halves):
        labeled, unlabeled = half_rows(rows, roles.labeled, rank_, world)
        return list(labeled) + [roles.labeled + i for i in unlabeled]
    s, streams = rows // len(roles), max(roles) + 1
    if rows % len(roles):
        raise ValueError(f"{rows} rows do not split into {len(roles)} roles")
    return [i * s + p for i, stream in enumerate(roles)
            for p in stream_rows(s, stream, streams, rank_, world)]


def shard_rows(x: Optional[torch.Tensor],
               roles: Layout = ONE_ROLE,
               rank_: Optional[int] = None, world: Optional[int] = None
               ) -> Optional[torch.Tensor]:
    """This rank's rows of ``x`` (leading axis, ``roles`` as in
    ``rank_rows``); 0-d tensors, scalars and None are shared and come back
    as they are, and at W = 1 so does ``x``."""
    world = world_size() if world is None else world
    if world == 1 or not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    idx = rank_rows(x.shape[0], roles, rank_, world)
    if not idx or idx == list(range(idx[0], idx[0] + len(idx))):
        start = idx[0] if idx else 0
        return x[start:start + len(idx)]
    return x[torch.tensor(idx, device=x.device)]


# ---------------------------------------------------------------------------
# local ranks without torchrun
# ---------------------------------------------------------------------------

def _rank_main(rank_: int, world: int, backend: str, store: str,
               device: str, fn, args: tuple, out: str, timeout: float) -> None:
    # this host's cores shared out, as torchrun's one OpenMP thread a rank:
    # ranks that wait on each other in every collective must not also
    # compete for the cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank_, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(_local_device(torch.device(device), rank_))
        torch.save(fn(*args), f"{out}.{rank_}")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple = (), backend: str = "gloo",
                device: str = "cpu", timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` on ``world`` spawned local ranks joined in a
    process group of ``backend`` (a file store in a temporary directory),
    with ``device``'s card (``cuda`` without an index: the rank modulo the
    cards) current on the card and the host's cores shared out among the
    ranks, and return each rank's result, in rank order. ``fn`` must be importable by name (a module-level function), its
    arguments and result picklable. Raises if a rank fails or the ranks
    outlast ``timeout`` seconds (also each collective's limit); every
    process started here is stopped."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, backend, os.path.join(tmp, "store"),
                                   device, fn, args, out, timeout))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks exited with {codes} (a negative code "
                               f"is the signal that stopped it)")
        # written by the ranks above, in this call's own directory
        return [torch.load(f"{out}.{r}", weights_only=False)
                for r in range(world)]
