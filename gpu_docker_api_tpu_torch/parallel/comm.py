"""The collectives of the parallel axes, over torch.distributed groups.

The JAX package gets these from XLA (inside shard_map: lax.ppermute,
lax.all_to_all, the psum of replicated gradients; from sharding
annotations: the fsdp all-gather of a parameter and the reduce-scatter of
its gradient). torch.distributed's calls carry no gradient, so the ones
that sit inside the model are torch.autograd.Functions whose backward is
their transpose:

- ring_shift_start(tensors, sp, wire): send to rank + 1 and receive from
  rank - 1 in one batch_isend_irecv, returned in flight (RingHop) so the
  caller computes while it moves; backward sends the cotangents the other
  way.
- tie_hops: keeps the last hop's backward on every rank's graph.
- ring_shift(x, g): one hop, waited for: the pipeline's stage-to-stage
  hop over a pp group (parallel/pipeline.py).
- all_to_all(tensors, split_dim, concat_dim, sp): the tiled lax.all_to_all
  (split along one dim, the pieces gathered in rank order along another);
  backward is the inverse all-to-all.
- all_gather(tensors, dims, group): each parameter shard gathered whole
  along its dim (fsdp, in one collective); backward is the reduce-scatter
  (reduce_scatter_sum): the cotangents summed over the group in f32, this
  rank's slice kept.
- copy_to_group(x, g) and reduce_from_group(x, g): Megatron's f and g
  around a tensor-parallel block (the psums XLA inserts for the tp
  sharding rules): f is the identity whose backward sums the cotangent
  over the group, g the sum over the group whose backward is the
  identity; both sum in f32 and cast back.
- exchange_rows(x, send, recv, g): the expert-parallel dispatch, a
  variable-split all-to-all of rows (send[j] of x's rows to rank j, recv[j]
  from rank j, an empty split a valid one); backward is the reverse
  exchange, which every rank runs. exchange_counts(counts, g) trades the
  split sizes first, and gather_counts(counts, g) gives every rank's
  routing counts (no gradient; MoE's global routing).
- all_reduce_sum and all_reduce_max: in place, no gradient, for the
  trainer (the sum bucketed through a flat buffer).

Transport: on an NCCL group the tensors go as they are. On a gloo group a
CUDA tensor goes through a host buffer and comes back to its device,
because gloo has no CUDA send/recv or all-to-all; that is how one card
holds several ranks (chip_smoke.py asks for gloo by name). A CPU tensor on
gloo goes as it is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

# elements of one flat f32 bucket of all_reduce_sum (256 MB)
BUCKET = 1 << 26


@dataclass(frozen=True)
class AxisGroup:
    """The ranks of one parallel axis: the torch.distributed group (None =
    the default group), this process's rank in it and its size. Under sp
    each rank holds the rank-th S/size shard of the sequence, under fsdp
    the rank-th 1/size of each sharded parameter."""
    group: Any
    rank: int
    size: int

    @classmethod
    def of(cls, group=None) -> "AxisGroup":
        """The group (default: the whole world) as seen from this rank."""
        return cls(group=group, rank=dist.get_rank(group),
                   size=dist.get_world_size(group))

    @property
    def staged(self) -> bool:
        """True on a gloo group: CUDA tensors travel through the host."""
        return dist.get_backend(self.group) == "gloo"


# the name the sequence-parallel code (ring.py, ulysses.py) uses
SPGroup = AxisGroup


def _wire(t: torch.Tensor, sp: AxisGroup) -> torch.Tensor:
    """What goes on the wire: a contiguous tensor, on the host when a gloo
    group carries a CUDA tensor."""
    t = t.contiguous()
    return t.cpu() if sp.staged and t.is_cuda else t


# ---- ring shift ------------------------------------------------------------

def _global(sp: SPGroup, rank: int) -> int:
    """The global rank of group rank `rank` (what P2POp takes)."""
    return rank if sp.group is None else dist.get_global_rank(sp.group, rank)


def _post_shift(tensors: Sequence[torch.Tensor], sp: SPGroup, step: int,
                wire: Optional[torch.dtype] = None):
    """Send each tensor (as `wire` dtype, if given) to rank + step and
    receive its peer's from rank - step, in one batch. -> (works, send
    buffers, receive buffers); the send buffers must outlive the works."""
    dst = _global(sp, (sp.rank + step) % sp.size)
    src = _global(sp, (sp.rank - step) % sp.size)
    sends = [_wire(t if wire is None else t.to(wire), sp) for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, dst, sp.group) for t in sends]
           + [dist.P2POp(dist.irecv, t, src, sp.group) for t in recvs])
    return dist.batch_isend_irecv(ops), sends, recvs


class RingHop:
    """One hop in flight: wait() returns the tensors received from
    rank - 1, on the devices the sent ones were on."""

    def __init__(self, works, sends, recvs, staged_outs):
        self._works, self._sends = works, sends
        self._fill = [(o, r) for o, r in zip(staged_outs, recvs)
                      if o is not None]
        self.outs = None          # the autograd outputs (ring_shift_start)

    def wait(self) -> tuple[torch.Tensor, ...]:
        for w in self._works:
            w.wait()
        with torch.no_grad():
            for out, buf in self._fill:       # host -> device (gloo)
                out.copy_(buf)
        self._works = self._sends = self._fill = None
        return self.outs


class _RingShift(torch.autograd.Function):
    """Forward posts the hop and returns the tensors it will fill (through
    RingHop.wait, which must come before any read of them); backward sends
    each cotangent back to rank - 1, in its own dtype, and returns what
    rank + 1 sent."""

    @staticmethod
    def forward(ctx, sp, box, wire, *tensors):
        ctx.sp = sp
        works, sends, recvs = _post_shift(tensors, sp, +1, wire)
        # a buffer on another device or in another dtype is copied in
        staged = [None if (r.device, r.dtype) == (t.device, t.dtype)
                  else torch.empty_like(t) for r, t in zip(recvs, tensors)]
        box.append(RingHop(works, sends, recvs, staged))
        return tuple(r if o is None else o for r, o in zip(recvs, staged))

    @staticmethod
    def backward(ctx, *grads):
        works, _, recvs = _post_shift(grads, ctx.sp, -1)
        for w in works:
            w.wait()
        return (None, None, None,
                *(r.to(g.device) for r, g in zip(recvs, grads)))


def ring_shift_start(tensors: Sequence[torch.Tensor], sp: SPGroup,
                     wire: torch.dtype) -> RingHop:
    """Post one ring hop of `tensors` (rank -> rank + 1) and return it in
    flight; its wait() gives the tensors rank - 1 sent, in their dtype.
    They travel as `wire` (the ring sends f32 copies of bf16 values as
    bf16). Every rank of the group must post the same hop.
    Differentiable: the backward runs the hop's transpose (rank -> rank -
    1), the cotangents in their own dtype."""
    box: list = []
    outs = _RingShift.apply(sp, box, wire, *tensors)
    box[0].outs = outs
    return box[0]


def ring_shift(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """x sent to rank + 1 of the group, and what rank - 1 sent returned
    (one ring hop, in x's dtype, waited for). Differentiable: the backward
    sends the cotangent back to rank - 1. Every rank of the group must
    call it, in the same order."""
    return ring_shift_start([x], g, x.dtype).wait()[0]


class _Tie(torch.autograd.Function):
    """out unchanged; the tied tensors get zero cotangents."""

    @staticmethod
    def forward(ctx, out, *tied):
        ctx.tied = [(t.shape, t.dtype, t.device) for t in tied]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(shape, dtype=dtype, device=device)
                        for shape, dtype, device in ctx.tied))


def tie_hops(out: torch.Tensor, *received: torch.Tensor) -> torch.Tensor:
    """`out`, with the tensors the last ring hop received tied into its
    graph. A hop's backward is a collective, so every rank must run it;
    where a rank leaves what it received unused (a skipped causal pair)
    autograd would not, and the ring would hang. Tied, they get zero
    cotangents (the JAX ppermute transpose of an unused value), and the
    hops chain, so every hop's backward runs on every rank."""
    return _Tie.apply(out, *received)


# ---- all-to-all ------------------------------------------------------------

def _all_to_all_one(x: torch.Tensor, split_dim: int, concat_dim: int,
                    sp: SPGroup) -> torch.Tensor:
    n = sp.size
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    # piece j (along split_dim) goes to rank j: stack the pieces on dim 0
    send = _wire(torch.stack(x.chunk(n, dim=split_dim)), sp)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=sp.group)
    # recv[j] came from rank j: gather in rank order along concat_dim
    return torch.cat(recv.to(x.device).unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sp, split_dim, concat_dim, *tensors):
        ctx.sp, ctx.dims = sp, (split_dim, concat_dim)
        return tuple(_all_to_all_one(t, split_dim, concat_dim, sp)
                     for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        split_dim, concat_dim = ctx.dims
        # grads are materialized (an unused output's is zeros), so every
        # rank runs the same collectives in the same order
        return (None, None, None, *(
            _all_to_all_one(g, concat_dim, split_dim, ctx.sp)
            for g in grads))


def all_to_all(tensors: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int, sp: SPGroup) -> tuple[torch.Tensor, ...]:
    """lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True) of each tensor, in order: x splits into sp.size pieces along
    split_dim, piece j goes to rank j, and the pieces received are
    concatenated in rank order along concat_dim. Differentiable."""
    return _AllToAll.apply(sp, split_dim, concat_dim, *tensors)


# ---- fsdp: all-gather and reduce-scatter ------------------------------------

def _gather(tensors: Sequence[torch.Tensor], dims: Sequence[int],
            g: AxisGroup) -> list:
    """Each shard gathered whole along its dim, in one all-gather of their
    bytes (any dtypes, bit for bit)."""
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    send = _wire(flat, g)
    recv = send.new_empty(g.size * send.numel())
    dist.all_gather_into_tensor(recv, send, group=g.group)
    recv = recv.to(flat.device).view(g.size, -1)      # [rank, bytes]
    out, pos = [], 0
    for t, dim in zip(tensors, dims):
        n = t.numel() * t.element_size()
        pieces = recv[:, pos:pos + n].contiguous().view(t.dtype)
        out.append(torch.cat(pieces.view(g.size, *t.shape).unbind(0),
                             dim=dim))
        pos += n
    return out


def reduce_scatter_sum(tensors: Sequence[torch.Tensor], dims: Sequence[int],
                       g: AxisGroup) -> list:
    """Each tensor summed over the group in f32 and cut along its dim into
    group-size slices, this rank's slice kept (cast back to its dtype): one
    reduce-scatter for all of them. No gradient."""
    with torch.no_grad():
        rows = [torch.stack(t.float().chunk(g.size, dim=dim)).reshape(
            g.size, -1) for t, dim in zip(tensors, dims)]
        flat = torch.cat(rows, dim=1)                  # [rank, elements]
        send = _wire(flat, g)
        recv = send.new_empty(flat.shape[1])
        dist.reduce_scatter_tensor(recv, send.view(-1), op=dist.ReduceOp.SUM,
                                   group=g.group)
        recv = recv.to(flat.device)
        out, pos = [], 0
        for t, dim in zip(tensors, dims):
            shape = list(t.shape)
            shape[dim] //= g.size
            n = t.numel() // g.size
            out.append(recv[pos:pos + n].view(shape).to(t.dtype))
            pos += n
        return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, dims, *shards):
        ctx.g, ctx.dims = g, dims
        return tuple(_gather(shards, dims, g))

    @staticmethod
    def backward(ctx, *grads):
        # grads are materialised (an unused output's is zeros), so every
        # rank runs the same reduce-scatter
        return (None, None, *reduce_scatter_sum(grads, ctx.dims, ctx.g))


def all_gather(tensors: Sequence[torch.Tensor], dims: Sequence[int],
               g: AxisGroup) -> tuple[torch.Tensor, ...]:
    """Each rank's shard of each tensor gathered whole along its dim (the
    shards concatenated in rank order), in one collective: what XLA does
    for an fsdp-sharded parameter at its use. Differentiable: the backward
    is the reduce-scatter (each cotangent summed over the group in f32,
    this rank's slice kept). Every rank of the group must call it."""
    return _AllGather.apply(g, tuple(dims), *tensors)


@torch.no_grad()
def gather_leaf(t: torch.Tensor, dim: int, g: AxisGroup) -> torch.Tensor:
    """One shard gathered whole, no gradient (checkpoints, tests)."""
    return _gather([t.detach()], [dim], g)[0]


# ---- tp: Megatron's f and g -------------------------------------------------

def _sum_f32(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """A new tensor: x summed over the group in f32, cast back to x's
    dtype on x's device."""
    buf = x.detach().to(device=_wire_device(x, g), dtype=torch.float32,
                        copy=True, memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=g.group)
    return buf.to(device=x.device, dtype=x.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, _sum_f32(grad, ctx.g)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x):
        return _sum_f32(x, g)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def copy_to_group(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """x unchanged, where every rank of the group holds the same x and
    uses it on its own shard of a weight (a column-parallel product): the
    backward sums the ranks' partial cotangents over the group, in f32.
    Every rank of the group must call it."""
    return _CopyToGroup.apply(g, x)


def reduce_from_group(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """The sum over the group of each rank's partial x (a row-parallel
    product, a vocab shard's lookup), taken in f32 and cast back to x's
    dtype; the backward passes the cotangent through, as every rank holds
    the sum. Every rank of the group must call it."""
    return _ReduceFromGroup.apply(g, x)


# ---- ep: the expert dispatch and the routing counts -------------------------

@torch.no_grad()
def gather_counts(counts: torch.Tensor, g: Optional[AxisGroup]
                  ) -> torch.Tensor:
    """[g.size, *counts.shape]: every rank's `counts` (one shape and dtype
    on every rank), in group rank order, on counts' device; counts[None]
    without a group."""
    if g is None:
        return counts[None]
    send = _wire(counts, g).reshape(-1)
    recv = send.new_empty(g.size * send.numel())
    dist.all_gather_into_tensor(recv, send, group=g.group)
    return recv.to(counts.device).view(g.size, *counts.shape)


@torch.no_grad()
def exchange_counts(counts: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """counts [g.size]: counts[j] goes to rank j; returns what each rank
    sent this one, in rank order."""
    send = _wire(counts, g)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g.group)
    return recv.to(counts.device)


def _exchange(x: torch.Tensor, send: list, recv: list, g: AxisGroup
              ) -> torch.Tensor:
    out = _wire(x, g)
    got = out.new_empty((sum(recv), *x.shape[1:]))
    dist.all_to_all_single(got, out, recv, send, group=g.group)
    return got.to(x.device)


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, send, recv, x):
        ctx.g, ctx.splits = g, (send, recv)
        return _exchange(x, send, recv, g)

    @staticmethod
    def backward(ctx, grad):
        send, recv = ctx.splits
        # the rows go back where they came from (grad is materialised: an
        # unused output's is zeros, so every rank posts the exchange)
        return None, None, None, _exchange(grad, recv, send, ctx.g)


def exchange_rows(x: torch.Tensor, send: Sequence[int], recv: Sequence[int],
                  g: AxisGroup) -> torch.Tensor:
    """The rows of x [n, ...], grouped by destination: the first send[0]
    to rank 0, the next send[1] to rank 1, ...; returns the rows received,
    recv[j] from rank j, in rank order (recv as exchange_counts gives it).
    Every rank of the group must call it, with nothing to send or receive
    too. Differentiable: the backward sends each cotangent back to the row's
    source."""
    return _ExchangeRows.apply(g, list(send), list(recv), x)


# ---- trainer collectives (no gradient) --------------------------------------

def _buckets(tensors):
    """Consecutive groups of tensors of at most BUCKET elements (a larger
    tensor is a group of its own)."""
    group, size = [], 0
    for t in tensors:
        if group and size + t.numel() > BUCKET:
            yield group
            group, size = [], 0
        group.append(t)
        size += t.numel()
    if group:
        yield group


def _flat(group, dtype, device):
    return torch.cat([t.reshape(-1).to(dtype) for t in group]).to(device)


def _unflat(flat, group) -> None:
    pos = 0
    for t in group:
        t.copy_(flat[pos:pos + t.numel()].view(t.shape))
        pos += t.numel()


def _wire_device(t: torch.Tensor, g: AxisGroup):
    return torch.device("cpu") if g.staged else t.device


@torch.no_grad()
def all_reduce_sum(tensors: Sequence[torch.Tensor], g: AxisGroup) -> None:
    """Sum each tensor over the group, in place: the sum is taken in f32
    and cast back to each tensor's dtype."""
    for group in _buckets(tensors):
        flat = _flat(group, torch.float32, _wire_device(group[0], g))
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=g.group)
        _unflat(flat, group)


@torch.no_grad()
def all_reduce_max(tensors: Sequence[torch.Tensor], g: AxisGroup) -> None:
    """Elementwise max of each tensor over the group, in place."""
    for t in tensors:
        buf = _wire(t, g)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=g.group)
        if buf is not t:
            t.copy_(buf)


def local_shard(x: torch.Tensor, sp: Optional[AxisGroup]) -> torch.Tensor:
    """This rank's contiguous 1/size of x along the sequence (dim 1); x
    itself without a group."""
    if sp is None or sp.size == 1:
        return x
    return x.chunk(sp.size, dim=1)[sp.rank]
