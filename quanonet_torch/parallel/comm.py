"""
Collectives of the port's multi-GPU layer over ``torch.distributed`` (the
counterpart of ``jax.lax.psum`` / ``ppermute`` / ``axis_index`` inside the
JAX package's ``shard_map`` programs).

The JAX package runs one program over a device mesh; the port runs one
process per rank.  A :class:`Group` holds what a rank knows of its group:
its rank, the group's size, its compute device and the process group.  It
is passed explicitly to every collective, never kept in a module global.
A world-1 :class:`Group` (``pg`` None) needs no ``init_process_group``, and
each of its collectives is the identity, so a one-device run is the
single-process code path, bit for bit.

The collectives, each an autograd function with its backward written out:

* :func:`psum_replicated` — all-reduce (sum).  Every rank computes the
  same loss from the summed value and seeds its own backward with 1, so
  the backward is the identity: each rank's upstream gradient is then its
  own shard's piece.  (``torch.distributed.nn.functional.all_reduce``
  all-reduces in its backward too, which makes every gradient W times too
  large; Adam's scale invariance hides that.)
* :func:`sum_cotangents` — the identity on replicated inputs whose
  backward sums the cotangents over the group: the transpose of a
  replicated ``shard_map`` input.  With it at an engine's entry and
  :func:`psum_replicated` at its exit, every rank ends a backward holding
  the full gradient, parameters used after the engine (an output bias)
  included.  All the inputs' cotangents travel in one message.
* :func:`exchange` — swaps a tensor with rank ``r ^ (1 << bit)``; self
  inverse, so its backward is the same exchange (``ppermute`` over XOR
  pairs).  Re and im travel in one message when stacked.
  :func:`exchange_bits` swaps with several partners in a fixed order, and
  its backward keeps that order (independent branches of an autograd
  graph run in an order no rank agrees on).
* :func:`shift_next` — stage p sends to p+1 and receives from p-1; rank 0
  receives zeros.  Its backward sends to p-1 and receives from p+1.
* :func:`all_gather_rows` — the group's equal row blocks joined in rank
  order; its backward takes the rank's own rows.
* :func:`all_reduce_grads` — sums ``.grad`` of every parameter in place
  through one flat buffer (the pointers do not move, which
  ``ops/cuda_adam.FusedAdam`` relies on) and divides by a denominator.

Every rank must call the same collectives in the same order; a missed
hop deadlocks until the process group's timeout turns it into an error
(``parallel/launch.py``).

Backends: NCCL when each rank has a card of its own; gloo on the CPU and
for ranks that share a card.  Gloo's point-to-point messages take host
tensors, so a CUDA tensor's send and receive are staged through pinned
host buffers, explicitly, here; the compute stays on the card.  Gloo's
all-reduce takes CUDA tensors in PyTorch's CUDA builds and is called on
them directly; its all-gather is staged through the host.

``Group.counts`` counts the messages by kind: 'all_reduce',
'all_gather', and 'exchange' / 'shift' for the forward's hops,
'exchange_bwd' / 'shift_bwd' for the backward's.  A hop is counted at
world 1 too, where an exchange is a no-op (the ``virtual_global`` timing
mode of parallel/amplitude.py) and a shift gives zeros.
"""
from collections import Counter

import torch
import torch.distributed as dist


class Group:
    """A rank's view of its group: ``rank`` in 0..world-1, ``device`` the
    rank's compute device, ``pg`` the process group (None: a world-1
    group without ``init_process_group``), ``ranks`` the members' global
    ranks (default 0..world-1), ``counts`` the messages by kind, ``state``
    the rank's objects kept between calls (parallel/launch.Ranks)."""

    def __init__(self, rank=0, world=1, device='cpu', pg=None, ranks=None):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.pg = pg
        if pg is None and self.world != 1:
            raise ValueError("a group of more than one rank needs a "
                             "process group")
        self.ranks = list(ranks) if ranks is not None else list(
            range(self.world))
        self.backend = dist.get_backend(pg) if pg is not None else None
        self.host_p2p = self.backend == 'gloo' and self.device.type == 'cuda'
        self.counts = Counter()
        self.state = {}

    @classmethod
    def world_group(cls, device):
        """The default process group of this process, which must be
        initialised."""
        return cls(dist.get_rank(), dist.get_world_size(), device,
                   dist.group.WORLD)

    @classmethod
    def subgroup(cls, parent, ranks):
        """The group of ``parent``'s members ``ranks`` (group ranks of
        ``parent``), made by ``dist.new_group``: every rank of the world
        must make every subgroup, in the same order."""
        ranks = list(ranks)
        glob = [parent.ranks[r] for r in ranks]
        if len(ranks) == 1 or parent.pg is None:
            pg = None
            if len(ranks) > 1:
                raise ValueError("a world-1 group has no subgroups")
        else:
            pg = dist.new_group(glob)
        if parent.rank not in ranks:
            return None
        return cls(ranks.index(parent.rank), len(ranks), parent.device, pg,
                   glob)

    def peer(self, r):
        """Global rank of group rank ``r``."""
        return self.ranks[r]

    def __repr__(self):
        return (f"Group(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend})")


def _pinned(t):
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _all_reduce_(t, group):
    """Sum ``t`` over the group in place."""
    if group.pg is None:
        return t
    group.counts['all_reduce'] += 1
    dist.all_reduce(t, group=group.pg)
    return t


def _sendrecv(send, dst, shape, dtype, src, group):
    """Send ``send`` to group rank ``dst`` and receive a (shape, dtype)
    tensor from ``src`` (either may be None), both posted before either is
    waited on.  Returns the received tensor on the group's device, or
    None."""
    ops, out = [], None
    if group.host_p2p:   # gloo moves host tensors only: pinned staging
        if send is not None:
            host = _pinned(send)
            host.copy_(send)
            send = host
        if src is not None:
            out = torch.empty(shape, dtype=dtype, pin_memory=True)
    elif src is not None:
        out = torch.empty(shape, dtype=dtype, device=group.device)
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), group.peer(dst),
                              group.pg))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, group.peer(src), group.pg))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if out is not None and out.device != group.device:
        out = out.to(group.device)
    return out


def _swap(t, bit, group, kind='exchange'):
    group.counts[kind] += 1
    if group.world == 1:     # virtual_global timing mode: a no-op
        return t
    partner = group.rank ^ (1 << bit)
    if partner >= group.world:
        raise ValueError(f"exchange bit {bit} has no partner of rank "
                         f"{group.rank} in a group of {group.world}")
    return _sendrecv(t, partner, t.shape, t.dtype, partner, group)


def _shift(t, group, forward):
    """forward: receive from rank-1 (zeros at rank 0), send to rank+1;
    backward: receive from rank+1 (zeros at the last rank), send to
    rank-1."""
    group.counts['shift' if forward else 'shift_bwd'] += 1
    last = group.world - 1
    if forward:
        dst = group.rank + 1 if group.rank < last else None
        src = group.rank - 1 if group.rank > 0 else None
    else:
        dst = group.rank - 1 if group.rank > 0 else None
        src = group.rank + 1 if group.rank < last else None
    if group.world == 1:
        return torch.zeros_like(t)
    out = _sendrecv(t if dst is not None else None, dst, t.shape, t.dtype,
                    src, group)
    return out if out is not None else torch.zeros_like(t)


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumCotangents(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, *ts):
        ctx.groups = groups
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in ts]
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=d, device=v) if g is None else g
              for g, (s, d, v) in zip(gs, ctx.shapes)]
        flat = torch.cat([g.reshape(-1) for g in gs])
        for group in ctx.groups:
            _all_reduce_(flat, group)
        out, off = [], 0
        for g in gs:
            out.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return (None, *out)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, bits, group):
        ctx.bits, ctx.group = bits, group
        return torch.stack([_swap(t, b, group) for b in bits])

    @staticmethod
    def backward(ctx, g):
        return (sum(_swap(g[i].contiguous(), b, ctx.group, 'exchange_bwd')
                    for i, b in enumerate(ctx.bits)), None, None)


class _ShiftNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(t, group, forward=True)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, forward=False), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.rank, ctx.rows = group.rank, t.shape[0]
        if group.pg is None:
            return t.clone()
        group.counts['all_gather'] += 1
        src = t.contiguous()
        if group.host_p2p:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(group.world)]
        dist.all_gather(parts, src, group=group.pg)
        return torch.cat(parts).to(group.device)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def psum_replicated(t, group):
    """Σ over the group of ``t``, on every rank; identity backward."""
    return _PsumReplicated.apply(t, group)


def sum_cotangents(groups, *ts):
    """``ts`` unchanged; in the backward their cotangents are summed over
    each group of ``groups`` in turn (one flat message a group)."""
    return _SumCotangents.apply(tuple(groups), *ts)


def exchange(t, bit, group):
    """``t`` of rank ``rank ^ (1 << bit)``; the backward is the same
    exchange."""
    return _Exchange.apply(t, (int(bit),), group)[0]


def exchange_bits(t, bits, group):
    """(len(bits), *t.shape): the partners' ``t`` for each bit, in order;
    the backward exchanges in the same order."""
    return _Exchange.apply(t, tuple(int(b) for b in bits), group)


def shift_next(t, group):
    """Rank p's result is rank p-1's ``t``; rank 0's is zeros."""
    return _ShiftNext.apply(t, group)


def all_gather_rows(t, group):
    """(world·rows, ...) from every rank's (rows, ...) in rank order."""
    return _AllGatherRows.apply(t, group)


def all_reduce_grads(params, group, denominator=1.0, extras=None):
    """Sum each parameter's ``.grad`` over the group in place, with
    ``extras`` (a 1-d tensor, or None) in the same flat message, then
    divide every ``.grad`` by ``denominator``: a number, or a function of
    the summed extras that returns one (a tensor on the device keeps the
    step free of host reads).  Parameters whose ``.grad`` is None are left
    alone (the same on every rank: one model, one graph).  Returns the
    summed extras."""
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1) for g in grads]
    if extras is not None:
        parts.append(extras.reshape(-1).to(grads[0].dtype if grads
                                            else extras.dtype))
    flat = _all_reduce_(torch.cat(parts), group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    summed = flat[off:] if extras is not None else None
    denom = denominator(summed) if callable(denominator) else denominator
    for g in grads:
        g.div_(denom)
    return summed
