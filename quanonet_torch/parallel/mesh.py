"""
The (data, seed) grid of ranks and a one-batch data-parallel step
(counterpart of quanonet_tpu/parallel/mesh.py).

* ``data`` — batch data parallelism: each rank holds a contiguous share of
  the batch, the parameters are replicated, the gradients are summed;
* ``seed`` — multi-seed parallelism: the seeds of a packed model
  (models/packed.PackedModel) are split over the seed axis.

Rank r sits at (r // seed_parallel, r % seed_parallel), the JAX package's
device order of a (data, seed) mesh.
"""
from dataclasses import dataclass

import torch

from quanonet_torch.parallel import comm


@dataclass
class Mesh:
    world: comm.Group      # every rank
    data: comm.Group       # the ranks of this rank's seed column
    seed: comm.Group       # the ranks of this rank's data row

    @property
    def shape(self):
        return {'data': self.data.world, 'seed': self.seed.world}


def grid(group, inner):
    """(outer, inner) subgroups of ``group`` seen as an (world/inner, inner)
    grid: inner groups are contiguous blocks of ``inner`` ranks, outer
    groups stride ``inner``.  Every rank makes every subgroup, in order."""
    if group.world % inner:
        raise ValueError(f"n_devices={group.world} not divisible by "
                         f"{inner}")
    rows = group.world // inner
    outer_mine = inner_mine = None
    for j in range(inner):
        g = comm.Group.subgroup(group, [i * inner + j for i in range(rows)])
        outer_mine = outer_mine or g
    for i in range(rows):
        g = comm.Group.subgroup(group, range(i * inner, (i + 1) * inner))
        inner_mine = inner_mine or g
    return outer_mine, inner_mine


def make_mesh(group, seed_parallel=1, n_devices=None):
    """The (data, seed) grid over ``group``'s ranks.  ``n_devices`` (default
    the group's size) must be the group's size: each rank is one
    device."""
    n = int(n_devices or group.world)
    if n != group.world:
        raise ValueError(f"requested {n} devices, have {group.world}")
    if n % seed_parallel != 0:
        raise ValueError(f"n_devices={n} not divisible by "
                         f"seed_parallel={seed_parallel}")
    data, seed = grid(group, seed_parallel)
    return Mesh(group, data, seed)


def _share(a, group, axis=0):
    n = a.shape[axis] // group.world
    return a.narrow(axis, group.rank * n, n)


def shard_batch(mesh, *arrays):
    """This rank's contiguous share of each array's batch axis, on its
    device (the batch must divide evenly over the data axis)."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a, device=mesh.world.device)
        if t.shape[0] % mesh.data.world:
            raise ValueError(f"batch {t.shape[0]} not divisible by the "
                             f"data axis size {mesh.data.world}")
        out.append(_share(t, mesh.data))
    return tuple(out)


def replicate(mesh, tree):
    """Every tensor of ``tree`` (a dict) on this rank's device: each rank
    holds its own full copy."""
    return {k: torch.as_tensor(v, device=mesh.world.device)
            for k, v in tree.items()}


def shard_seed_axis(mesh, tree):
    """This rank's share of the leading seed axis of each tensor of
    ``tree`` (a dict), on its device."""
    return {k: _share(torch.as_tensor(v, device=mesh.world.device),
                      mesh.seed)
            for k, v in tree.items()}


def make_dp_train_step(model, optimizer, mesh, multi_seed=False):
    """One data-parallel step on this rank's share of a batch:
    ``step(inputs, targets) -> loss`` updates ``model`` (an ``nn.Module``,
    or with ``multi_seed`` a models/packed.PackedModel of this rank's seeds,
    whose inputs are broadcast to its seeds) through ``optimizer`` (its
    ``zero_grad``/``step`` pair) in place.

    The loss is the mean squared error over the global batch.  The step
    differentiates the local unreduced squared-error sum, sums the
    gradients and the sums over the data axis in one message, and divides
    by the global element count, so every replica applies the full-batch
    gradient.  Returns the loss, (n_seeds,) with ``multi_seed`` (gathered
    over the seed axis).

    A test and dry-run step: training uses parallel/dp_solver.py (the same
    reduction, plus masked ragged batches and best-epoch tracking)."""
    params = list(model.parameters())

    def step(inputs, targets):
        if multi_seed:
            s = params[0].shape[0]
            pred = model(*(a.unsqueeze(0).expand(s, *a.shape)
                           for a in inputs))
            sq = ((pred - targets) ** 2).reshape(s, -1).sum(1)
        else:
            pred = model(*inputs)
            sq = ((pred - targets) ** 2).sum().reshape(1)
        optimizer.zero_grad()
        sq.sum().backward()
        count = sq.new_full((1,), float(targets.numel()))   # no host copy
        summed = comm.all_reduce_grads(
            params, mesh.data, extras=torch.cat([sq.detach(), count]),
            denominator=lambda e: e[-1])
        optimizer.step()
        loss = summed[:-1] / summed[-1]
        if multi_seed:
            return comm.all_gather_rows(loss, mesh.seed)
        return loss[0]

    return step
