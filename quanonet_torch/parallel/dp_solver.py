"""
Data-parallel training segments for the Solver (``--num_devices N``;
counterpart of quanonet_tpu/parallel/dp_solver.py).

Each rank holds 1/W of the padded training set with a mask of its real
rows, shuffles its own share every epoch (from a generator of (seed,
epoch, rank): local shuffling, each sample still visited once an epoch)
and steps on batch / W rows of it.  Every step differentiates the LOCAL
unreduced masked squared-error sum, then sums the gradients, the loss sum
and the real-row count over the group in one message
(``comm.all_reduce_grads``) and divides by max(count · per_sample, 1).
Both choices carry weight:

* without the sum every replica would apply only its own shard's piece and
  the "replicated" parameters would drift apart;
* differentiating an already summed loss would seed a cotangent on every
  rank and, through a summing backward, count the full-batch gradient W
  times: invisible under Adam's scale invariance, caught by SGD.

All ranks then hold the same summed ``.grad`` bits and step the same
optimizer, so the replicas stay bit-identical.

Noise-aware training composes: step t of rank r draws its trajectories
from a generator of (seed, t, rank), the counterpart of the JAX package's
``fold_in(key, device)``; the summed gradient is then an average over
independent trajectories across the global batch.
"""
import numpy as np
import torch

from quanonet_torch.ops.sampling import derive_seed, key_generator
from quanonet_torch.parallel import comm


def pad_to_devices(arrays, outputs, n_devices):
    """Pad the sample axis to a multiple of ``n_devices`` by repeating the
    first rows; returns (arrays, outputs, real_n).  The padding rows are
    masked out of the loss."""
    n = outputs.shape[0]
    pad = (-n) % n_devices
    if pad:
        arrays = tuple(np.concatenate([a, a[:pad]]) for a in arrays)
        outputs = np.concatenate([outputs, outputs[:pad]])
    return arrays, outputs, n


def local_permutation(seed, epoch, rank, n):
    """Rank ``rank``'s order of its ``n`` rows in epoch ``epoch``."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(epoch),
                                    int(rank)])
    gen = torch.Generator().manual_seed(int(state.generate_state(1)[0]))
    return torch.randperm(n, generator=gen)


def make_dp_run_segment(model, optimizer, group, global_n, batch_size,
                        per_sample, seed=0):
    """(run_segment, shard_data): ``run_segment`` has the signature of
    solver.make_run_segment's, each permutation one of this rank's local
    orders (:func:`local_permutation` over ``run_segment.local_n`` rows),
    and runs the steps of the module docstring over ``group``;
    ``shard_data(arrays, outputs)`` pads the NumPy training set to the
    group and returns this rank's share on its device."""
    from quanonet_torch.solver import _clone, padded_batches

    world, rank = group.world, group.rank
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} must divide evenly "
                         f"across {world} devices")
    local_bs = batch_size // world
    local_n = (global_n + (-global_n) % world) // world
    num_batches = max(1, int(np.ceil(local_n / local_bs)))
    sampled = bool(getattr(model, 'sampled', False))
    params = list(model.parameters())

    def train_epoch(perm, inputs, outputs, epoch):
        dev = outputs.device
        idx, masks = padded_batches(
            torch.as_tensor(perm, dtype=torch.long, device=dev), local_n,
            local_bs)
        losses, counts = [], []
        for b in range(num_batches):
            bi = idx[b]
            bm = masks[b] * run_segment.real_mask[bi]
            kw = ({'generator': key_generator(
                derive_seed(seed, epoch * num_batches + b), 1, rank,
                device=dev)} if sampled else {})
            pred = model(*(a[bi] for a in inputs), **kw)
            m = bm.reshape(bm.shape + (1,) * (pred.dim() - 1))
            sq_local = ((pred - outputs[bi]) ** 2 * m).sum()
            optimizer.zero_grad()
            sq_local.backward()
            summed = comm.all_reduce_grads(
                params, group, extras=torch.stack([sq_local.detach(),
                                                   bm.sum()]),
                denominator=lambda e: torch.clamp(e[1] * per_sample,
                                                  min=1.0))
            optimizer.step()
            losses.append(summed[0] / torch.clamp(summed[1] * per_sample,
                                                  min=1.0))
            counts.append(summed[1])
        losses, counts = torch.stack(losses), torch.stack(counts)
        return losses.mean(), (losses * counts * per_sample).sum()

    def run_segment(best_loss, best_params, perms, inputs, outputs,
                    first_epoch=0):
        hist = []
        for e, perm in enumerate(perms):
            avg, sse = train_epoch(perm, inputs, outputs, first_epoch + e)
            avg, sse = avg.item(), sse.item()   # one host read per epoch
            if avg < best_loss:
                best_loss, best_params = avg, _clone(model)
            hist.append((avg, sse))
        return best_loss, best_params, hist

    def shard_data(arrays, outputs):
        arrays, outputs, real_n = pad_to_devices(arrays, outputs, world)
        sl = slice(rank * local_n, (rank + 1) * local_n)
        dev = group.device
        mask = (np.arange(local_n * world) < real_n).astype(np.float32)
        run_segment.real_mask = torch.as_tensor(mask[sl], device=dev)
        return (tuple(torch.as_tensor(a[sl], device=dev) for a in arrays),
                torch.as_tensor(outputs[sl], device=dev))

    run_segment.local_n = local_n
    return run_segment, shard_data
