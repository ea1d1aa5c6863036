"""
Starting the ranks of a multi-GPU run (the counterpart of ``jax.devices()``
and the mesh's creation in the JAX package, which runs one controller over
all its devices; the port runs one process per rank).

:func:`run_ranks` starts ``world`` processes and returns what ``fn``
returned in each, in rank order; :class:`Ranks` keeps the processes for
several calls (the Solver's train and evaluate):

* start method ``spawn``, never ``fork`` (the caller may have JAX or other
  threads running);
* the rendezvous is a ``FileStore`` in a fresh temporary directory, never a
  fixed TCP port, so concurrent runs on one host never meet;
* ``init_process_group(timeout=...)``, so a collective that no peer joins
  raises instead of hanging; the call as a whole has the same deadline,
  after which every rank is killed;
* ``torch.set_num_threads(1)`` in each rank;
* a rank's exception is raised again in the caller, its traceback attached
  as the cause; the other ranks are killed at once.

Arguments and results cross process boundaries by pickling: ``fn`` must
be importable (a module-level function of a module that imports neither
JAX nor a test's conftest), and torch tensors in a result come back as
NumPy arrays.

Devices: on ``cuda`` rank r takes card r, and a ``world`` beyond the card
count raises (the JAX package's ``--num_devices N > available devices``);
``share_device=True`` puts every rank on card 0 (for checking the code
path on one card, not for speed).  Backend: NCCL when each rank has a card
of its own, gloo on the CPU and for ranks that share a card.

Under ``torchrun`` (``WORLD_SIZE`` and ``RANK`` set) the caller is already
one rank of a world: :func:`run_ranks` joins it and runs ``fn`` in this
process, and every rank gets the list of all ranks' results.
"""
import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from quanonet_torch.parallel.comm import Group

DEFAULT_TIMEOUT_S = 1800.0


class RemoteTraceback(Exception):
    """A rank's traceback, attached as the cause of its exception."""

    def __str__(self):
        return self.args[0]


def in_torchrun():
    return 'WORLD_SIZE' in os.environ and 'RANK' in os.environ


def check_devices(world, device, share_device=False):
    """Raise where ``world`` ranks cannot each have a card of their own."""
    if torch.device(device).type == 'cuda' and not share_device:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > n:
            raise ValueError(f"--num_devices {world} > the {n} CUDA "
                             f"device(s) available")


def rank_device(device, rank, share_device=False):
    dev = torch.device(device)
    if dev.type == 'cuda':
        return torch.device('cuda', 0 if share_device else rank)
    return dev


def default_backend(device, share_device=False):
    cuda = torch.device(device).type == 'cuda'
    return 'nccl' if cuda and not share_device else 'gloo'


def current_group(device, share_device=False, timeout_s=None):
    """This process's rank of a world as a Group on its device: the
    default process group where one is initialised, else the ``torchrun``
    world, joined here; None outside any world."""
    if dist.is_available() and dist.is_initialized():
        dev = torch.device(device)
        if dev.type == 'cuda' and dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        return Group.world_group(dev)
    if not in_torchrun():
        return None
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    dev = rank_device(device, int(os.environ.get('LOCAL_RANK', rank)),
                      share_device)
    return _init(default_backend(device, share_device), rank, world, dev,
                 float(timeout_s or DEFAULT_TIMEOUT_S))


def _host(obj):
    """Tensors in ``obj`` (dicts, lists, tuples) as NumPy arrays."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _init(backend, rank, world, device, timeout_s, store=None):
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw['store'] = store
    else:
        kw['init_method'] = 'env://'
    dist.init_process_group(**kw)
    return Group.world_group(device)


def _rank_main(rank, world, device, backend, share_device, store_path,
               timeout_s, inbox, results):
    """A rank's loop: ``(fn, args)`` from ``inbox`` until None, each
    ``fn(group, *args)``'s result (or its exception and traceback) onto
    ``results``; the same Group (and its ``state``) serves every call."""
    torch.set_num_threads(1)
    try:
        dev = rank_device(device, rank, share_device)
        group = _init(backend, rank, world, dev, timeout_s,
                      dist.FileStore(store_path, world))
    except Exception as e:       # reported to the caller, which re-raises
        results.put((rank, False, _portable(e, traceback.format_exc())))
        return
    try:
        for fn, args in iter(inbox.get, None):
            try:
                results.put((rank, True, _host(fn(group, *args))))
            except Exception as e:   # as above; the rank then stops
                results.put((rank, False,
                             _portable(e, traceback.format_exc())))
                return
    finally:
        dist.destroy_process_group()


def _portable(e, tb):
    """(exception, traceback text), the exception replaced by a
    RuntimeError where it cannot be pickled."""
    try:
        pickle.dumps(e)
    except Exception:
        e = RuntimeError(f"{type(e).__name__}: {e}")
    return e, tb


def _join_torchrun(fn, args, device, share_device, timeout_s):
    group = current_group(device, share_device, timeout_s)
    out = _host(fn(group, *args))
    gathered = [None] * group.world
    dist.all_gather_object(gathered, out)
    return gathered


class Ranks:
    """``world`` rank processes kept across calls (module docstring for
    the start, the devices and the backend): :meth:`call` runs one function
    on every rank and returns their results in rank order; :meth:`close`
    (or leaving a ``with`` block) stops them.  ``timeout_s`` (default
    :data:`DEFAULT_TIMEOUT_S`) bounds each collective and each call; on a
    timeout or a rank's exception every rank is killed and the error
    raised here."""

    def __init__(self, world, device='cpu', share_device=False,
                 timeout_s=None):
        self.world = int(world)
        if self.world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        check_devices(self.world, device, share_device)
        self.timeout_s = float(timeout_s or DEFAULT_TIMEOUT_S)
        backend = default_backend(device, share_device)
        ctx = multiprocessing.get_context('spawn')
        self._tmp = tempfile.mkdtemp(prefix='quanonet_ranks_')
        self._results = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(self.world)]
        self._procs = [ctx.Process(
            target=_rank_main,
            args=(r, self.world, str(device), backend, share_device,
                  os.path.join(self._tmp, 'store'), self.timeout_s,
                  self._inboxes[r], self._results),
            daemon=True) for r in range(self.world)]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.close()
            raise

    def call(self, fn, *args):
        """``fn(group, *args)`` on every rank; their results in rank
        order."""
        if self._procs is None:
            raise RuntimeError("the ranks are closed")
        for q in self._inboxes:
            q.put((fn, tuple(args)))
        out = {}
        deadline = time.monotonic() + self.timeout_s
        try:
            while len(out) < self.world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{self.world} ranks did not finish within "
                        f"{self.timeout_s:.0f} s (ranks done: {sorted(out)})")
                try:
                    rank, ok, payload = self._results.get(
                        timeout=min(left, 0.5))
                except queue.Empty:
                    self._check_alive(out)
                    continue
                if not ok:
                    exc, tb = payload
                    raise exc from RemoteTraceback(f"\n[rank {rank}]\n{tb}")
                out[rank] = payload
        except BaseException:
            self.close(kill=True)
            raise
        return [out[r] for r in range(self.world)]

    def _check_alive(self, out):
        dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                if r not in out and p.exitcode is not None]
        if dead:
            time.sleep(0.2)             # a result may still be in flight
            if self._results.empty():
                raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                   f"{dead[0][1]} and no result")

    def close(self, kill=False):
        if self._procs is None:
            return
        procs, self._procs = self._procs, None
        for p, q in zip(procs, self._inboxes):
            if p.pid is not None and not kill:
                q.put(None)
        for p in procs:
            if p.pid is None:           # never started
                continue
            p.join(timeout=0 if kill else 10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for q in self._inboxes + [self._results]:
            q.close()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(fn, world, device='cpu', args=(), share_device=False,
              timeout_s=None):
    """``fn(group, *args)`` on ``world`` ranks; returns the ranks' results
    in rank order.  ``timeout_s`` (default :data:`DEFAULT_TIMEOUT_S`) bounds
    each collective and the whole call."""
    if in_torchrun():
        return _join_torchrun(fn, args, device, share_device, timeout_s)
    with Ranks(world, device, share_device, timeout_s) as ranks:
        return ranks.call(fn, *args)
