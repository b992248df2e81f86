"""Ray-axis data parallelism over a process group (counterpart of
`hosnerf_tpu/parallel/mesh.py`).

The JAX package shards the ray axis of every batch over a 1-D data mesh
and lets XLA insert the gradient psum. Here each rank is a process that
holds its own block of the rays and the whole of everything else:

* `shard_batch` splits the leading axis of the batch's arrays into
  contiguous blocks by the JAX rule (a leading axis that the world size
  divides is split, rank-0 arrays and the rest are replicated) and marks
  the result with its `RayShard`;
* the training steps read that mark (`shard_of`): a rank draws the whole
  batch's jitter and keeps its rows (`rand_rows` inside `RayShard.draws`),
  gathers per-ray outputs where a loss needs all of them
  (`RayShard.gather`, differentiable), all-reduces data-dependent
  denominators (`RayShard.sum`), and sums its gradients over the ranks in
  one flat bucket per dtype (`RayShard.reduce_grads`);
* `shard_eval_fn` wraps a render callable: each rank renders its block
  of a chunk, and every rank gets the whole chunk back.

With one rank every helper is the identity and every draw is the
one-process draw, bit for bit. Gloo reduces and gathers CUDA tensors
through the host (correct, slow); NCCL on the card.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hosnerf_tpu_torch.parallel import distributed

# the per-ray arrays of the three stages' batches and eval chunks (the
# keys a rank splits)
RAY_KEYS = ("rays_o", "rays_d", "viewdirs", "radii", "times", "target",
            "near", "far", "ray_valid", "ray_grid", "rays_o_bkg",
            "rays_d_bkg", "viewdirs_bkg")
SHARD_KEY = "ray_shard"


def _via_host(x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo"


def _all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """Sum x over the ranks in place (through the host for gloo + CUDA)."""
    if _via_host(x):
        h = x.cpu()
        dist.all_reduce(h)
        x.copy_(h)
    else:
        dist.all_reduce(x)
    return x


def _all_gather_rows(x: torch.Tensor, world: int) -> torch.Tensor:
    """The ranks' x [n, ...] joined in rank order -> [world * n, ...]."""
    x = x.contiguous()
    if x.is_cuda and not _via_host(x):
        out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return out
    h = x.cpu()
    parts = [torch.empty_like(h) for _ in range(world)]
    dist.all_gather(parts, h)
    return torch.cat(parts).to(x.device)


class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks; the backward sums the cotangent over the
    ranks and keeps this rank's rows (written out here: gloo may lack the
    reduce-scatter of torch.distributed.nn's all-gather)."""

    @staticmethod
    def forward(ctx, x, rank: int, world: int):
        ctx.rank, ctx.n = rank, x.shape[0]
        return _all_gather_rows(x, world)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_(g.contiguous().clone())
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None


class _AllReduce(torch.autograd.Function):
    """Differentiable sum over the ranks; the backward sums the
    cotangent."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone())


@dataclasses.dataclass(frozen=True)
class RayShard:
    """This rank's block of a batch's rays: rows [rank * n, (rank + 1) * n)
    of world * n. `digest` fingerprints the whole host batch it came from.

    The steps' rule for gradients: a loss term computed alike on every
    rank from gathered or summed values (a replicated term) enters the
    backward scaled by 1 / world, a term over this rank's rays (a local
    term: its numerator here, its denominator summed) enters as it is;
    `reduce_grads` then sums over the ranks, which gives the one-rank
    gradient."""
    rank: int = 0
    world: int = 1
    digest: str = ""

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of x, in order (differentiable)."""
        return x if self.world == 1 else _GatherRows.apply(x, self.rank,
                                                           self.world)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks (differentiable)."""
        return x if self.world == 1 else _AllReduce.apply(x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks, without gradient."""
        return x if self.world == 1 else _all_reduce_(x.detach().clone())

    def reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Sum the parameters' gradients over the ranks: one flat bucket
        per (device, dtype), one all-reduce each. Parameters without a
        gradient stay without one (alike on every rank)."""
        if self.world == 1:
            return
        buckets: Dict[Any, list] = {}
        for p in params:
            if p.grad is not None:
                buckets.setdefault((p.grad.device, p.grad.dtype),
                                   []).append(p.grad)
        for grads in buckets.values():
            flat = _all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

    @contextlib.contextmanager
    def draws(self):
        """Within: `rand_rows` draws the whole batch's rows and keeps this
        rank's."""
        token = _DRAWS.set((self.rank, self.world))
        try:
            yield
        finally:
            _DRAWS.reset(token)


ONE = RayShard()
_DRAWS = contextvars.ContextVar("ray_draws", default=(0, 1))


def rand_rows(shape: Sequence[int], generator: torch.Generator,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """U[0, 1) draws of `shape` (rays leading) on the generator's device.
    Inside `RayShard.draws` the draw covers every rank's rays and this
    rank's rows are returned, so that the generator advances alike on
    every rank and each ray gets the numbers it gets in one process."""
    rank, world = _DRAWS.get()
    if world == 1:
        return torch.rand(shape, generator=generator,
                          device=generator.device, dtype=dtype)
    n = shape[0]
    u = torch.rand((n * world,) + tuple(shape[1:]), generator=generator,
                   device=generator.device, dtype=dtype)
    return u[rank * n:(rank + 1) * n]


def shard_of(batch: Dict[str, Any]) -> RayShard:
    """The RayShard a batch was marked with by `shard_batch` (ONE for a
    whole batch)."""
    return batch.get(SHARD_KEY, ONE)


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, torch.Tensor))


def batch_digest(batch: Dict[str, Any]) -> str:
    """A fingerprint of a batch's arrays (keys, dtypes, shapes, bytes)."""
    h = hashlib.blake2b(digest_size=16)
    for k in sorted(batch):
        v = batch[k]
        if not _is_array(v):
            continue
        a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v))
        h.update(f"{k}:{a.dtype}:{a.shape};".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def shard_batch(batch: Dict[str, Any], rank: Optional[int] = None,
                world: Optional[int] = None,
                keys: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """This rank's share of a host (or device) batch, by the JAX rule: an
    array whose leading axis the world size divides is cut into `world`
    contiguous blocks and block `rank` kept; rank-0 arrays, other arrays
    and other values are kept whole. `keys` limits the split to those
    names (the training batches: RAY_KEYS, since a rank computes on its
    tensors and must hold every non-ray array whole). rank and world
    default to the process group's; one rank returns the batch as it is.
    A batch with a split array carries its RayShard under SHARD_KEY."""
    rank = distributed.rank() if rank is None else rank
    world = distributed.world_size() if world is None else world
    if world == 1:
        return batch
    out, split = {}, False
    for k, v in batch.items():
        if (_is_array(v) and (keys is None or k in keys) and v.ndim >= 1
                and v.shape[0] % world == 0):
            n = v.shape[0] // world
            out[k] = v[rank * n:(rank + 1) * n]
            split = True
        else:
            out[k] = v
    if split:
        out[SHARD_KEY] = RayShard(rank, world, batch_digest(batch))
    return out


def check_same_batch(batch: Dict[str, Any]) -> None:
    """Raise unless every rank's share came from the same global batch
    (the digests of the host batches agree)."""
    shard = shard_of(batch)
    if shard.world == 1:
        return
    digests = [None] * shard.world
    dist.all_gather_object(digests, shard.digest)
    if len(set(digests)) != 1:
        raise RuntimeError(f"the ranks step on different batches: {digests}")


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad axis 0 with repeats of the first element to a multiple of
    `multiple` (numpy arrays or tensors); returns (padded, original
    length)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        first = torch.index_select(x, axis, torch.zeros(
            1, dtype=torch.long, device=x.device))
        return torch.cat([x] + [first] * rem, dim=axis), n
    pad = np.repeat(np.take(x, [0], axis=axis), rem, axis=axis)
    return np.concatenate([x, pad], axis=axis), n


def shard_eval_fn(fn: Callable, rank: Optional[int] = None,
                  world: Optional[int] = None,
                  keys: Sequence[str] = RAY_KEYS) -> Callable:
    """Wrap an eval callable `fn(batch) -> tensor [rays, ...]` so that
    each call pads the chunk's rays (`keys`) to a multiple of the world
    size, runs this rank's block, all-gathers the blocks and trims the
    padding: every rank gets the whole chunk's output. One rank: `fn`
    unchanged."""
    rank = distributed.rank() if rank is None else rank
    world = distributed.world_size() if world is None else world
    if world == 1:
        return fn

    def wrapped(batch):
        present = [k for k in keys if k in batch]
        n = batch[present[0]].shape[0]
        local = dict(batch)
        for k in present:
            padded, _ = pad_to_multiple(batch[k], world)
            m = padded.shape[0] // world
            local[k] = padded[rank * m:(rank + 1) * m]
        with torch.no_grad():
            return _all_gather_rows(fn(local), world)[:n]

    return wrapped
