"""The exchanges of the sharded paths, built on ``dist.all_reduce`` alone.

Counterpart of the collectives of vasp_tpu's shard_map programs:
make_spmd_ops (vasp_tpu/parallel/banded_shard.py:138-170: ext_gather,
halo_add, halo_max, the psum red) and the jax.lax.ppermute / psum / pmax
calls of its halo block row, phase loops and probe (:354-358, :430, :725,
:748, :876, :897, :1020-1028), and the psum / pmax of
vasp_tpu/parallel/shard.py.

A pair or neighbour exchange is a SUM all-reduce of a buffer in which only
the senders wrote their slots, every other entry zero. That is exact (x + 0
is x), and one code path serves three set-ups: NCCL with one card a rank,
gloo on CPU tensors (the tests), and gloo on CUDA tensors where several
ranks share one card (NCCL refuses two ranks on one card, and gloo offers
only broadcast and all-reduce for CUDA tensors). A pair exchange returns
zeros on every rank but the receiver, as ppermute does.
"""
import time

import torch
import torch.distributed as dist


class Collectives:
    """The exchanges of one rank of a process group. span and c (the rank's
    dofs and the halo width, the banded pattern's block size) are needed
    by the halo operations only. With a timings dict every all-reduce adds
    its bytes to timings["exchange_bytes"] and its wall seconds to
    timings["exchange"], the card synchronized before and after (so the
    seconds are the exchange's alone)."""

    def __init__(self, span=None, c=None, group=None, timings=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.n = dist.get_world_size(group)
        self.span, self.c = span, c
        self.timings = timings

    def _reduce(self, x, op):
        buf = x.detach().clone().reshape(-1)
        if self.timings is None:
            dist.all_reduce(buf, op=op, group=self.group)
            return buf.reshape(x.shape)
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        tic = time.perf_counter()
        dist.all_reduce(buf, op=op, group=self.group)
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        self.timings["exchange"] += time.perf_counter() - tic
        self.timings["exchange_bytes"] += buf.numel() * buf.element_size()
        return buf.reshape(x.shape)

    def red(self, x):
        """The sum over the ranks (psum)."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def red_max(self, x):
        """The elementwise maximum over the ranks (pmax)."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def ppermute(self, x, src, dst):
        """x of rank src on rank dst, zeros elsewhere (a single-pair
        ppermute; every rank calls it with the same src and dst)."""
        buf = x if self.rank == src else torch.zeros_like(x)
        out = self.red(buf)
        return out if self.rank == dst else torch.zeros_like(x)

    def _shift(self, x, offset):
        """Every rank's x sent to rank + offset at once (offset +1: the
        right permutation, -1: the left one): what rank - offset sent,
        zeros where no rank did."""
        buf = torch.zeros((self.n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        buf[self.rank] = x
        buf = self.red(buf)
        src = self.rank - offset
        return buf[src] if 0 <= src < self.n else torch.zeros_like(x)

    def shift_right(self, x):
        """x of rank p - 1 on rank p (zeros on rank 0)."""
        return self._shift(x, 1)

    def shift_left(self, x):
        """x of rank p + 1 on rank p (zeros on the last rank)."""
        return self._shift(x, -1)

    def ext_gather(self, x_loc):
        """(span,) -> (span + c + 1,): the rank's span, the right
        neighbour's first c entries (zeros on the last rank) and the dump
        slot (zero)."""
        halo = self.shift_left(x_loc[:self.c])
        return torch.cat([x_loc, halo, x_loc.new_zeros(1)])

    def halo_add(self, y_ext):
        """(span + c + 1,) -> (span,): the halo contributions shipped right
        and added to the neighbour's first c entries."""
        recv = self.shift_right(y_ext[self.span:self.span + self.c])
        own = y_ext[:self.span].clone()
        own[:self.c] += recv
        return own

    def halo_max(self, y_ext):
        """halo_add with max for the sum (the Ruiz maxima)."""
        recv = self.shift_right(y_ext[self.span:self.span + self.c])
        own = y_ext[:self.span].clone()
        own[:self.c] = torch.maximum(own[:self.c], recv)
        return own

    def gather_spans(self, x_loc):
        """The ranks' (span,) vectors in rank order, (n span,) on every
        rank (the replicated out_specs of vasp_tpu's programs)."""
        buf = torch.zeros((self.n, x_loc.shape[0]), dtype=x_loc.dtype,
                          device=x_loc.device)
        buf[self.rank] = x_loc
        return self.red(buf).reshape(-1)
