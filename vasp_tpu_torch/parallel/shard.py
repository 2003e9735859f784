"""make_sharded_step: one Newton solve with replicated state and sharded
element blocks, on torch.distributed.

Counterpart of vasp_tpu/parallel/shard.py (the reference's MPI domain
decomposition): every block of the system is padded to a multiple of the
ranks and cut into contiguous shares, one a rank; the state U is
replicated; each rank assembles the partial residual, Jacobian-vector
product, Ruiz maxima and node blocks of its own cells, and a sum (or max)
all-reduce combines them (parallel/comm.py). The body is the port's
make_step_fn (fem/timestepper.py: K1-K4, K7, K17, GMRES K5) with those
reductions as its reduce_fn and reduce_max_fn.
"""
import numpy as np
import torch

from vasp_tpu_torch.fem.assembly import Assembler, CellBlock
from vasp_tpu_torch.fem.timestepper import StepOptions, make_step_fn
from vasp_tpu_torch.parallel.banded_shard import rank_blocks
from vasp_tpu_torch.parallel.comm import Collectives


def _pad_to(arr, K_new, pad_value):
    K = arr.shape[0]
    if K == K_new:
        return np.asarray(arr)
    pad = np.full((K_new - K,) + arr.shape[1:], pad_value,
                  dtype=np.asarray(arr).dtype)
    return np.concatenate([np.asarray(arr), pad], axis=0)


def shard_system_blocks(system, n_shards, pad_dof):
    """Pad every block of system.assembler to a multiple of n_shards.

    Padded elements: dofs -> pad_dof (a dedicated zero slot), detJ/area2
    -> 0 (zero residual/Jacobian), Jinv -> I, vol -> 1. Returns (skeleton,
    arrays): skeleton holds the static parts (kernel objects), arrays the
    host numpy data."""
    skeleton = []
    arrays = []
    for b in system.assembler.blocks:
        K = b.dofs.shape[0]
        K_new = int(-(-K // n_shards) * n_shards)
        if isinstance(b, CellBlock):
            data = dict(
                dofs=_pad_to(b.dofs.cpu().numpy(), K_new, pad_dof),
                Jinv=_pad_to(b.Jinv.cpu().numpy(), K_new, 0.0),
                detJ=_pad_to(b.detJ.cpu().numpy(), K_new, 0.0),
                vol=_pad_to(b.vol.cpu().numpy(), K_new, 1.0),
            )
            if b.rowmask is not None:
                data["rowmask"] = _pad_to(b.rowmask.cpu().numpy(), K_new,
                                          1.0)
            # identity Jinv for padded cells (no NaNs in the kernels)
            if K_new > K:
                data["Jinv"][K:] = np.eye(3)
            skeleton.append(("cell", b.name, b.kernel))
        else:
            data = dict(
                dofs=_pad_to(b.dofs.cpu().numpy(), K_new, pad_dof),
                area2=_pad_to(b.area2.cpu().numpy(), K_new, 0.0),
            )
            skeleton.append(("facet", b.name, b.kernel))
        arrays.append(data)
    return skeleton, arrays


def make_sharded_step(system, bc_mask, options: StepOptions, group=None):
    """step(U0, bc_values, load) -> (U, stats) of this rank of `group` (the
    default group when None); every rank calls it with the same full
    (ndof,) vectors and gets the same U. Returns (step, its Collectives).

    Padding to ndof + 1 (the zero slot of padded elements) happens inside;
    the rank holds the contiguous share rank of each padded block."""
    comm = Collectives(group=group)
    n, rank = comm.n, comm.rank
    ndof = system.assembler.ndof
    dev = system.device
    skeleton, arrays = shard_system_blocks(system, n, pad_dof=ndof)
    shares = []
    for data in arrays:
        K_loc = data["dofs"].shape[0] // n
        shares.append({k: v.reshape((n, K_loc) + v.shape[1:])
                       for k, v in data.items()})
    asm = Assembler(ndof + 1, rank_blocks(skeleton, shares, rank, dev))
    mask_pad = torch.as_tensor(
        np.concatenate([np.asarray(bc_mask), [True]]), device=dev)
    inner = make_step_fn(asm, mask_pad, options,
                         layout=(system.space.n_p2, system.space.off_p),
                         reduce_fn=comm.red, reduce_max_fn=comm.red_max)

    def step(U0, bc_values, load):
        z = U0.new_zeros(1)
        U, stats = inner(torch.cat([U0, z]), torch.cat([bc_values.to(U0), z]),
                         torch.cat([load, z]))
        return U[:ndof], stats

    return step, comm
