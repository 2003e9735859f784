"""Carry a vasp_tpu system's state into the port.

``from_vasp_tpu`` takes numpy arrays as vasp_tpu holds them — the array
half of ``vasp_tpu.fem.assembly.blocks_to_arrays`` (each cell block's dofs,
Jinv, detJ, vol and optional rowmask; each facet block's dofs and area2)
plus, optionally, the state U, U0 and the Dirichlet mask and values — and
returns the port's CellBlocks and FacetBlocks and float64 tensors on
`device`. Tests use it to feed both packages the same
system. Checkpoints are the other carrier: run/checkpoint.py reads a
vasp_tpu Checkpoint folder as it is.

This module imports neither jax nor vasp_tpu: the caller converts the JAX
arrays with numpy.asarray first.
"""
import numpy as np
import torch

from vasp_tpu_torch.fem.assembly import CellBlock, FacetBlock


def from_vasp_tpu(arrays, kernels, device="cpu", names=None):
    """arrays: dict with "blocks" (list of dicts of numpy arrays, in block
    order) and any of "U", "U0", "bc_mask", "bc_values". kernels: the
    port's element kernels (a RobinKernel for a facet block, whose arrays
    carry "area2"), one per block in the same order. Returns a dict with
    "blocks" (list of CellBlock and FacetBlock) and the state entries as
    tensors."""
    device = torch.device(device)
    blocks_in = arrays["blocks"]
    if len(kernels) != len(blocks_in):
        raise ValueError(f"{len(kernels)} kernels for {len(blocks_in)} blocks")

    def f64(a):
        return torch.tensor(np.asarray(a, np.float64), device=device)

    blocks = []
    for i, (data, kern) in enumerate(zip(blocks_in, kernels)):
        name = names[i] if names else f"{kern.kind}_{i}"
        dofs = torch.tensor(np.asarray(data["dofs"], np.int64), device=device)
        if "area2" in data:
            blocks.append(FacetBlock(name=name, kernel=kern, dofs=dofs,
                                     area2=f64(data["area2"])))
            continue
        rm = data.get("rowmask")
        blocks.append(CellBlock(
            name=name, kernel=kern, dofs=dofs,
            Jinv=f64(data["Jinv"]), detJ=f64(data["detJ"]),
            vol=f64(data["vol"]),
            rowmask=None if rm is None else f64(rm)))
    out = dict(blocks=blocks)
    for key in ("U", "U0", "bc_values"):
        if key in arrays:
            out[key] = f64(arrays[key])
    if "bc_mask" in arrays:
        out["bc_mask"] = torch.tensor(np.asarray(arrays["bc_mask"], bool),
                                      device=device)
    return out
