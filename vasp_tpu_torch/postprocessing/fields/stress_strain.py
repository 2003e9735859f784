"""Solid stress / strain postprocessing.

Counterpart of vasp_tpu.postprocessing.fields.stress_strain (vasp-compute-
stress; reference: src/vasp/postprocessing/postprocessing_fenics/
compute_stress_strain.py): from the solid displacement series compute per
timestep
- Green-Lagrange strain E,
- 2nd Piola-Kirchhoff S(d, solid_properties) per solid subdomain (same
  material library as the solver, reference L13, 199-211),
- true (Cauchy) stress sigma = (1/J) F S F^T (L211),
- max principal stress/strain via the closed-form Cardano eigenvalue
  (reference common.get_eig, L243-247),
- time-averaged max principal fields (L267-279).
Outputs: StressStrain/{TrueStress,GreenLagrangeStrain,MaxPrincipalStress,
MaxPrincipalStrain}.xdmf time series + MaxPrincipal{Stress,Strain}_avg.xdmf
(reference L171-279).

Fields are DG1 per solid cell (evaluated at the 4 cell vertices from exact
P2 gradients). The per-step arithmetic is K20b (kernels/postproc.py, one
instance per material, on the device the series lies on). E is the
cancellation-free (H + H^T + H^T H)/2, where vasp_tpu writes (F^T F - I)/2:
the two agree to rounding, ~1e-16 absolute.

File access and arithmetic are apart: ``compute_stress_strain`` reads the
HDF5 series and writes the outputs; ``SolidVertexTables.fields`` works on
in-memory series, so a caller without h5py drives the same code.

n_devices > 1 is vasp_tpu's timestep-sharded pass (parallel/steps.py): each
rank runs K20b on its share of each chunk's steps on its own card
(``SolidVertexTables.fields`` with a comm), and rank 0 gathers the fields
and alone writes.
"""
from pathlib import Path

import numpy as np
import torch

from vasp_tpu_torch.device import resolve_device
from vasp_tpu_torch.fem.assembly import cell_geometry
from vasp_tpu_torch.fem.functionspace import DVPSpace
from vasp_tpu_torch.fem.shape import p2_tet
from vasp_tpu_torch.kernels import postproc
from vasp_tpu_torch.mesh.io import read_vasp_mesh
from vasp_tpu_torch.parallel import bootstrap, steps
from vasp_tpu_torch.postprocessing.common import read_parameters_from_file
from vasp_tpu_torch.run.output import CheckpointSeriesWriter, VizWriter

# reference tet vertices in reference coords
_VERTS = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])


def _normalize_solid_props(params):
    props = params.get("solid_properties")
    if props:
        return props if isinstance(props, list) else [props]
    ids = np.atleast_1d(params.get("dx_s_id", 2)).tolist()
    out = []
    for k, i in enumerate(ids):
        def pick(key, default=None):
            v = params.get(key, default)
            if isinstance(v, (list, tuple)):
                return v[k]
            return v
        out.append({
            "dx_s_id": i,
            "material_model": pick("material_model", "StVenantKirchoff"),
            "rho_s": pick("rho_s", 1e3),
            "mu_s": pick("mu_s"), "lambda_s": pick("lambda_s"),
            "C01": pick("C01"), "C10": pick("C10"), "C11": pick("C11"),
        })
    return out


class SolidVertexTables:
    """The solid cells, segment by segment (one per subdomain material, in
    the order of the solid properties), with the P2 gather and the
    physical P2 gradients at each cell's 4 vertices, and the DG1 output
    mesh (solid cells on their own compact vertex list)."""

    def __init__(self, mesh, space, solid_props):
        all_sel, self.segments = [], []
        off = 0
        for sp_ in solid_props:
            sel = np.nonzero(mesh.cell_markers == sp_["dx_s_id"])[0]
            if len(sel) == 0:
                continue
            props = {k: v for k, v in sp_.items() if v is not None}
            all_sel.append(sel)
            self.segments.append((off, len(sel), props))
            off += len(sel)
        self.solid_cells = np.concatenate(all_sel)
        sub_cells = mesh.cells[self.solid_cells]
        verts = np.unique(sub_cells)
        remap = -np.ones(mesh.num_vertices, np.int64)
        remap[verts] = np.arange(len(verts))
        self.out_cells = remap[sub_cells]
        self.out_coords = mesh.coords[verts]
        self.dofs = space.cell_dofs_p2[self.solid_cells]  # (K,10)
        Jinv, _, _ = cell_geometry(mesh.coords, mesh.cells)
        _, dN2 = p2_tet(_VERTS)  # (4,10,3)
        self.G = np.einsum("qaj,kji->kqai", dN2,
                           Jinv[self.solid_cells])  # (K,4,10,3)

    def device_tables(self, device):
        """(dofs, G) as int64 / float64 tensors on `device`."""
        return (torch.as_tensor(self.dofs, dtype=torch.int64, device=device),
                torch.as_tensor(self.G, dtype=torch.float64, device=device))

    def fields(self, d_series, tables, comm=None):
        """(sig, eps (T,K,4,3,3), mps, mpe (T,K,4)) of the displacement
        series d_series (T, n_p2, 3) float64 tensor on its device (K20b on
        a card); tables from device_tables on the same device. With comm
        (parallel/comm.py Collectives) the steps are sharded over its
        ranks: each rank computes its share of d_series (whose other rows
        it does not read) and every rank gets the whole fields back."""
        if comm is None:
            return postproc.stress_strain(d_series, *tables, self.segments)
        T = d_series.shape[0]
        own = torch.as_tensor(steps.share(T, comm), device=d_series.device)
        part = postproc.stress_strain(d_series[own], *tables, self.segments)
        return tuple(steps.gather_steps(comm, a, T) for a in part)

    def to_nodes(self, vals):
        """Collapse DG1 (K,4) values to vertex values (average of the
        adjacent cells)."""
        nv = len(self.out_coords)
        out = np.zeros(nv)
        cnt = np.zeros(nv)
        np.add.at(out, self.out_cells.ravel(), vals.ravel())
        np.add.at(cnt, self.out_cells.ravel(), 1.0)
        return out / np.maximum(cnt, 1.0)


def default_chunk_steps(n_p2, K):
    """Timesteps per chunk of the stress pass: ~0.5 GB of float64, the
    displacement rows (3 n_p2 a step) in and the 20 values of each of the
    K x 4 (cell, vertex) rows out."""
    return max(1, int(6.25e7 / (3 * n_p2 + 80 * K)))


def compute_stress_strain(folder, mesh_path=None, stride=1, n_devices=None,
                          device="cuda", chunk_steps=None, dist_backend=None):
    """Main entry (vasp-tpu-torch-compute-stress). The displacement series
    is streamed in chunks of `chunk_steps` timesteps (default
    default_chunk_steps), each one K20b launch per material on a card, so
    memory is O(chunk x ndof) regardless of T.

    n_devices > 1 shards each chunk's steps over that many ranks
    (vasp_tpu's multi-device pass): the chunk a multiple of the rank count,
    at least one step a rank and at most the series rounded up to the rank
    count, padded by repeating its last step (the padding dropped after);
    inside a process group of n_devices ranks this process runs its rank,
    outside one the ranks are started here (parallel/steps.py rank_group)
    and None is returned. Each rank reads and computes its share; rank 0
    gathers the fields, writes and returns the averages, the others
    None."""
    import h5py

    backend = bootstrap.backend_for(device, dist_backend)
    comm, spawned = steps.rank_group(
        n_devices, compute_stress_strain,
        (folder, mesh_path, stride, n_devices, device, chunk_steps, backend),
        backend)
    if spawned:
        return None
    lead = comm is None or comm.rank == 0
    dev = bootstrap.use_rank_device(resolve_device(device))
    folder = Path(folder)
    params = read_parameters_from_file(folder) or {}
    mesh_path = Path(mesh_path) if mesh_path else folder / "Mesh" / "mesh.h5"
    mesh = read_vasp_mesh(mesh_path)
    space = DVPSpace(mesh)
    tables = SolidVertexTables(mesh, space, _normalize_solid_props(params))

    # displacement series on full-mesh P2 dofs
    sep = folder / "Visualization_separate_domain"
    d_file = None
    for cand in ("d.h5", "d_solid.h5"):
        if (sep / cand).exists():
            d_file = sep / cand
            break
    if d_file is None:
        from vasp_tpu_torch.postprocessing.fields.create_hdf5 import (
            create_hdf5,
        )

        if lead:
            create_hdf5(folder, mesh_path=mesh_path, extract_solid_only=True)
        d_file = sep / "d_solid.h5"
    if comm is not None:
        torch.distributed.barrier()
    n_p2 = space.n_p2
    with h5py.File(d_file, "r") as f:
        times = f["time"][:]
        ids = f["ids"][:]
        picked = list(range(0, len(times), stride))
        times = times[picked]

    out_dir = folder / "StressStrain"
    K = len(tables.solid_cells)
    if chunk_steps is None:
        chunk_steps = default_chunk_steps(n_p2, K)
    if comm is not None:
        n = comm.n
        chunk_steps = min(max(n, chunk_steps // n * n),
                          steps.padded_steps(len(times), n))
    if lead:
        out_dir.mkdir(parents=True, exist_ok=True)
        # checkpoint-layout series (the format the reference's h5py stack
        # reads: <name>/<name>_{i}/vector + dof metadata; see
        # CheckpointSeriesWriter). Tensors are FULL DG1: one row of 9
        # components per (cell, vertex), as the reference writes them
        # (compute_stress_strain.py:171-236).
        writers = {
            name: CheckpointSeriesWriter(
                out_dir, name, tables.out_coords, tables.out_cells, ncomp=1,
                cell_dofs=np.arange(K * 4).reshape(K, 4))
            for name in ("MaxPrincipalStress", "MaxPrincipalStrain")
        }
        tensor_writers = {
            name: CheckpointSeriesWriter(
                out_dir, name, tables.out_coords, tables.out_cells, ncomp=9,
                cell_dofs=np.arange(K * 36).reshape(K, 36))
            for name in ("TrueStress", "GreenLagrangeStrain")
        }
    nv = len(tables.out_coords)
    mps_sum = np.zeros(nv)
    mpe_sum = np.zeros(nv)
    dev_tables = tables.device_tables(dev)
    with h5py.File(d_file, "r") as f_d:
        for c0 in range(0, len(times), chunk_steps):
            chunk = range(c0, min(c0 + chunk_steps, len(times)))
            # the rank's steps of the chunk (all of them on one rank); the
            # other rows stay zero, fields reads only these
            own = (range(len(chunk)) if comm is None
                   else sorted(set(steps.share(len(chunk), comm))))
            d = np.zeros((len(chunk), n_p2, 3))
            for i in own:
                d[i, ids] = f_d[f"displacement/vector_{picked[chunk[i]]}"][:]
            fields = tables.fields(torch.as_tensor(d, device=dev),
                                   dev_tables, comm)
            if not lead:
                continue
            for k, sig, eps, mps, mpe in zip(
                    chunk, *(a.cpu().numpy() for a in fields)):
                t = float(times[k])
                writers["MaxPrincipalStress"].write(mps.reshape(-1), t)
                writers["MaxPrincipalStrain"].write(mpe.reshape(-1), t)
                tensor_writers["TrueStress"].write(sig.reshape(-1), t)
                tensor_writers["GreenLagrangeStrain"].write(eps.reshape(-1),
                                                            t)
                mps_sum += tables.to_nodes(mps)
                mpe_sum += tables.to_nodes(mpe)
    if not lead:
        return None

    avg = {"MaxPrincipalStress_avg": mps_sum / len(times),
           "MaxPrincipalStrain_avg": mpe_sum / len(times)}
    for name, arr in avg.items():
        w = VizWriter(out_dir, name, tables.out_coords, tables.out_cells,
                      vector=False)
        w.write(arr, 0.0)
    return dict(times=times, mps_avg=avg["MaxPrincipalStress_avg"],
                mpe_avg=avg["MaxPrincipalStrain_avg"])
