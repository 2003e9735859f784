"""Hemodynamic indices: WSS, TAWSS, TWSSG, OSI, RRT, ECAP.

Counterpart of vasp_tpu.postprocessing.fields.hemodynamics (vasp-compute-
hemo; reference: src/vasp/postprocessing/postprocessing_fenics/
compute_hemodynamics.py):

- wall shear stress tau = tangential part of the viscous traction
  t = sigma n, sigma = 2 mu_f sym(grad u) (reference Stress class L120-158),
- per-timestep tau fields accumulated into
  TAWSS  = mean_t |tau|                (L326-328)
  TWSSG  = mean_t |(tau - tau_prev)/dt|
  WSS_mean = mean_t tau
  RRT = 1/|WSS_mean|, OSI = 0.5 (1 - |WSS_mean|/TAWSS), ECAP = OSI/TAWSS
  (L344-346), with the OSI in [0, 0.5] runtime assert (L366-372),
- outputs Hemodynamic_indices/{RRT,OSI,ECAP,WSS,TAWSS,TWSSG}.xdmf (L251-256).

The velocity series is evaluated at wall-facet quadrature points with exact
P2 gradients of the unrefined mesh (the save_deg=2 output numbering is the
P2 dof numbering). Per timestep the WSS load is K20a (kernels/postproc.py,
on the device the series lies on); the consistent boundary-mass solve
(splu) and the index reductions are host numpy, as in vasp_tpu.

File access and arithmetic are apart: ``compute_hemodynamics`` reads the
HDF5 series and writes the outputs; ``FluidBoundaryTables.wss_series`` and
``WSSIndices`` work on in-memory series (``hemodynamic_indices`` runs both),
so a caller without h5py drives the same code.

n_devices > 1 is vasp_tpu's timestep-sharded pass (parallel/steps.py): each
rank runs K20a on its share of each chunk's steps on its own card, and rank
0 gathers the loads, runs the host solves and the reductions and alone
writes.
"""
from pathlib import Path

import numpy as np
import torch

from vasp_tpu_torch.device import resolve_device
from vasp_tpu_torch.fem.assembly import cell_geometry
from vasp_tpu_torch.fem.functionspace import DVPSpace
from vasp_tpu_torch.fem.quadrature import tri_quadrature
from vasp_tpu_torch.fem.shape import p1_tri, p2_tet
from vasp_tpu_torch.kernels import postproc
from vasp_tpu_torch.mesh.io import read_vasp_mesh
from vasp_tpu_torch.parallel import bootstrap, steps
from vasp_tpu_torch.postprocessing.common import read_parameters_from_file
from vasp_tpu_torch.run.output import VizWriter


class FluidBoundaryTables:
    """Per-facet tabulation for evaluating P2 gradients of the full mesh on
    the fluid-domain boundary (exterior facets + FSI interface)."""

    def __init__(self, mesh, dx_f_id=1, quad_degree=2):
        fluid_ids = np.atleast_1d(dx_f_id)
        is_fluid = np.isin(mesh.cell_markers, fluid_ids)
        c0, l0, c1, l1 = mesh.marked_facet_cells
        # pick the attached fluid cell per marked facet (if any)
        cells = np.full(len(c0), -1, np.int64)
        f0 = is_fluid[c0]
        cells[f0] = c0[f0]
        has1 = c1 >= 0
        f1 = np.zeros_like(f0)
        f1[has1] = is_fluid[c1[has1]]
        only1 = f1 & ~f0
        cells[only1] = c1[only1]
        sel = cells >= 0
        self.sel = sel
        self.markers = mesh.facet_markers[sel]
        fv = np.sort(mesh.facets[sel].astype(np.int64), axis=1)
        cells = cells[sel]
        self.cells = cells

        x = mesh.coords[fv]
        e1 = x[:, 1] - x[:, 0]
        e2 = x[:, 2] - x[:, 0]
        cr = np.cross(e1, e2)
        self.area2 = np.linalg.norm(cr, axis=1)
        n = cr / self.area2[:, None]
        cc = mesh.coords[mesh.cells[cells]].mean(axis=1)
        flip = np.einsum("ki,ki->k", n, x.mean(axis=1) - cc) < 0
        n[flip] *= -1.0
        self.normals = n  # outward from the fluid

        # facet quadrature points in each cell's reference coords
        qp2d, wq = tri_quadrature(quad_degree)
        self.wq = wq
        xq = (
            x[:, None, 0, :]
            + qp2d[None, :, 0, None] * e1[:, None, :]
            + qp2d[None, :, 1, None] * e2[:, None, :]
        )  # (K,nq,3)
        Jinv, _, _ = cell_geometry(mesh.coords, mesh.cells)
        Jc = Jinv[cells]  # (K,3,3)
        x0 = mesh.coords[mesh.cells[cells][:, 0]]
        xi = np.einsum("kji,kqi->kqj", Jc, xq - x0[:, None, :])  # (K,nq,3)
        K, nq = xi.shape[:2]
        _, dN2 = p2_tet(xi.reshape(-1, 3))
        dN2 = dN2.reshape(K, nq, 10, 3)
        # physical gradients: G[k,q,a,i] = dN2[k,q,a,j] Jc[k,j,i]
        self.G2 = np.einsum("kqaj,kji->kqai", dN2, Jc)
        # P1 facet basis at quad points (for nodal projection)
        self.N1f, _ = p1_tri(qp2d)  # (nq,3)
        self.facet_verts = fv

        # boundary node set + compact numbering
        self.bnodes = np.unique(fv)
        remap = -np.ones(mesh.num_vertices, np.int64)
        remap[self.bnodes] = np.arange(len(self.bnodes))
        self.facet_bnodes = remap[fv]  # (K,3) compact
        self.boundary_coords = mesh.coords[self.bnodes]
        self.boundary_tris = self.facet_bnodes

        # lumped projection mass: m_a = sum_k sum_q wq area2 N1f
        m = np.zeros(len(self.bnodes))
        contrib = np.einsum("q,qa,k->ka", wq, self.N1f, self.area2)
        np.add.at(m, self.facet_bnodes.reshape(-1), contrib.reshape(-1))
        self.lumped_mass = m

        # CONSISTENT boundary mass matrix (the reference's SurfaceProjector
        # assembles <u,v> ds and LU-solves it, compute_hemodynamics.py:92-119)
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        Me = np.einsum("q,qa,qb,k->kab", wq, self.N1f, self.N1f, self.area2)
        rows = np.repeat(self.facet_bnodes, 3, axis=1).reshape(-1)
        cols = np.tile(self.facet_bnodes, (1, 3)).reshape(-1)
        Mb = sp.coo_matrix((Me.reshape(-1), (rows, cols)),
                           shape=(len(self.bnodes),) * 2).tocsc()
        self._mass_lu = spla.splu(Mb)

    def device_tables(self, cell_dofs_p2, device):
        """K20a's inputs as float64 / int64 tensors on `device`: (dofs,
        G2, normals, wq, N1f, area2, facet_bnodes)."""
        f64, i64 = torch.float64, torch.int64
        arrays = ((cell_dofs_p2[self.cells], i64), (self.G2, f64),
                  (self.normals, f64), (self.wq, f64), (self.N1f, f64),
                  (self.area2, f64), (self.facet_bnodes, i64))
        return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                     device=device) for a, dt in arrays)

    def wss_series(self, u_series, cell_dofs_p2, mu_f, device="cuda",
                   comm=None):
        """u_series (T, n_p2, 3) full-mesh P2 velocity -> nodal WSS vectors
        (T, n_bnodes, 3) numpy on the fluid boundary: the loads on
        `device`, the consistent boundary-mass solve on the host (a small
        SPD factor reused across timesteps, like the reference's cached
        LU). With comm (parallel/comm.py Collectives) the steps are sharded
        over its ranks (u_series the whole series on every rank): each
        computes the loads of its share, rank 0 gathers them and solves,
        the other ranks return None."""
        dev = resolve_device(device) if isinstance(device, str) else device
        u = torch.as_tensor(u_series, dtype=torch.float64, device=dev)
        T = u.shape[0]
        if comm is not None:
            u = u[torch.as_tensor(steps.share(T, comm), device=dev)]
        loads = postproc.wss_load(u, *self.device_tables(cell_dofs_p2, dev),
                                  len(self.bnodes), mu_f)
        if comm is not None:
            loads = steps.gather_steps(comm, loads, T)
            if comm.rank != 0:
                return None
        return np.stack([self._mass_lu.solve(b)
                         for b in loads.cpu().numpy()])


class WSSIndices:
    """The streamed index reductions over a WSS series (host numpy): every
    index is a running sum with one-step lookback, so a series is fed in
    chunks of any length (vasp_tpu's compute_hemodynamics loop)."""

    def __init__(self, n_bnodes):
        self.T = 0
        self.sum_taumag = np.zeros(n_bnodes)
        self.sum_tau = np.zeros((n_bnodes, 3))
        self.sum_dtaumag = np.zeros(n_bnodes)
        self.prev_tau = None

    def update(self, tau):
        """Add a chunk tau (T_c, n_bnodes, 3) that follows the last one."""
        self.T += len(tau)
        self.sum_taumag += np.linalg.norm(tau, axis=2).sum(axis=0)
        self.sum_tau += tau.sum(axis=0)
        if self.prev_tau is not None:
            tau_ext = np.concatenate([self.prev_tau[None], tau], axis=0)
        else:
            tau_ext = tau
        if tau_ext.shape[0] > 1:
            self.sum_dtaumag += np.linalg.norm(
                np.diff(tau_ext, axis=0), axis=2).sum(axis=0)
        self.prev_tau = tau[-1]

    def indices(self, times):
        """dict TAWSS, TWSSG, OSI, RRT, ECAP, with the reference's OSI range
        assert (compute_hemodynamics.py:366-372)."""
        T = self.T
        dt = np.diff(times).mean() if len(times) > 1 else 1.0
        TAWSS = self.sum_taumag / T
        WSS_mean = self.sum_tau / T
        wss_mean_mag = np.linalg.norm(WSS_mean, axis=1)
        if T > 1:
            TWSSG = self.sum_dtaumag / (T - 1) / dt
        else:
            TWSSG = np.zeros_like(TAWSS)
        eps = 1e-300
        RRT = 1.0 / np.maximum(wss_mean_mag, eps)
        OSI = 0.5 * (1.0 - wss_mean_mag / np.maximum(TAWSS, eps))
        ECAP = OSI / np.maximum(TAWSS, eps)
        tol = 1e-12
        assert OSI.min() >= -tol and OSI.max() <= 0.5 + tol, (
            "OSI out of [0, 0.5]"
        )
        return dict(TAWSS=TAWSS, TWSSG=TWSSG, OSI=OSI, RRT=RRT, ECAP=ECAP)


def hemodynamic_indices(tables, u_series, cell_dofs_p2, mu_f, times,
                        device="cuda", comm=None):
    """The in-memory pass: (indices dict, tau (T, n_bnodes, 3)) of a
    velocity series (T, n_p2, 3) with its times; with comm the
    timestep-sharded one (wss_series), (None, None) on ranks but 0."""
    tau = tables.wss_series(u_series, cell_dofs_p2, mu_f, device=device,
                            comm=comm)
    if tau is None:
        return None, None
    acc = WSSIndices(len(tables.bnodes))
    acc.update(tau)
    return acc.indices(np.asarray(times)), tau


def compute_hemodynamics(folder, mesh_path=None, quad_degree=2,
                         chunk_steps=None, n_devices=None, device="cuda",
                         dist_backend=None):
    """Main entry (vasp-tpu-torch-compute-hemo).

    The time series is streamed in chunks of `chunk_steps` timesteps
    (default ~0.5 GB of velocity data), so memory is O(chunk x ndof)
    regardless of T. The WSS loads run on `device` (K20a on a card).

    n_devices > 1 shards each chunk's timesteps over that many ranks
    (vasp_tpu's multi-device pass; a chunk holds at least one step a rank):
    inside a process group of n_devices ranks this process runs its rank,
    outside one the ranks are started here (parallel/steps.py rank_group,
    on bootstrap.backend_for's backend) and None is returned. Each rank reads
    its share of each chunk and runs K20a on cuda:<local rank % cards> (or
    the CPU); rank 0 gathers the loads, solves, reduces, writes and returns
    the indices, the other ranks None."""
    import h5py

    backend = bootstrap.backend_for(device, dist_backend)
    comm, spawned = steps.rank_group(
        n_devices, compute_hemodynamics,
        (folder, mesh_path, quad_degree, chunk_steps, n_devices, device,
         backend), backend)
    if spawned:
        return None
    lead = comm is None or comm.rank == 0
    dev = bootstrap.use_rank_device(resolve_device(device))
    folder = Path(folder)
    params = read_parameters_from_file(folder) or {}
    mu_f = params.get("mu_f", 1.0)
    if isinstance(mu_f, (list, tuple)):
        mu_f = mu_f[0]
    dx_f_id = params.get("dx_f_id", 1)
    mesh_path = Path(mesh_path) if mesh_path else folder / "Mesh" / "mesh.h5"
    mesh = read_vasp_mesh(mesh_path)

    sep = folder / "Visualization_separate_domain"
    u_path = sep / "u.h5"
    if lead and not u_path.exists():
        from vasp_tpu_torch.postprocessing.fields.create_hdf5 import (
            create_hdf5,
        )

        create_hdf5(folder, mesh_path=mesh_path)
    if comm is not None:
        torch.distributed.barrier()

    space = DVPSpace(mesh)
    tables = FluidBoundaryTables(mesh, dx_f_id, quad_degree)
    n_p2 = mesh.num_vertices + mesh.num_edges

    out_dir = folder / "Hemodynamic_indices"
    coords, tris = tables.boundary_coords, tables.boundary_tris
    if lead:
        out_dir.mkdir(parents=True, exist_ok=True)
        w_wss = VizWriter(out_dir, "WSS", coords, tris, vector=True,
                          cell_type="Triangle")

    if chunk_steps is None:
        # ~0.5 GB of f64 velocity rows per chunk
        chunk_steps = max(1, int(2.2e7 / max(n_p2, 1)))
    if comm is not None:
        chunk_steps = max(chunk_steps, comm.n)
    acc = WSSIndices(len(tables.bnodes))
    with h5py.File(u_path, "r") as f:
        T = len(f["time"])
        times = f["time"][:]
        ids = f["ids"][:]
        for k0 in range(0, T, chunk_steps):
            k1 = min(k0 + chunk_steps, T)
            # the rank's steps of the chunk (all of them on one rank); the
            # other rows stay zero, wss_series reads only these
            own = (range(k1 - k0) if comm is None
                   else sorted(set(steps.share(k1 - k0, comm))))
            u_series = np.zeros((k1 - k0, n_p2, 3))
            for i in own:
                u_series[i, ids] = f[f"velocity/vector_{k0 + i}"][:]
            tau = tables.wss_series(u_series, space.cell_dofs_p2, mu_f,
                                    device=dev, comm=comm)
            if not lead:
                continue
            for i, k in enumerate(range(k0, k1)):
                w_wss.write(tau[i], float(times[k]))
            acc.update(tau)
    if not lead:
        return None
    res = acc.indices(times)

    for name in ("TAWSS", "TWSSG", "OSI", "RRT", "ECAP"):
        w = VizWriter(out_dir, name, coords, tris, vector=False,
                      cell_type="Triangle")
        w.write(res[name], 0.0)
    # expose facet markers for region selection by downstream consumers
    with h5py.File(out_dir / "TAWSS.h5", "a") as f:
        f.create_dataset("boundary_markers", data=tables.markers)
        f.create_dataset("boundary_nodes", data=tables.bnodes)
    return dict(res, tables=tables, times=times)
