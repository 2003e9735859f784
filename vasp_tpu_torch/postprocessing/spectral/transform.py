"""Time-series matrix construction: the spectral pipeline's pivot op.

Counterpart of vasp_tpu.postprocessing.spectral.transform (host code,
copied; h5py is imported inside the functions that read HDF5).
Parity target: create_transformed_matrix
(reference: src/vasp/postprocessing/postprocessing_h5py/postprocessing_h5py_common.py:154-409):
(timesteps x h5 files) -> per-component node x time matrices saved as
compressed npz (components mag/x/y/z for d and v, scalar for p, 6 tensor
components for stress/strain).

Node-region selection mirrors the reference's sampling-region logic
(reference: spectrograms.py:221-266): sphere or box intersected with
{fluid | solid | interface | all} node sets."""
from pathlib import Path

import numpy as np

from vasp_tpu_torch.mesh.io import read_vasp_mesh
from vasp_tpu_torch.postprocessing.common import (
    get_domain_ids,
    get_domain_ids_refined,
    get_interface_ids,
    output_file_lists,
    read_parameters_from_file,
)

_COMPONENTS = {"v": ["mag", "x", "y", "z"], "d": ["mag", "x", "y", "z"],
               "p": ["mag"], "wss": ["mag", "x", "y", "z"], "mps": ["mag"],
               "stress": ["11", "12", "22", "23", "33", "31"],
               "strain": ["11", "12", "22", "23", "33", "31"]}
_FIELD_FILE = {"v": "velocity", "d": "displacement", "p": "pressure"}
# checkpoint-layout series written by the postprocessing stages
# (reference quantity->file map: postprocessing_h5py_common.py:199-210)
_CKPT_FILE = {"wss": ("Hemodynamic_indices", "WSS"),
              "mps": ("StressStrain", "MaxPrincipalStrain"),
              "stress": ("StressStrain", "TrueStress"),
              "strain": ("StressStrain", "GreenLagrangeStrain")}
# row-major 3x3 flat index of the 6 distinct symmetric components
# (reference: postprocessing_h5py_common.py:380-399)
_TENSOR_SLOTS = {"11": 0, "12": 1, "22": 4, "23": 5, "33": 8, "31": 6}


def _write_npz_streaming(path, entries):
    """savez_compressed equivalent that streams each array into the zip in
    bounded-memory chunks (np.lib.format.write_array buffers ~64 MB at a
    time when the sink is not a raw file), so a node x time matrix larger
    than host RAM can still be written. entries: [(key, array-like), ...]."""
    import zipfile

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         allowZip64=True) as zf:
        for key, arr in entries:
            with zf.open(key + ".npy", "w", force_zip64=True) as fp:
                np.lib.format.write_array(fp, np.asanyarray(arr),
                                          allow_pickle=False)


def create_transformed_matrix(folder, quantity="v", start_t=None, end_t=None,
                              stride=1, out_folder=None, chunk_steps=None):
    """Read the output series of `quantity` and save node x time matrices
    per component as compressed npz — THE pivot op of the spectral stack
    (reference: postprocessing_h5py_common.py:154-409).

    The series is STREAMED in chunks of `chunk_steps` timesteps (default
    auto-sized to ~0.5 GB of rows) into per-component on-disk memmaps
    (`<q>_<comp>.npy`), then stream-compressed into the reference's npz
    contract — memory stays O(chunk x nodes) regardless of T, the same
    chunked pattern as fields/hemodynamics.py (the reference itself flags
    this stage as the memory bottleneck,
    reference: postprocessing_h5py_common.py:154 region). The .npy memmaps
    are kept next to the npz as a zero-copy read path for samplers.

    quantity: 'v'|'d'|'p' (Visualization series), 'wss' (hemodynamics WSS
    time series), 'mps' (max principal strain, DG1 scalar), 'stress'|'strain'
    (full DG1 tensors -> the 6 distinct components 11,12,22,23,33,31).
    Returns (dict comp->memmap, times, npz folder)."""
    import h5py

    folder = Path(folder)
    if quantity in _FIELD_FILE:
        viz = folder / "Visualization"
        name = _FIELD_FILE[quantity]
    else:
        sub, name = _CKPT_FILE[quantity]
        viz = folder / sub
    # layout auto-detection: write_checkpoint series carry
    # FiniteElementFunction items (the reference's output_file_lists
    # distinction, postprocessing_common.py:91-95)
    xdmf = (viz / f"{name}.xdmf").read_text()
    if "FiniteElementFunction" in xdmf:
        fmt = name + "/" + name + "_{}/vector"
    else:
        fmt = "VisualisationVector/{}"
    h5s, times, idxs = output_file_lists(viz / f"{name}.xdmf")
    times = np.asarray(times)
    sel = np.arange(len(times))[::stride]
    if start_t is not None:
        sel = sel[times[sel] >= start_t]
    if end_t is not None:
        sel = sel[times[sel] <= end_t]
    if len(sel) > 1:
        dts = np.diff(times[sel])
        if np.abs(dts - dts[0]).max() > 1e-8:
            print("WARNING : Uneven temporal spacing detected")

    out = Path(out_folder) if out_folder else folder / f"npz_{quantity}"
    out.mkdir(parents=True, exist_ok=True)
    dof_info = None
    cache = {}
    memmaps = None
    T_sel = len(sel)
    try:
        # probe the first selected dataset for shape/component layout
        i0 = sel[0]
        cache[h5s[i0]] = h5py.File(viz / h5s[i0], "r")
        first = cache[h5s[i0]][fmt.format(idxs[i0])]
        shape = first.shape
        tensor = quantity in ("stress", "strain")
        if tensor:
            cnames = list(_TENSOR_SLOTS)
            nrows = int(np.prod(shape)) // 9
        elif len(shape) == 2 and shape[1] == 3:
            cnames = ["x", "y", "z", "mag"]
            nrows = shape[0]
        else:
            cnames = ["mag"]
            nrows = int(np.prod(shape))
        memmaps = {c: np.lib.format.open_memmap(
            out / f"{quantity}_{c}.npy", mode="w+", dtype=np.float64,
            shape=(nrows, T_sel)) for c in cnames}

        if quantity in _CKPT_FILE and "FiniteElementFunction" in xdmf:
            # dof metadata for downstream tensor reassembly (reference
            # saves these as dof_info pickles, common.py:401-406)
            g0 = cache[h5s[i0]][f"{name}/{name}_0"]
            dof_info = {k: np.asarray(g0[k][:]) for k in
                        ("cell_dofs", "cells", "x_cell_dofs")}
            dof_info["mesh/geometry"] = np.asarray(g0["mesh/geometry"][:])
            dof_info["mesh/topology"] = np.asarray(g0["mesh/topology"][:])

        if chunk_steps is None:
            # ~0.5 GB of f64 rows per chunk
            per_step = max(int(np.prod(shape)), 1)
            chunk_steps = max(1, int(6e7 / per_step))
        for j0 in range(0, T_sel, chunk_steps):
            j1 = min(j0 + chunk_steps, T_sel)
            arrays = []
            for i in sel[j0:j1]:
                if h5s[i] not in cache:
                    cache[h5s[i]] = h5py.File(viz / h5s[i], "r")
                arrays.append(cache[h5s[i]][fmt.format(idxs[i])][:])
            series = np.stack(arrays, axis=0)
            if tensor:
                pts = series.reshape(j1 - j0, -1, 9)
                for cname, slot in _TENSOR_SLOTS.items():
                    memmaps[cname][:, j0:j1] = pts[:, :, slot].T
            elif series.ndim == 3 and series.shape[2] == 3:
                memmaps["x"][:, j0:j1] = series[:, :, 0].T
                memmaps["y"][:, j0:j1] = series[:, :, 1].T
                memmaps["z"][:, j0:j1] = series[:, :, 2].T
                memmaps["mag"][:, j0:j1] = np.linalg.norm(series, axis=2).T
            else:
                memmaps["mag"][:, j0:j1] = series.reshape(j1 - j0, -1).T
    finally:
        for f in cache.values():
            f.close()
    np.save(out / f"{quantity}_times.npy", times[sel])
    comps = {}
    for comp in list(memmaps):
        mat = memmaps.pop(comp)
        mat.flush()
        # "data" is this package's key; "component" matches the reference's
        # npz readers (postprocessing_h5py_common.py read_npz_files)
        _write_npz_streaming(out / f"{quantity}_{comp}.npz",
                             [("data", mat), ("component", mat),
                              ("times", times[sel])])
        del mat  # release the write mapping before reopening read-only
        comps[comp] = np.load(out / f"{quantity}_{comp}.npy", mmap_mode="r")
    if dof_info is not None:
        import pickle

        with open(out / "dof_info.pkl", "wb") as f:
            pickle.dump(dof_info, f)
    return comps, times[sel], out


def _points_in_region(coords, region, sampling_region):
    """Row ids of coords inside a sphere [x,y,z,r] or box [x0..z1]; all
    rows when no region is given."""
    if sampling_region is None:
        return np.arange(len(coords))
    if region == "sphere":
        cx, cy, cz, r = sampling_region
        keep = ((coords[:, 0] - cx) ** 2 + (coords[:, 1] - cy) ** 2
                + (coords[:, 2] - cz) ** 2) <= r ** 2
    else:
        x0, x1, y0, y1, z0, z1 = sampling_region
        keep = ((coords[:, 0] >= x0) & (coords[:, 0] <= x1)
                & (coords[:, 1] >= y0) & (coords[:, 1] <= y1)
                & (coords[:, 2] >= z0) & (coords[:, 2] <= z1))
    return np.nonzero(keep)[0]


def select_region_nodes(mesh_path, params=None, region="sphere",
                        sampling_region=None, fluid_sampling_domain=True,
                        solid_sampling_domain=False, fsi_region=None,
                        refined=None):
    """Node ids in a sampling region (sphere [x,y,z,r] or box
    [x0,x1,y0,y1,z0,z1]) intersected with the requested domain
    (reference: spectrograms.py:221-266)."""
    params = params or {}
    mesh = read_vasp_mesh(mesh_path)
    save_deg = int(params.get("save_deg", 2)) if refined is None else (
        2 if refined else 1
    )
    dx_f = params.get("dx_f_id", 1)
    dx_s = params.get("dx_s_id", 2)
    if save_deg == 2:
        fluid_ids, solid_ids, all_ids = get_domain_ids_refined(
            mesh_path, dx_f, dx_s
        )
        coords = np.concatenate([mesh.coords, mesh.edge_midpoints])
    else:
        fluid_ids, solid_ids, all_ids = get_domain_ids(mesh_path, dx_f, dx_s)
        coords = mesh.coords

    if fluid_sampling_domain and solid_sampling_domain:
        ids = all_ids
    elif fluid_sampling_domain:
        ids = fluid_ids
    elif solid_sampling_domain:
        ids = solid_ids
    else:
        ids = get_interface_ids(mesh_path, params.get("fsi_id", 22),
                                refined=save_deg == 2)

    if sampling_region is None and fsi_region is not None:
        region, sampling_region = "sphere", fsi_region
    if sampling_region is not None:
        x = coords[ids]
        if region == "sphere":
            cx, cy, cz, r = sampling_region
            keep = ((x[:, 0] - cx) ** 2 + (x[:, 1] - cy) ** 2
                    + (x[:, 2] - cz) ** 2) <= r ** 2
        else:  # box
            x0, x1, y0, y1, z0, z1 = sampling_region
            keep = ((x[:, 0] >= x0) & (x[:, 0] <= x1)
                    & (x[:, 1] >= y0) & (x[:, 1] <= y1)
                    & (x[:, 2] >= z0) & (x[:, 2] <= z1))
        ids = ids[keep]
    return ids


def read_spectrogram_data(folder, mesh_path=None, quantity="v",
                          n_samples=None, sampling_method="RandomPoint",
                          point_ids=None, region="sphere",
                          sampling_region=None, fluid_sampling_domain=True,
                          solid_sampling_domain=False, start_t=None,
                          end_t=None, stride=1, seed=0,
                          component="mag"):
    """Assemble the sampled node x time matrix for spectral analysis
    (reference: spectrograms.py:160-330). Returns (matrix, times, fs).

    Rows are selected BEFORE materialization: components are read through
    the pivot's on-disk memmaps when present, so only the sampled rows ever
    enter memory (bounded even for node x time matrices beyond host RAM)."""
    import h5py

    folder = Path(folder)
    params = read_parameters_from_file(folder) or {}
    mesh_path = Path(mesh_path) if mesh_path else folder / "Mesh" / "mesh.h5"

    npz_dir = folder / f"npz_{quantity}"
    tensor_mag = quantity in ("stress", "strain") and component == "mag"
    c0 = "11" if tensor_mag else component
    if not (npz_dir / f"{quantity}_{c0}.npz").exists():
        create_transformed_matrix(folder, quantity, start_t, end_t, stride)

    def load_comp(c):
        npy = npz_dir / f"{quantity}_{c}.npy"
        if npy.exists():
            return np.load(npy, mmap_mode="r")
        return np.load(npz_dir / f"{quantity}_{c}.npz")["data"]

    tnpy = npz_dir / f"{quantity}_times.npy"
    times = (np.load(tnpy) if tnpy.exists()
             else np.load(npz_dir / f"{quantity}_{c0}.npz")["times"])
    mat = load_comp(c0)

    if quantity == "wss":
        # WSS rows live on the fluid BOUNDARY mesh, not the volume mesh
        # (reference: spectrograms.py:214-217 get_surface_topology_coords)
        with h5py.File(folder / "Hemodynamic_indices" / "WSS.h5", "r") as f:
            coords = f["Mesh/0/mesh/geometry"][:]
        ids = _points_in_region(coords, region, sampling_region
                                or params.get("fsi_region"))
    elif quantity in ("mps", "stress", "strain"):
        # rows are DG points (cell, vertex) of the solid submesh
        import pickle

        with open(folder / f"npz_{quantity}" / "dof_info.pkl", "rb") as f:
            di = pickle.load(f)
        coords = di["mesh/geometry"][di["mesh/topology"]].reshape(-1, 3)
        ids = _points_in_region(coords, region, sampling_region
                                or params.get("fsi_region"))
    else:
        ids = select_region_nodes(
            mesh_path, params, region, sampling_region,
            fluid_sampling_domain, solid_sampling_domain,
            fsi_region=params.get("fsi_region"),
        )
    ids = ids[ids < mat.shape[0]]
    if sampling_method == "PointList" and point_ids is not None:
        ids = np.asarray(point_ids)
    elif n_samples is not None and len(ids) > n_samples:
        rng = np.random.default_rng(seed)
        ids = np.sort(rng.choice(ids, size=n_samples, replace=False))
    fs = 1.0 / np.mean(np.diff(times)) if len(times) > 1 else 1.0
    if tensor_mag:
        # Frobenius magnitude from the 6 distinct symmetric components,
        # accumulated over the SELECTED rows only
        acc = np.zeros((len(ids), mat.shape[1]))
        for cname in _COMPONENTS[quantity]:
            w = 1.0 if cname in ("11", "22", "33") else 2.0
            acc += w * np.asarray(load_comp(cname)[ids]) ** 2
        return np.sqrt(acc), times, fs
    return np.asarray(mat[ids]), times, fs
