"""Band-pass filtered mode visualization + windowed-RMS amplitude fields.

Counterpart of vasp_tpu.postprocessing.spectral.hi_pass_viz: the filters
and the windowed RMS are scipy/numpy on the host, as there; the strain
path's eigen pass is K20b's eigenvalue (kernels/postproc.max_eig) on
`device`. Parity target: vasp-create-hi-pass-viz
(reference: src/vasp/postprocessing/postprocessing_h5py/create_hi_pass_viz.py):
- Butterworth band-pass (or multiband pass/stop list) filtering of EVERY
  node's time series (L190-215),
- windowed-RMS amplitude fields (window 250 for d/v/p, 50 for strain,
  L222-228),
- writes the filtered field series + amplitude series as h5+XDMF in the
  VisualisationVector layout (L345-368), plus an amplitude-percentile CSV
  (L370-416).
"""
from pathlib import Path

import numpy as np
import torch

from vasp_tpu_torch.device import resolve_device
from vasp_tpu_torch.kernels.postproc import max_eig
from vasp_tpu_torch.mesh.io import read_vasp_mesh
from vasp_tpu_torch.mesh.refine import refine_uniform
from vasp_tpu_torch.postprocessing.common import (
    output_file_lists,
    read_parameters_from_file,
)
from vasp_tpu_torch.postprocessing.spectral import core as spec
from vasp_tpu_torch.postprocessing.spectral.transform import (
    _TENSOR_SLOTS,
    create_transformed_matrix,
)
from vasp_tpu_torch.run.output import VizWriter

_FIELD_FILE = {"v": "velocity", "d": "displacement", "p": "pressure"}
_DEFAULT_RMS_WINDOW = {"v": 250, "d": 250, "p": 250, "strain": 50}


def _apply_filter(mat, fs, lowcut, highcut, filter_type, bands):
    """Butterworth filter rows of (rows, T): single band or the multiband
    pass/stop list (reference: create_hi_pass_viz.py:532-545)."""
    if bands:
        out = np.zeros_like(mat)
        for (lo, hi, btype) in bands:
            if btype == "pass":
                out += spec.butter_bandpass_filter(
                    mat, lowcut=lo, highcut=hi, fs=fs, order=6, btype="band")
            else:
                out = spec.butter_bandpass_filter(
                    out, lowcut=lo, highcut=hi, fs=fs, order=6, btype="stop")
        return out
    highcut_eff = min(highcut, 0.5 * fs * 0.999)
    btype = "band" if filter_type in ("bandpass", "band") else filter_type
    if btype == "band" and highcut_eff >= 0.5 * fs * 0.99:
        btype = "highpass"
    return spec.butter_bandpass_filter(mat, lowcut=lowcut,
                                       highcut=highcut_eff, fs=fs, order=6,
                                       btype=btype)


def create_hi_pass_viz(folder, quantity="d", lowcut=25.0, highcut=100000.0,
                       filter_type="bandpass", mesh_path=None,
                       bands=None, amplitude=True, start_t=None, end_t=None,
                       stride=1, node_chunk=None, device="cuda"):
    """Filter the node x time series of `quantity` and write
    Visualization_hi_pass/<q>_<low>_to_<high>.{h5,xdmf} (+ amplitude).

    Streaming: the series is pivoted into an on-disk (rows, T) memmap in
    time-chunks, filtfilt runs per `node_chunk` rows (default sized to
    ~0.5 GB), and outputs are written per timestep from memmap columns —
    host memory stays O(chunk) regardless of nodes x timesteps (the same
    chunked pattern as fields/hemodynamics.py; the reference flags this
    stage as the memory bottleneck,
    reference: postprocessing_h5py_common.py:154 region)."""
    import h5py

    folder = Path(folder)
    params = read_parameters_from_file(folder) or {}
    save_deg = int(params.get("save_deg", 2))
    mesh_path = Path(mesh_path) if mesh_path else folder / "Mesh" / "mesh.h5"

    if quantity == "strain":
        return _create_hi_pass_strain(folder, lowcut, highcut, bands,
                                      start_t, end_t, stride, node_chunk,
                                      device)

    mesh = read_vasp_mesh(mesh_path)
    out_mesh = refine_uniform(mesh) if save_deg == 2 else mesh

    viz = folder / "Visualization"
    name = _FIELD_FILE[quantity]
    h5s, times, idxs = output_file_lists(viz / f"{name}.xdmf")
    times = np.asarray(times)
    T = len(times)
    fs = 1.0 / np.mean(np.diff(times)) if len(times) > 1 else 1.0

    out_dir = folder / "Visualization_hi_pass"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{quantity}_{int(lowcut)}_to_{int(highcut)}"

    # ---- pivot (T, N, c) h5 series -> on-disk (N*c, T) memmap, time-chunked
    cache = {}
    try:
        f0 = h5py.File(viz / h5s[0], "r")
        cache[h5s[0]] = f0
        shape0 = f0[f"VisualisationVector/{idxs[0]}"].shape
        vector = len(shape0) == 2 and shape0[1] == 3
        ncomp = shape0[1] if len(shape0) == 2 else 1
        nrows = shape0[0] * ncomp
        flat = np.lib.format.open_memmap(
            out_dir / f".{tag}_pivot.npy", mode="w+", dtype=np.float64,
            shape=(nrows, T))
        tchunk = max(1, int(6e7 / max(nrows, 1)))
        for k0 in range(0, T, tchunk):
            k1 = min(k0 + tchunk, T)
            block = []
            for h5name, idx in zip(h5s[k0:k1], idxs[k0:k1]):
                if h5name not in cache:
                    cache[h5name] = h5py.File(viz / h5name, "r")
                block.append(cache[h5name][f"VisualisationVector/{idx}"][:])
            flat[:, k0:k1] = np.stack(block, axis=0).reshape(k1 - k0, -1).T
    finally:
        for f in cache.values():
            f.close()

    # ---- filter + windowed RMS per node-chunk
    filtered = np.lib.format.open_memmap(
        out_dir / f".{tag}_filtered.npy", mode="w+", dtype=np.float64,
        shape=(nrows, T))
    window = min(_DEFAULT_RMS_WINDOW.get(quantity, 250), T)
    rms = (np.lib.format.open_memmap(
        out_dir / f".{tag}_rms.npy", mode="w+", dtype=np.float64,
        shape=(nrows, T)) if amplitude else None)
    if node_chunk is None:
        node_chunk = max(1, int(6e7 / max(T, 1)))
    for n0 in range(0, nrows, node_chunk):
        n1 = min(n0 + node_chunk, nrows)
        fchunk = _apply_filter(np.asarray(flat[n0:n1]), fs, lowcut, highcut,
                               filter_type, bands)
        filtered[n0:n1] = fchunk
        if amplitude:
            rms[n0:n1] = spec.calculate_windowed_rms(fchunk, window, axis=-1)

    # ---- write outputs per timestep from memmap columns
    series_shape = (shape0[0], ncomp) if len(shape0) == 2 else (nrows,)
    writer = VizWriter(out_dir, tag, out_mesh.coords, out_mesh.cells,
                       vector=vector)
    for k, t in enumerate(times):
        writer.write(filtered[:, k].reshape(series_shape), float(t))

    results = dict(filtered=filtered, times=times)
    if amplitude:
        # amplitude of vectors: RMS of the magnitude-equivalent (per
        # component then norm)
        amp_writer = VizWriter(out_dir, f"{tag}_amplitude", out_mesh.coords,
                               out_mesh.cells, vector=vector)
        pcts = [5, 25, 50, 75, 95, 99]
        table = np.zeros((T, 1 + len(pcts)))
        for k, t in enumerate(times):
            col = rms[:, k].reshape(series_shape)
            amp_writer.write(col, float(t))
            amp_mag = (np.linalg.norm(col, axis=1) if vector
                       else col.reshape(-1))
            table[k, 0] = t
            table[k, 1:] = np.percentile(amp_mag, pcts)
        # percentile CSV (reference L370-416)
        np.savetxt(out_dir / f"{tag}_amplitude_percentiles.csv", table,
                   delimiter=",",
                   header="time," + ",".join(f"p{p}" for p in pcts))
        results["amplitude"] = rms
    (out_dir / f".{tag}_pivot.npy").unlink()
    return results


def strain_amplitudes(comps, fs, lowcut, highcut, bands, window, device):
    """The band-pass strain arithmetic of one chunk of points, on arrays:
    comps maps the 6 distinct Green-Lagrange components (11, 12, 22, 23,
    33, 31) to (n, T) series. Each is filtered and windowed-RMS'd on the
    host (scipy/numpy); the symmetric amplitude tensor per (point, time)
    goes to its largest eigenvalue on `device` (K20b's max_eig on a card).
    Returns (filtered components, (n, T) max-principal amplitude)."""
    filtered, A = {}, None
    for cname, slot in _TENSOR_SLOTS.items():
        f = _apply_filter(comps[cname], fs, lowcut, highcut, "bandpass",
                          bands)
        filtered[cname] = f
        rms = spec.calculate_windowed_rms(f, window, axis=-1)
        if A is None:
            A = np.zeros((*rms.shape, 3, 3))
        i, j = divmod(slot, 3)
        A[:, :, i, j] = rms
        A[:, :, j, i] = rms
    mps = max_eig(torch.as_tensor(A, device=device)).cpu().numpy()
    return filtered, mps


def _create_hi_pass_strain(folder, lowcut, highcut, bands, start_t, end_t,
                           stride, node_chunk=None, device="cuda"):
    """Strain band-pass: filter the 6 distinct Green-Lagrange components,
    windowed-RMS their amplitudes, reassemble the symmetric amplitude
    tensor, and take its max-principal value per DG point — the reference's
    strain quantity (reference: create_hi_pass_viz.py:295-325; RMS window
    50, L222-228). Filtering and the eigen pass run per node-chunk against
    the pivot's on-disk memmaps, so memory is O(chunk x T)."""
    from vasp_tpu_torch.run.output import CheckpointSeriesWriter

    comps, times, npz_dir = create_transformed_matrix(
        folder, "strain", start_t=start_t, end_t=end_t, stride=stride)
    import pickle

    with open(npz_dir / "dof_info.pkl", "rb") as f:
        di = pickle.load(f)
    coords = di["mesh/geometry"]
    cells = di["mesh/topology"]
    K = len(cells)
    fs = 1.0 / np.mean(np.diff(times)) if len(times) > 1 else 1.0
    npts, T = comps["11"].shape
    window = min(_DEFAULT_RMS_WINDOW["strain"], T)

    out_dir = folder / "Visualization_hi_pass"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"strain_{int(lowcut)}_to_{int(highcut)}"
    filtered = {c: np.lib.format.open_memmap(
        out_dir / f".{tag}_f{c}.npy", mode="w+", dtype=np.float64,
        shape=(npts, T)) for c in _TENSOR_SLOTS}
    mps_amp = np.lib.format.open_memmap(
        out_dir / f".{tag}_mps.npy", mode="w+", dtype=np.float64,
        shape=(npts, T))
    dev = resolve_device(device)
    if node_chunk is None:
        node_chunk = max(1, int(6e7 / max(T, 1)))
    for n0 in range(0, npts, node_chunk):
        n1 = min(n0 + node_chunk, npts)
        fchunk, mps_amp[n0:n1] = strain_amplitudes(
            {c: np.asarray(comps[c][n0:n1]) for c in _TENSOR_SLOTS}, fs,
            lowcut, highcut, bands, window, dev)
        for c in _TENSOR_SLOTS:
            filtered[c][n0:n1] = fchunk[c]

    # filtered tensor series (checkpoint layout, full 9 components) and the
    # max-principal amplitude series, assembled per timestep from the
    # component memmap columns
    wt = CheckpointSeriesWriter(out_dir, tag, coords, cells, ncomp=9,
                                cell_dofs=np.arange(K * 36).reshape(K, 36))
    wa = CheckpointSeriesWriter(out_dir, f"{tag}_amplitude", coords, cells,
                                ncomp=1,
                                cell_dofs=np.arange(K * 4).reshape(K, 4))
    for k, t in enumerate(times):
        full_k = np.zeros((npts, 9))
        for cname, slot in _TENSOR_SLOTS.items():
            i, j = divmod(slot, 3)
            col = filtered[cname][:, k]
            full_k[:, 3 * i + j] = col
            full_k[:, 3 * j + i] = col
        wt.write(full_k.reshape(-1), float(t))
        wa.write(mps_amp[:, k], float(t))

    pcts = [5, 25, 50, 75, 95, 99]
    table = np.zeros((T, 1 + len(pcts)))
    for k, t in enumerate(times):
        table[k, 0] = t
        table[k, 1:] = np.percentile(mps_amp[:, k], pcts)
    np.savetxt(out_dir / f"{tag}_amplitude_percentiles.csv", table,
               delimiter=",",
               header="time," + ",".join(f"p{p}" for p in pcts))
    for c in _TENSOR_SLOTS:
        (out_dir / f".{tag}_f{c}.npy").unlink()
    return dict(times=times, amplitude=mps_amp)
