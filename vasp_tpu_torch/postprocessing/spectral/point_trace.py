"""Per-point time traces: CSV + PNG for selected nodes.

Counterpart of vasp_tpu.postprocessing.spectral.point_trace (host code,
copied; matplotlib is imported at first use).
Parity target: create_point_trace
(reference: src/vasp/postprocessing/postprocessing_h5py/postprocessing_h5py_common.py:412-506):
for each requested node id, save its component time series as CSV and a
trace figure."""
from pathlib import Path

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def create_point_trace(folder, point_ids, quantity="d", component="mag",
                       out_folder=None):
    """Write <out>/<q>_<comp>_point<id>.{csv,png} for each point id.

    Uses the transformed node x time matrices (created on demand)."""
    plt = _pyplot()

    from vasp_tpu_torch.postprocessing.spectral.transform import (
        create_transformed_matrix,
    )

    folder = Path(folder)
    npz = folder / f"npz_{quantity}" / f"{quantity}_{component}.npz"
    if not npz.exists():
        create_transformed_matrix(folder, quantity)
    data = np.load(npz)
    mat, times = data["data"], data["times"]
    out = Path(out_folder) if out_folder else folder / "point_traces"
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for pid in np.atleast_1d(point_ids):
        series = mat[int(pid)]
        base = out / f"{quantity}_{component}_point{int(pid)}"
        np.savetxt(base.with_suffix(".csv"),
                   np.column_stack([times, series]), delimiter=",",
                   header="time,value")
        fig = plt.figure(figsize=(8, 4))
        plt.plot(times, series)
        plt.xlabel("Time [s]")
        plt.ylabel(f"{quantity} ({component})")
        plt.title(f"point {int(pid)}")
        plt.grid(True)
        plt.savefig(base.with_suffix(".png"))
        plt.close(fig)
        written.append(base)
    return written
