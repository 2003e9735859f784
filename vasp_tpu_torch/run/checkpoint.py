"""Checkpoint / restart in the reference folder layout.

Writes <folder>/Checkpoint/checkpoint_{d,v,p}1.h5 every checkpoint_step and
the merged config as Checkpoint/default_variables.json — the file every
reference postprocessing stage reads back as the source of truth
(reference: src/vasp/postprocessing/postprocessing_common.py:124-145;
checkpoint cadence reference: src/vasp/simulations/offset_stenosis.py:42).
Restart via ``restart_folder`` (SURVEY.md §5.4). The on-disk format is the
reference package's, byte for byte, so either package restarts from the
other's Checkpoint folder."""
# h5py is imported inside the functions that read or write HDF5, so a
# run with file output off (save_step=0, checkpoint_step=0) needs none.
import json
from pathlib import Path

import numpy as np
import torch


def _jsonable(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return str(x)


def save_config(folder, cfg):
    ckpt = Path(folder) / "Checkpoint"
    ckpt.mkdir(parents=True, exist_ok=True)
    with open(ckpt / "default_variables.json", "w") as f:
        json.dump(_jsonable(cfg), f, indent=2)


def read_config(folder):
    path = Path(folder) / "Checkpoint" / "default_variables.json"
    with open(path) as f:
        return json.load(f)


def save_checkpoint(folder, space, U, t, tstep):
    import h5py

    ckpt = Path(folder) / "Checkpoint"
    ckpt.mkdir(parents=True, exist_ok=True)
    d, v, p = space.split(U.detach().cpu().numpy())
    for name, key, arr in (
        ("d", "displacement", d),
        ("v", "velocity", v),
        ("p", "pressure", p),
    ):
        with h5py.File(ckpt / f"checkpoint_{name}1.h5", "w") as f:
            f.create_dataset(f"{key}/vector_0", data=np.asarray(arr))
            f.attrs["t"] = float(t)
            f.attrs["tstep"] = int(tstep)


def load_checkpoint(folder, space, device="cpu"):
    """Returns (U, t, tstep) from a checkpoint folder; U is a float64
    tensor on `device`."""
    import h5py

    ckpt = Path(folder) / "Checkpoint"
    arrs = {}
    t = 0.0
    tstep = 0
    for name, key in (("d", "displacement"), ("v", "velocity"),
                      ("p", "pressure")):
        with h5py.File(ckpt / f"checkpoint_{name}1.h5", "r") as f:
            arrs[name] = f[f"{key}/vector_0"][:]
            t = float(f.attrs["t"])
            tstep = int(f.attrs["tstep"])
    U = space.pack(arrs["d"], arrs["v"], arrs["p"])
    return torch.as_tensor(U, dtype=torch.float64, device=device), t, tstep
