"""Mesh postprocessing stage of a results folder: predeform.

Counterpart of vasp_tpu.postprocessing.mesh_stages.predeform_mesh
(vasp-predeform-mesh, reference: postprocessing/predeform_mesh.py): add the
final displacement x scale_factor (default -1) to all mesh coordinate
arrays -> mesh_predeformed.h5, the geometry of the prestress chain's
production run (predeform run -> this stage -> the run on the predeformed
mesh).

h5py is imported inside the function, so the module imports on a host
without it.
"""
from pathlib import Path

from vasp_tpu_torch.run.output import output_file_lists


def predeform_mesh(folder, mesh_path=None, scale_factor=-1.0):
    """Apply the last displacement step (scaled) to the mesh coordinates ->
    mesh_predeformed.h5 beside the mesh (reference: predeform_mesh.py:33-67).
    The run must have written its displacement series at save_deg=1 (the
    vertex values). Returns the output path."""
    import h5py

    folder = Path(folder)
    viz = folder / "Visualization"
    mesh_path = Path(mesh_path) if mesh_path else folder / "Mesh" / "mesh.h5"
    h5s, times, idxs = output_file_lists(viz / "displacement.xdmf")
    with h5py.File(viz / h5s[-1], "r") as f:
        disp = f[f"VisualisationVector/{idxs[-1]}"][:]
    out = mesh_path.with_name(mesh_path.stem + "_predeformed.h5")
    with h5py.File(mesh_path, "r") as src, h5py.File(out, "w") as dst:
        src.copy("mesh", dst)
        if "domains" in src:
            src.copy("domains", dst)
        if "boundaries" in src:
            src.copy("boundaries", dst)
        for grp in ("mesh", "domains", "boundaries"):
            if grp in dst:
                coords = dst[f"{grp}/coordinates"][:]
                n = coords.shape[0]
                coords += disp[:n] * scale_factor
                dst[f"{grp}/coordinates"][...] = coords
    return out


def main(argv=None):
    """Console entry point (vasp-tpu-torch-predeform-mesh): the counterpart
    of vasp-predeform-mesh, the same arguments."""
    import argparse

    p = argparse.ArgumentParser(prog="vasp-tpu-torch-predeform-mesh")
    p.add_argument("--folder", required=True,
                   help="simulation results folder")
    p.add_argument("--mesh-path", default=None)
    p.add_argument("--scale-factor", type=float, default=-1.0)
    args = p.parse_args(argv)
    out = predeform_mesh(args.folder, args.mesh_path, args.scale_factor)
    print(f"Predeformed mesh written to {out}")


if __name__ == "__main__":
    main()
