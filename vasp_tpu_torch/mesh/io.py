"""HDF5 mesh I/O in the reference's on-disk layout.

Layout (reference: src/vasp/preprocessing/preprocessing_common.py:198-248 and
src/vasp/simulations/cylinder.py:75-86):

    /mesh/coordinates        (Nn, 3) float64
    /mesh/topology           (Nc, 4) int64     attrs: celltype='tetrahedron'
    /mesh/cell_indices       (Nc,)   int64
    /boundaries/coordinates  (Nn, 3)
    /boundaries/topology     (Nf, 3) int64     attrs: celltype='triangle'
    /boundaries/values       (Nf,)   uint64    (ALL facets; 0 = unmarked)
    /domains/{coordinates,topology,cell_indices}
    /domains/values          (Nc,)   uint64    (fluid=1, solid=2, zones 1001..)
"""
# h5py is imported inside the functions that read or write HDF5, so a
# run with file output off (save_step=0, checkpoint_step=0) needs none.
import json
from pathlib import Path

import numpy as np

from vasp_tpu_torch.mesh.tetmesh import TetMesh


def read_vasp_mesh(path) -> TetMesh:
    """Read a VaSP-layout FSI mesh (.h5) into a TetMesh.

    Facets with value 0 (unmarked interior facets) are dropped; the TetMesh
    keeps only marked facets, which is all any measure ever integrates over.
    """
    import h5py

    with h5py.File(path, "r") as f:
        coords = f["mesh/coordinates"][:]
        cells = f["mesh/topology"][:]
        if "domains" in f:
            dom_vals = f["domains/values"][:].astype(np.int64)
        else:
            dom_vals = np.ones(cells.shape[0], np.int64)
        if "boundaries" in f:
            btopo = f["boundaries/topology"][:]
            bvals = f["boundaries/values"][:].astype(np.int64)
            keep = bvals > 0
            btopo, bvals = btopo[keep], bvals[keep]
        else:
            btopo = np.zeros((0, 3), np.int64)
            bvals = np.zeros((0,), np.int64)
    return TetMesh(coords, cells, dom_vals, btopo, bvals)


def write_vasp_mesh(path, mesh: TetMesh, all_facets: bool = True,
                    compress: bool = False) -> None:
    """Write a TetMesh in the reference HDF5 layout.

    If all_facets, emit every facet of the mesh with value 0 for unmarked
    ones (matching dolfin's full-facet MeshFunction dump). compress gzips
    every dataset (reference --compress-mesh, preprocessing.py)."""
    path = Path(path)
    if all_facets:
        fv, *_ = mesh._facet_tables
        vals = np.zeros(fv.shape[0], np.uint64)
        # match marked facets into the global table
        idx = mesh._match_marked_facets()
        vals[idx] = mesh.facet_markers.astype(np.uint64)
        btopo, bvals = fv, vals
    else:
        btopo, bvals = mesh.facets, mesh.facet_markers.astype(np.uint64)
    kw = dict(compression="gzip") if compress else {}
    import h5py

    with h5py.File(path, "w") as f:
        for grp in ("mesh", "domains", "boundaries"):
            g = f.create_group(grp)
            g.create_dataset("coordinates", data=mesh.coords, **kw)
            if grp == "boundaries":
                t = g.create_dataset("topology", data=btopo.astype(np.int64),
                                     **kw)
                t.attrs["celltype"] = np.bytes_(b"triangle")
                g.create_dataset("values", data=bvals, **kw)
            else:
                t = g.create_dataset("topology",
                                     data=mesh.cells.astype(np.int64), **kw)
                t.attrs["celltype"] = np.bytes_(b"tetrahedron")
                g.create_dataset(
                    "cell_indices",
                    data=np.arange(mesh.num_cells, dtype=np.int64), **kw
                )
                if grp == "domains":
                    g.create_dataset(
                        "values", data=mesh.cell_markers.astype(np.uint64),
                        **kw
                    )
            t.attrs["partition"] = np.array([0], np.uint64)


def write_mesh_xdmf(h5_path) -> "Path":
    """Write an XDMF companion describing the mesh/domains/boundaries groups
    of a VaSP-layout mesh h5 (reference --mesh-format xdmf emits an
    XDMF-readable mesh, preprocessing.py write stage)."""
    h5_path = Path(h5_path)
    import h5py

    with h5py.File(h5_path, "r") as f:
        n_vert = f["mesh/coordinates"].shape[0]
        n_cell = f["mesh/topology"].shape[0]
        n_bfac = f["boundaries/topology"].shape[0]
    name = h5_path.name
    xml = f"""<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Topology NumberOfElements="{n_cell}" TopologyType="Tetrahedron" NodesPerElement="4">
        <DataItem Dimensions="{n_cell} 4" NumberType="Int" Format="HDF">{name}:/mesh/topology</DataItem>
      </Topology>
      <Geometry GeometryType="XYZ">
        <DataItem Dimensions="{n_vert} 3" Format="HDF">{name}:/mesh/coordinates</DataItem>
      </Geometry>
      <Attribute Name="domains" AttributeType="Scalar" Center="Cell">
        <DataItem Dimensions="{n_cell}" NumberType="UInt" Format="HDF">{name}:/domains/values</DataItem>
      </Attribute>
    </Grid>
    <Grid Name="boundaries" GridType="Uniform">
      <Topology NumberOfElements="{n_bfac}" TopologyType="Triangle" NodesPerElement="3">
        <DataItem Dimensions="{n_bfac} 3" NumberType="Int" Format="HDF">{name}:/boundaries/topology</DataItem>
      </Topology>
      <Geometry GeometryType="XYZ">
        <DataItem Dimensions="{n_vert} 3" Format="HDF">{name}:/boundaries/coordinates</DataItem>
      </Geometry>
      <Attribute Name="boundaries" AttributeType="Scalar" Center="Cell">
        <DataItem Dimensions="{n_bfac}" NumberType="UInt" Format="HDF">{name}:/boundaries/values</DataItem>
      </Attribute>
    </Grid>
  </Domain>
</Xdmf>
"""
    out = h5_path.with_suffix(".xdmf")
    out.write_text(xml)
    return out


def load_mesh_info(mesh_path) -> dict:
    """Load the `<case>_info.json` metadata next to a mesh file
    (reference: src/vasp/simulations/simulation_common.py:80-116)."""
    mesh_path = Path(mesh_path)
    info_path = mesh_path.with_name(mesh_path.stem + "_info.json")
    with open(info_path) as f:
        return json.load(f)


def load_probe_points(mesh_path) -> np.ndarray:
    """Load `<case>_probe_point.json` probe coordinates
    (reference: src/vasp/simulations/simulation_common.py:119-136)."""
    mesh_path = Path(mesh_path)
    probe_path = mesh_path.with_name(mesh_path.stem + "_probe_point.json")
    with open(probe_path) as f:
        pts = json.load(f)
    return np.asarray(pts, dtype=np.float64).reshape(-1, 3)


def load_solid_probe_points(mesh_path) -> np.ndarray:
    """Load `<case>_solid_probe.json`
    (reference: src/vasp/simulations/simulation_common.py:139-154)."""
    mesh_path = Path(mesh_path)
    probe_path = mesh_path.with_name(mesh_path.stem + "_solid_probe.json")
    with open(probe_path) as f:
        pts = json.load(f)
    return np.asarray(pts, dtype=np.float64).reshape(-1, 3)
