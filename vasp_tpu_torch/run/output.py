"""Visualization output in the reference's on-disk layout.

Writes Visualization/{velocity,displacement,pressure}.{xdmf,h5} with
per-timestep `/VisualisationVector/<i>` datasets and a mesh group, which is
the exact format the reference postprocessing parses
(reference: src/vasp/postprocessing/postprocessing_common.py:63-121 regexes
'"HDF">file.h5:/VisualisationVector/<i>' and '<Time Value="..."';
reference: postprocessing_fenics/create_hdf5.py:90-160 reads
'VisualisationVector/<i>' arrays).

save_deg semantics (reference: src/vasp/simulations/cylinder.py:68):
- save_deg=1: P1 part of the solution at mesh vertices,
- save_deg=2: full P2 resolution emitted as node values on the once-refined
  mesh whose node ordering equals the P2 dof ordering (vasp_tpu_torch.mesh.refine),
  so no renumbering repair is ever needed.

The files are the reference package's layout, dataset for dataset.
"""
# h5py is imported inside the functions that read or write HDF5, so a
# run with file output off (save_step=0, checkpoint_step=0) needs none.
import re
from pathlib import Path

import numpy as np

from vasp_tpu_torch.mesh.refine import refine_uniform

_XDMF_HEADER = """<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0" xmlns:xi="http://www.w3.org/2001/XInclude">
  <Domain>
    <Grid Name="TimeSeries_{name}" GridType="Collection" CollectionType="Temporal">
"""
_XDMF_FOOTER = """    </Grid>
  </Domain>
</Xdmf>
"""


def output_file_lists(xdmf_file):
    """Parse an output XDMF into (h5_names, times, indices) with the same
    regexes the reference uses (reference: postprocessing_common.py:63-121)."""
    lines = Path(xdmf_file).read_text().splitlines()
    checkpoint_data = any("FiniteElementFunction" in ln for ln in lines)
    h5s, times, idxs = [], [], []
    for line in lines:
        if "<Time Value" in line:
            times.append(float(re.findall('<Time Value="(.+?)"', line)[0]))
        if checkpoint_data and "vector" in line:
            h5s.append(re.findall(r'"HDF">(.*?):', line)[0])
            idxs.append(int(re.findall(r"_([0-9]+)\/vector", line)[0]))
        elif not checkpoint_data and "VisualisationVector" in line:
            h5s.append(re.findall('"HDF">(.+?):/', line)[0])
            idxs.append(
                int(re.findall("VisualisationVector/(.+?)</DataItem", line)[0])
            )
    return h5s, times, idxs


class VizWriter:
    """One field's time-series writer (velocity / displacement / pressure)."""

    def __init__(self, folder, name, coords, cells, vector=True,
                 cell_type="Tetrahedron", restart=False):
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.xdmf_path = self.folder / f"{name}.xdmf"
        self.vector = vector
        self.cell_type = cell_type
        self.nodes_per_elem = {"Tetrahedron": 4, "Triangle": 3}[cell_type]
        self.count = 0
        self.n_nodes = len(coords)
        self.n_cells = len(cells)
        # restart semantics (reference: restarted runs append a NEW h5 to
        # the series, postprocessing_common.py:63-121 parses multi-file
        # series): keep prior entries, write new data into <name>_r<k>.h5
        self.prior_entries = []  # (t, index, h5name)
        h5_name = f"{name}.h5"
        if restart and self.xdmf_path.exists():
            h5s, times, idxs = output_file_lists(self.xdmf_path)
            self.prior_entries = list(zip(times, idxs, h5s))
            k = 1
            while (self.folder / f"{name}_r{k}.h5").exists():
                k += 1
            h5_name = f"{name}_r{k}.h5"
        self.h5_path = self.folder / h5_name
        self.entries = []  # (t, index) into self.h5_path
        import h5py

        with h5py.File(self.h5_path, "w") as f:
            g = f.create_group("Mesh/0/mesh")
            g.create_dataset("geometry", data=np.asarray(coords, np.float64))
            g.create_dataset("topology", data=np.asarray(cells, np.int64))
            f.create_group("VisualisationVector")

    def write(self, values, t):
        values = np.asarray(values)
        import h5py

        with h5py.File(self.h5_path, "a") as f:
            f["VisualisationVector"].create_dataset(
                str(self.count), data=values
            )
        self.entries.append((float(t), self.count))
        self.count += 1
        self._write_xdmf()

    def _write_xdmf(self):
        nn, nc = self.n_nodes, self.n_cells
        parts = [_XDMF_HEADER.format(name=self.name)]
        if self.vector:
            attr = f'AttributeType="Vector"'
            dims = f"{nn} 3"
        else:
            attr = f'AttributeType="Scalar"'
            dims = f"{nn}"
        all_entries = [(t, i, h5name) for (t, i, h5name) in
                       self.prior_entries]
        all_entries += [(t, i, self.h5_path.name) for (t, i) in self.entries]
        for t, i, h5 in all_entries:
            parts.append(
                f"""      <Grid Name="mesh" GridType="Uniform">
        <Topology NumberOfElements="{nc}" TopologyType="{self.cell_type}" NodesPerElement="{self.nodes_per_elem}">
          <DataItem Dimensions="{nc} {self.nodes_per_elem}" NumberType="UInt" Format="HDF">{h5}:/Mesh/0/mesh/topology</DataItem>
        </Topology>
        <Geometry GeometryType="XYZ">
          <DataItem Dimensions="{nn} 3" Format="HDF">{h5}:/Mesh/0/mesh/geometry</DataItem>
        </Geometry>
        <Time Value="{t}" />
        <Attribute Name="{self.name}" {attr} Center="Node">
          <DataItem Dimensions="{dims}" Format="HDF">{h5}:/VisualisationVector/{i}</DataItem>
        </Attribute>
      </Grid>
""")
        parts.append(_XDMF_FOOTER)
        self.xdmf_path.write_text("".join(parts))


class CheckpointSeriesWriter:
    """Time-series writer in the reference's write_checkpoint h5 layout
    (vasp_tpu.run.output.CheckpointSeriesWriter, the same files).

    The reference's FEniCS postprocessing stages write their fields with
    XDMFFile.write_checkpoint, and its h5py stack reads them back as
    ``<name>/<name>_{i}/vector`` plus dof metadata (cell_dofs, cells,
    x_cell_dofs, mesh/geometry, mesh/topology) from group ``<name>_0``
    (reference: postprocessing_h5py/postprocessing_h5py_common.py:231-259,
    380-399). This writer reproduces that contract:

    - `vector`: flat (n_dofs,) column per timestep,
    - dof metadata in the _0 group (DG layout: dof = cell*ndpc + local, so
      cell_dofs is simply arange; CG layouts pass cell_dofs explicitly),
    - XDMF with ItemType="FiniteElementFunction" entries that
      output_file_lists parses as checkpoint data.

    ncomp: values per point (1 scalar, 3 vector, 9 tensor)."""

    def __init__(self, folder, name, coords, cells, ncomp=1,
                 cell_dofs=None, family="DG", degree=1):
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.ncomp = int(ncomp)
        self.family = family
        self.degree = int(degree)
        self.h5_path = self.folder / f"{name}.h5"
        self.xdmf_path = self.folder / f"{name}.xdmf"
        self.count = 0
        self.entries = []
        # a fresh writer REPLACES any previous series (append-mode h5 would
        # trip on existing groups)
        if self.h5_path.exists():
            self.h5_path.unlink()
        cells = np.asarray(cells, np.int64)
        coords = np.asarray(coords, np.float64)
        self.n_cells = len(cells)
        self.n_nodes = len(coords)
        if cell_dofs is None:
            # DG layout: per-cell contiguous dofs, 4 points/cell
            cell_dofs = np.arange(self.n_cells * 4 * self.ncomp,
                                  dtype=np.int64).reshape(self.n_cells, -1)
        self.cell_dofs = np.asarray(cell_dofs, np.int64)
        self._meta = dict(coords=coords, cells=cells)

    def write(self, values, t):
        """values: flat (n_dofs,) or (n_points, ncomp) — stored flat."""
        import h5py

        vec = np.asarray(values, np.float64).reshape(-1, 1)
        with h5py.File(self.h5_path, "a") as f:
            g = f.create_group(f"{self.name}/{self.name}_{self.count}")
            g.create_dataset("vector", data=vec)
            if self.count == 0:
                g.create_dataset("cell_dofs",
                                 data=self.cell_dofs.reshape(-1))
                g.create_dataset(
                    "x_cell_dofs",
                    data=np.arange(self.n_cells + 1, dtype=np.int64)
                    * self.cell_dofs.shape[1])
                g.create_dataset("cells",
                                 data=np.arange(self.n_cells, dtype=np.int64))
                m = g.create_group("mesh")
                m.create_dataset("geometry", data=self._meta["coords"])
                m.create_dataset("topology", data=self._meta["cells"])
        self.entries.append((float(t), self.count))
        self.count += 1
        self._write_xdmf()

    def _write_xdmf(self):
        h5 = self.h5_path.name
        nc = self.n_cells
        parts = [_XDMF_HEADER.format(name=self.name)]
        for t, i in self.entries:
            parts.append(
                f"""      <Grid Name="{self.name}_{i}" GridType="Uniform">
        <Topology NumberOfElements="{nc}" TopologyType="Tetrahedron" NodesPerElement="4">
          <DataItem Dimensions="{nc} 4" NumberType="UInt" Format="HDF">{h5}:/{self.name}/{self.name}_0/mesh/topology</DataItem>
        </Topology>
        <Geometry GeometryType="XYZ">
          <DataItem Dimensions="{self.n_nodes} 3" Format="HDF">{h5}:/{self.name}/{self.name}_0/mesh/geometry</DataItem>
        </Geometry>
        <Time Value="{t}" />
        <Attribute Name="{self.name}" ItemType="FiniteElementFunction" ElementFamily="{self.family}" ElementDegree="{self.degree}" ElementCell="tetrahedron" Center="Other">
          <DataItem Dimensions="{nc} {self.cell_dofs.shape[1]}" NumberType="UInt" Format="HDF">{h5}:/{self.name}/{self.name}_0/cell_dofs</DataItem>
          <DataItem Dimensions="{self.cell_dofs.size} 1" Format="HDF">{h5}:/{self.name}/{self.name}_{i}/vector</DataItem>
        </Attribute>
      </Grid>
""")
        parts.append(_XDMF_FOOTER)
        self.xdmf_path.write_text("".join(parts))


class VisualizationOutput:
    """Writes d/v/p each save_step in the reference folder layout:
    <folder>/Visualization/{velocity,displacement,pressure}.{h5,xdmf}."""

    def __init__(self, folder, space, save_deg=2, restart=False):
        self.space = space
        self.save_deg = int(save_deg)
        viz = Path(folder) / "Visualization"
        mesh = space.mesh
        if self.save_deg == 2:
            refined = refine_uniform(mesh)
            coords, cells = refined.coords, refined.cells
            self.refined = refined
        else:
            coords, cells = mesh.coords, mesh.cells
            self.refined = None
        self.writers = {
            "velocity": VizWriter(viz, "velocity", coords, cells,
                                  vector=True, restart=restart),
            "displacement": VizWriter(viz, "displacement", coords, cells,
                                      vector=True, restart=restart),
            "pressure": VizWriter(viz, "pressure", coords, cells,
                                  vector=False, restart=restart),
        }

    def _p1_to_refined(self, p):
        """P1 field -> refined-mesh nodes (midpoints = edge averages)."""
        e = self.space.mesh.edges
        mid = 0.5 * (p[e[:, 0]] + p[e[:, 1]])
        return np.concatenate([p, mid], axis=0)

    def write(self, U, t):
        d, v, p = self.space.split(U.detach().cpu().numpy())
        if self.save_deg == 2:
            self.writers["velocity"].write(v, t)
            self.writers["displacement"].write(d, t)
            self.writers["pressure"].write(self._p1_to_refined(p), t)
        else:
            nn = self.space.mesh.num_vertices
            self.writers["velocity"].write(v[:nn], t)
            self.writers["displacement"].write(d[:nn], t)
            self.writers["pressure"].write(p, t)
