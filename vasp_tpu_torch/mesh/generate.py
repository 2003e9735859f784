"""Parametric FSI mesh generators (host-side, numpy).

Produces two-domain fluid+solid meshes with the reference pipeline's marker
conventions (reference: src/vasp/simulations/cylinder.py:46-51 and
src/vasp/preprocessing/preprocessing_common.py:123-197):

  cell markers:  fluid = 1, solid = 2
  facet markers: fluid inlet = 2, fluid outlet = 3,
                 solid inlet/outlet rings = 11,
                 FSI interface (interior facets) = 22,
                 solid outer wall = 33

Used by the test-suite and the benchmark instead of the reference's offline
VMTK/TetGen pipeline; sizes scale to millions of DOFs for multi-chip runs.

Construction: a disk cross-section (center fan + concentric rings of equal
point count) is extruded along z into triangular prisms, each split into 3
tets with the id-sorted "staircase" rule, which is conforming when every
triangle lists its vertices in ascending global id.
"""
import numpy as np

from vasp_tpu_torch.mesh.tetmesh import TetMesh


def _disk_points(n_theta, radii):
    """Center point + rings at given radii, n_theta points each."""
    pts = [np.zeros((1, 2))]
    for r in radii:
        th = 2 * np.pi * np.arange(n_theta) / n_theta
        pts.append(np.stack([r * np.cos(th), r * np.sin(th)], axis=1))
    return np.concatenate(pts, axis=0)


def _disk_triangles(n_theta, n_rings):
    """Triangulate center fan + ring strips. Returns (T,3) int array."""
    tris = []
    # center fan to ring 0 (points 1..n_theta)
    for i in range(n_theta):
        a = 1 + i
        b = 1 + (i + 1) % n_theta
        tris.append((0, a, b))
    # ring k to ring k+1 quad strips
    for k in range(n_rings - 1):
        base0 = 1 + k * n_theta
        base1 = 1 + (k + 1) * n_theta
        for i in range(n_theta):
            j = (i + 1) % n_theta
            a, b = base0 + i, base0 + j
            A, B = base1 + i, base1 + j
            tris.append((a, b, A))
            tris.append((b, B, A))
    return np.asarray(tris, dtype=np.int64)


def fsi_tube_mesh(
    r_inner: float = 0.001,
    r_outer: float = 0.0013,
    length: float = 0.006,
    n_theta: int = 16,
    n_r_fluid: int = 3,
    n_r_solid: int = 2,
    n_z: int = 12,
    radius_profile=None,
    center_offset=None,
) -> TetMesh:
    """Cylindrical FSI tube: fluid core (r <= r_inner) + solid wall annulus.

    Defaults approximate the reference's tiny cylinder test case scale
    (reference: tests/test_data/cylinder/cylinder.h5, ~1.6k cells).

    radius_profile: optional callable z -> scale factor applied to the whole
    cross-section (stenosis narrowing); center_offset: optional callable
    z -> (ox, oy) lateral shift of the cross-section (eccentric/offset
    stenoses, cf. the reference's offset_stenosis case)."""
    radii_f = r_inner * np.arange(1, n_r_fluid + 1) / n_r_fluid
    dr_s = (r_outer - r_inner) / n_r_solid
    radii_s = r_inner + dr_s * np.arange(1, n_r_solid + 1)
    radii = np.concatenate([radii_f, radii_s])
    pts2d = _disk_points(n_theta, radii)
    tris = _disk_triangles(n_theta, len(radii))
    n2d = len(pts2d)

    # 3D points: layers along z (optionally scaled/shifted per layer)
    zs = length * np.arange(n_z + 1) / n_z
    layers = []
    for z in zs:
        xy = pts2d.copy()
        if radius_profile is not None:
            xy = xy * float(radius_profile(z))
        if center_offset is not None:
            ox, oy = center_offset(z)
            xy = xy + np.array([ox, oy])[None, :]
        layers.append(np.concatenate([xy, np.full((n2d, 1), z)], axis=1))
    coords = np.concatenate(layers, axis=0)
    warped = radius_profile is not None or center_offset is not None

    # prisms -> tets (staircase split on ascending-id triangles)
    cells = []
    for layer in range(n_z):
        off0 = layer * n2d
        off1 = (layer + 1) * n2d
        t = np.sort(tris, axis=1)
        a, b, c = t[:, 0] + off0, t[:, 1] + off0, t[:, 2] + off0
        A, B, C = t[:, 0] + off1, t[:, 1] + off1, t[:, 2] + off1
        cells.append(np.stack([a, b, c, A], axis=1))
        cells.append(np.stack([b, c, A, B], axis=1))
        cells.append(np.stack([c, A, B, C], axis=1))
    cells = np.concatenate(cells, axis=0)

    # classification happens in the UNWARPED frame (straight tube)
    ref_coords = np.concatenate(
        [np.concatenate([pts2d, np.full((n2d, 1), z)], axis=1) for z in zs],
        axis=0,
    ) if warped else coords

    # cell markers by centroid radius
    cent = ref_coords[cells].mean(axis=1)
    rad = np.hypot(cent[:, 0], cent[:, 1])
    cell_markers = np.where(rad < r_inner, 1, 2).astype(np.int64)

    # facets from the full facet table
    mesh0 = TetMesh(ref_coords, cells, cell_markers)
    fv, c0, l0, c1, l1 = mesh0._facet_tables
    fc = ref_coords[fv].mean(axis=1)  # facet centroids
    fr = np.hypot(fc[:, 0], fc[:, 1])
    fz = fc[:, 2]
    tol = 1e-12 + 1e-6 * length
    # geometric radius of the interface/outer surfaces: the facet centroid of
    # a triangle on a circle of radius R lies slightly inside; classify by
    # comparing against the polygonal surface radius instead
    r_poly_in = _polygon_centroid_radius(r_inner, n_theta)
    r_poly_out = _polygon_centroid_radius(r_outer, n_theta)

    markers = np.zeros(len(fv), np.int64)
    exterior = c1 < 0
    on_z0 = np.abs(fz - 0.0) < tol
    on_zL = np.abs(fz - length) < tol
    # all three facet vertices on the interface cylinder?
    vr = np.hypot(ref_coords[fv][:, :, 0], ref_coords[fv][:, :, 1])
    on_iface = np.all(np.abs(vr - r_inner) < 1e-9 + 1e-6 * r_inner, axis=1)
    on_outer = np.all(np.abs(vr - r_outer) < 1e-9 + 1e-6 * r_outer, axis=1)

    markers[exterior & on_z0 & (fr < r_poly_in)] = 2  # inlet
    markers[exterior & on_zL & (fr < r_poly_in)] = 3  # outlet
    markers[exterior & (on_z0 | on_zL) & (fr >= r_poly_in)] = 11  # solid rings
    markers[exterior & on_outer] = 33  # outer wall
    markers[(~exterior) & on_iface] = 22  # FSI interface

    keep = markers > 0
    return TetMesh(coords, cells, cell_markers, fv[keep], markers[keep])


def _polygon_centroid_radius(r, n_theta):
    """A conservative radius threshold separating 'inside the ring polygon'
    facet centroids from ring-surface ones."""
    # chord midpoint radius of the polygon inscribed in circle r:
    return r * (2.0 + np.cos(np.pi / n_theta)) / 3.0 - 1e-12


def poiseuille_pipe_mesh(
    radius: float = 1.0,
    length: float = 5.0,
    n_theta: int = 16,
    n_r: int = 4,
    n_z: int = 16,
) -> TetMesh:
    """Fluid-only straight pipe (for the Hagen-Poiseuille WSS validation,
    reference: tests/test_compute_hemodynamics.py:16-73). Markers: inlet=2,
    outlet=3, wall=22."""
    radii = radius * np.arange(1, n_r + 1) / n_r
    pts2d = _disk_points(n_theta, radii)
    tris = _disk_triangles(n_theta, len(radii))
    n2d = len(pts2d)
    zs = length * np.arange(n_z + 1) / n_z
    coords = np.concatenate(
        [np.concatenate([pts2d, np.full((n2d, 1), z)], axis=1) for z in zs],
        axis=0,
    )
    cells = []
    for layer in range(n_z):
        off0 = layer * n2d
        off1 = (layer + 1) * n2d
        t = np.sort(tris, axis=1)
        a, b, c = t[:, 0] + off0, t[:, 1] + off0, t[:, 2] + off0
        A, B, C = t[:, 0] + off1, t[:, 1] + off1, t[:, 2] + off1
        cells.append(np.stack([a, b, c, A], axis=1))
        cells.append(np.stack([b, c, A, B], axis=1))
        cells.append(np.stack([c, A, B, C], axis=1))
    cells = np.concatenate(cells, axis=0)
    cell_markers = np.ones(len(cells), np.int64)

    mesh0 = TetMesh(coords, cells, cell_markers)
    fv, c0, l0, c1, l1 = mesh0._facet_tables
    fc = coords[fv].mean(axis=1)
    fz = fc[:, 2]
    tol = 1e-12 + 1e-6 * length
    markers = np.zeros(len(fv), np.int64)
    exterior = c1 < 0
    vr = np.hypot(coords[fv][:, :, 0], coords[fv][:, :, 1])
    on_wall = np.all(np.abs(vr - radius) < 1e-9 + 1e-6 * radius, axis=1)
    markers[exterior & (np.abs(fz) < tol)] = 2
    markers[exterior & (np.abs(fz - length) < tol)] = 3
    markers[exterior & on_wall] = 22
    keep = markers > 0
    return TetMesh(coords, cells, cell_markers, fv[keep], markers[keep])
