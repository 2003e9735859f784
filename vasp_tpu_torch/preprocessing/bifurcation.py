"""Bifurcated-vessel (Y-junction) FSI meshing.

Counterpart of vasp_tpu.preprocessing.bifurcation, the same host numpy
code: the parametric Y (template_specs, bifurcation_fsi_mesh and the
helpers they call) that -p avf meshes when it has no mesh file. The STL
path (branched_specs_from_stl, surface_bifurcation_mesh) is not ported
yet (ROADMAP.md queue 1, item 10).

The reference meshes branched anatomy with vmtk's branch extractor + mesh
branch clipper on top of a TetGen volume mesh
(reference: src/vasp/preprocessing/vmtkmeshgeneratorfsi.py:255-316, driver
multi-inlet handling preprocessing.py:336-384). Rebuilt here as a
STRUCTURED construction that XLA-era assembly likes (static block tables,
no unstructured Delaunay core):

1. Fluid lumen: square-to-disk O-grid cross sections extruded along each
   branch centerline. The parent's final cross-section grid splits EXACTLY
   into two structured half-blocks along a grid column, so each daughter
   tube continues from its half conformally (shared junction nodes) and
   morphs half-block -> full disk over a transition length.
2. Solid wall: extruded prism layers along smoothed outward normals of the
   assembled lumen wall surface — the vmtk boundaryLayer2 analogue — which
   handles the junction crotch (saddle) automatically and caps thickness
   against the opposing wall so the two daughter walls meet rather than
   cross.

Markers follow the project convention: cells fluid=1/solid=2, facets
inlet=2 / outlets=3 / solid end-rings=11 / FSI interface=22 / outer
wall=33. With branch_ids_offset (reference --branch-ids-offset, default
1000) the second daughter's SOLID cells get 2+offset — the reference's
branch-marking contract for per-branch solid properties.
"""
from dataclasses import dataclass
from typing import Optional

import numpy as np

from vasp_tpu_torch.mesh.tetmesh import TetMesh


# ---------------------------------------------------------------- 2D grids
def square_to_disk(x, y):
    """Elliptical square-to-disk map: [-1,1]^2 -> unit disk (boundary of
    the square -> unit circle), smooth and bijective."""
    return (x * np.sqrt(np.maximum(1.0 - 0.5 * y * y, 0.0)),
            y * np.sqrt(np.maximum(1.0 - 0.5 * x * x, 0.0)))


def grid_tris(ni, nj):
    """Consistent triangulation of an (ni+1)x(nj+1) structured grid
    (node id = i*(nj+1)+j). Every quad splits along the same diagonal, so
    any sub-block's triangulation equals the restriction of the full
    grid's."""
    i, j = np.meshgrid(np.arange(ni), np.arange(nj), indexing="ij")
    v00 = (i * (nj + 1) + j).ravel()
    v01 = v00 + 1
    v10 = v00 + (nj + 1)
    v11 = v10 + 1
    t1 = np.stack([v00, v10, v11], axis=1)
    t2 = np.stack([v00, v11, v01], axis=1)
    return np.concatenate([t1, t2], axis=0)


def boundary_cycle(ni, nj):
    """Boundary node ids of the (ni+1)x(nj+1) grid in one closed CCW walk
    (i fastest on the j=0 edge)."""
    ids = []
    ids += [i * (nj + 1) for i in range(ni + 1)]             # j = 0 edge
    ids += [ni * (nj + 1) + j for j in range(1, nj + 1)]     # i = ni edge
    ids += [i * (nj + 1) + nj for i in range(ni - 1, -1, -1)]  # j = nj
    ids += [j for j in range(nj - 1, 0, -1)]                 # i = 0 edge
    return np.asarray(ids, np.int64)


def extrude_prisms(tris_bot, tris_top_offset, cells_out):
    """Split the prisms between two triangulated layers into tets with the
    sorted-index rule (conforming across shared quad faces)."""
    t = np.sort(tris_bot, axis=1)
    a, b, c = t[:, 0], t[:, 1], t[:, 2]
    A, B, C = (x + tris_top_offset for x in (a, b, c))
    cells_out.append(np.stack([a, b, c, A], axis=1))
    cells_out.append(np.stack([b, c, A, B], axis=1))
    cells_out.append(np.stack([c, A, B, C], axis=1))


def extrude_prisms_mapped(tris, bot_ids, top_ids, cells_out):
    """Same as extrude_prisms with explicit bottom/top node id maps.

    The sorted-index rule must see GLOBAL ids that preserve the relative
    order used by neighbouring layers, so sort on the bottom ids (globally
    consistent: bottom ids come from one contiguous layer)."""
    order = np.argsort(bot_ids[tris], axis=1)
    t_bot = np.take_along_axis(bot_ids[tris], order, axis=1)
    t_top = np.take_along_axis(top_ids[tris], order, axis=1)
    a, b, c = t_bot[:, 0], t_bot[:, 1], t_bot[:, 2]
    A, B, C = t_top[:, 0], t_top[:, 1], t_top[:, 2]
    cells_out.append(np.stack([a, b, c, A], axis=1))
    cells_out.append(np.stack([b, c, A, B], axis=1))
    cells_out.append(np.stack([c, A, B, C], axis=1))


def _frames(tangent, ref_e1):
    t = tangent / max(np.linalg.norm(tangent), 1e-30)
    e1 = ref_e1 - np.dot(ref_e1, t) * t
    n = np.linalg.norm(e1)
    if n < 1e-9:
        ref = np.array([0.0, 0.0, 1.0])
        e1 = ref - np.dot(ref, t) * t
        n = np.linalg.norm(e1)
    e1 /= n
    return e1, np.cross(t, e1), t


# ---------------------------------------------------------- fluid lumen
@dataclass
class BranchSpec:
    """Geometry of one branch: sampled centerline + radius per station."""

    centers: np.ndarray            # (n+1, 3)
    radii: np.ndarray              # (n+1,)
    e1: Optional[np.ndarray] = None   # (n+1, 3) in-plane frame (optional)


def _resample_branch(spec: BranchSpec, n_layers):
    s = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(spec.centers, axis=0), axis=1))])
    snew = np.linspace(0.0, s[-1], n_layers + 1)
    c = np.stack([np.interp(snew, s, spec.centers[:, k]) for k in range(3)],
                 axis=1)
    r = np.interp(snew, s, spec.radii)
    return c, r


def bifurcation_fluid_mesh(parent: BranchSpec, d1: BranchSpec,
                           d2: BranchSpec, m=8, n_parent=8, n_daughter=10,
                           trans_frac=0.5):
    """Conforming structured fluid lumen of a Y junction.

    m: cross-section grid divisions (even; (m+1)^2 nodes per parent layer).
    The parent's last layer splits along its central grid column into two
    (m/2+1)x(m+1) half-blocks; daughter k's layer-0 nodes ARE its half
    (shared ids), then its own layers morph the half-block shape into a
    full disk over trans_frac of its length while the centerline diverges.

    Returns (coords, cells, meta) with meta holding node-id tables the
    marker/solid stages need."""
    assert m % 2 == 0 and m >= 4
    h = m // 2

    # parent grid: (m+1)x(m+1), x = separation axis (daughter 1 -> -x)
    xs = np.linspace(-1.0, 1.0, m + 1)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    px, py = square_to_disk(gx, gy)

    cp, rp = _resample_branch(parent, n_parent)
    tang_p = cp[-1] - cp[-2]
    # one parallel-transported frame family for the parent
    e1p, e2p, tp = _frames(cp[1] - cp[0], np.array([1.0, 0.0, 0.0]))

    coords = []
    n2d = (m + 1) * (m + 1)
    for k in range(n_parent + 1):
        if k + 1 <= n_parent:
            tk = cp[min(k + 1, n_parent)] - cp[max(k - 1, 0)]
        else:
            tk = tang_p
        e1k, e2k, _ = _frames(tk, e1p)
        layer = (cp[k][None, :]
                 + rp[k] * (px.ravel()[:, None] * e1k[None, :]
                            + py.ravel()[:, None] * e2k[None, :]))
        coords.append(layer)
    coords = list(coords)

    tris_full = grid_tris(m, m)
    cells = []
    for k in range(n_parent):
        tb = tris_full + k * n2d
        extrude_prisms(tb, n2d, cells)

    # junction layer global ids (parent layer n_parent)
    off_j = n_parent * n2d

    def gid_parent(i, j):
        return off_j + i * (m + 1) + j

    next_free = (n_parent + 1) * n2d

    # daughter construction
    meta = dict(m=m, n2d=n2d, n_parent=n_parent,
                parent_inlet=np.arange(n2d),
                daughters=[])
    e1_junction, e2_junction, t_junction = _frames(tang_p, e1p)

    for side, spec in ((0, d1), (1, d2)):
        cd, rd = _resample_branch(spec, n_daughter)
        nT = max(2, int(round(trans_frac * n_daughter)))
        # daughter grid: (h+1) x (m+1); local x in [0,1] maps from the
        # parent half (side 0: parent x in [-1,0] reversed so local x=0 is
        # the chord; side 1: parent x in [0,1])
        nd2d = (h + 1) * (m + 1)
        # layer 0 node ids = parent half-block ids. The id map must be
        # ORDER-PRESERVING in (i, j): the sorted-index prism split and the
        # fixed-diagonal grid triangulation then restrict EXACTLY to the
        # parent's junction-disk triangulation (an i-reversed map flips
        # the quad diagonals and leaves sliver cracks at the junction —
        # found as spurious exterior facets in the junction plane).
        i0 = 0 if side == 0 else h
        ids0 = np.empty((h + 1, m + 1), np.int64)
        for i in range(h + 1):
            for j in range(m + 1):
                ids0[i, j] = gid_parent(i0 + i, j)
        # half-block shape in PARENT map coordinates (side 0: x in [-1,0],
        # side 1: x in [0,1]; chord at x=0), then recentred on its own
        # centroid so the morph blends around the daughter centerline
        sgn = -1.0 if side == 0 else 1.0
        xs_sub = xs[i0:i0 + h + 1]
        gu, gv = np.meshgrid(xs_sub, xs, indexing="ij")
        hx, hy = square_to_disk(gu, gv)
        hx0 = hx - hx.mean()
        # full-disk target shape over the same anisotropic grid
        uu = np.linspace(-1.0, 1.0, h + 1)
        gU, gV = np.meshgrid(uu, xs, indexing="ij")
        fx, fy = square_to_disk(gU, gV)
        if side == 0:
            # outer flank at local i=0 maps to disk x=-1 already; keep the
            # chord (i=h) morphing toward disk x=+1 so the daughter's
            # local orientation is continuous with the half shape
            pass

        sgn_dir = sgn  # daughter separates along +-e1
        dir0 = cd[1] - cd[0]
        e1d, e2d, td = _frames(dir0, e1_junction)
        # continuity at s=0: the morph starts from EXACTLY the parent
        # half-block (parent radius, centroid offset along e1)
        half_off = float(rp[-1] * hx.mean())
        layer_ids = [ids0]
        for k in range(1, n_daughter + 1):
            s = min(k / nT, 1.0)
            bx = (1 - s) * hx0 + s * fx
            by = (1 - s) * hy + s * fy
            rk = (1 - s) * rp[-1] + s * rd[k]
            ck = cd[k] + (1 - s) * half_off * e1_junction
            if k + 1 <= n_daughter:
                tk = cd[min(k + 1, n_daughter)] - cd[max(k - 1, 0)]
            else:
                tk = cd[-1] - cd[-2]
            e1k, e2k, _ = _frames(tk, e1d)
            # the junction-side layers stay aligned with the parent frame
            e1k = (1 - s) * e1_junction + s * e1k
            e2k = (1 - s) * e2_junction + s * e2k
            e1k /= max(np.linalg.norm(e1k), 1e-30)
            e2k -= np.dot(e2k, e1k) * e1k
            e2k /= max(np.linalg.norm(e2k), 1e-30)
            layer = (ck[None, :]
                     + rk * (bx.ravel()[:, None] * e1k[None, :]
                             + by.ravel()[:, None] * e2k[None, :]))
            coords.append(layer)
            ids = np.arange(next_free, next_free + nd2d).reshape(
                h + 1, m + 1)
            next_free += nd2d
            layer_ids.append(ids)

        tris_half = grid_tris(h, m)
        for k in range(n_daughter):
            bot = layer_ids[k].ravel()
            top = layer_ids[k + 1].ravel()
            extrude_prisms_mapped(tris_half, bot, top, cells)
        meta["daughters"].append(dict(
            side=side, sgn=sgn_dir, layer_ids=layer_ids,
            outlet=layer_ids[-1].ravel(), h=h))

    coords = np.concatenate(coords, axis=0)
    cells = np.concatenate(cells, axis=0)
    return coords, cells, meta


# ------------------------------------------------------- solid extrusion
def extrude_solid_shell(coords, cells, wall_tris, thickness, n_r_solid=2,
                        n_smooth=8):
    """Prism-extruded solid wall on the lumen surface (the vmtk
    boundaryLayer2 analogue, vmtkmeshgeneratorfsi.py:226-248): n_r_solid
    layers along smoothed outward vertex normals of `wall_tris`, with the
    per-vertex thickness capped at 45% of the distance to the nearest
    non-neighbour wall vertex (junction crotch: the two daughter walls
    meet instead of crossing).

    Returns (coords_out, solid_cells, wall_vert_ids, outer_vert_of) where
    outer_vert_of maps a wall vertex id to its outermost solid vertex."""
    from scipy.spatial import cKDTree

    wall_vs = np.unique(wall_tris)
    loc = np.full(coords.shape[0], -1, np.int64)
    loc[wall_vs] = np.arange(len(wall_vs))

    # area-weighted outward vertex normals
    e0 = coords[wall_tris[:, 1]] - coords[wall_tris[:, 0]]
    e1 = coords[wall_tris[:, 2]] - coords[wall_tris[:, 0]]
    fn = np.cross(e0, e1)  # oriented by caller (outward)
    vn = np.zeros((len(wall_vs), 3))
    for c in range(3):
        np.add.at(vn, loc[wall_tris[:, c]], fn)
    # Laplacian-smooth the normal field (stabilizes the crotch saddle)
    nbr_i = np.concatenate([loc[wall_tris[:, 0]], loc[wall_tris[:, 1]],
                            loc[wall_tris[:, 2]]])
    nbr_j = np.concatenate([loc[wall_tris[:, 1]], loc[wall_tris[:, 2]],
                            loc[wall_tris[:, 0]]])
    for _ in range(n_smooth):
        acc = np.zeros_like(vn)
        cnt = np.zeros(len(wall_vs))
        np.add.at(acc, nbr_i, vn[nbr_j])
        np.add.at(cnt, nbr_i, 1.0)
        vn = 0.5 * vn + 0.5 * acc / np.maximum(cnt, 1.0)[:, None]
        vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-30)

    th = np.broadcast_to(np.asarray(thickness, float), (len(wall_vs),)) \
        .copy()
    # crotch guard: cap thickness where an OPPOSING wall is near. Opposing
    # = a wall vertex that is close in space but far along the surface;
    # approximate "far along the surface" by requiring the normals to
    # disagree (the two crotch flanks face each other).
    tree = cKDTree(coords[wall_vs])
    pairs = tree.query_pairs(r=float(np.max(th)) * 2.2, output_type="ndarray")
    th_floor = 0.2 * th  # keep a thin but non-degenerate crotch wedge
    if len(pairs):
        a, b = pairs[:, 0], pairs[:, 1]
        facing = np.einsum("ki,ki->k", vn[a], vn[b]) < -0.2
        d = np.linalg.norm(coords[wall_vs[a]] - coords[wall_vs[b]], axis=1)
        for i_arr, d_arr in ((a[facing], d[facing]), (b[facing], d[facing])):
            np.minimum.at(th, i_arr, 0.45 * d_arr)
        th = np.maximum(th, th_floor)

    n0 = coords.shape[0]
    new_layers = []
    layer_ids = [wall_vs]
    for k in range(1, n_r_solid + 1):
        new_layers.append(coords[wall_vs] + vn * (th * k / n_r_solid)[:, None])
        layer_ids.append(np.arange(n0 + (k - 1) * len(wall_vs),
                                   n0 + k * len(wall_vs)))
    coords_out = np.concatenate([coords] + new_layers, axis=0)

    solid_cells = []
    ltris = loc[wall_tris]
    for k in range(n_r_solid):
        bot = layer_ids[k]
        top = layer_ids[k + 1]
        extrude_prisms_mapped(ltris, bot, top, solid_cells)
    solid_cells = np.concatenate(solid_cells, axis=0)
    outer_of = dict(zip(wall_vs.tolist(), layer_ids[-1].tolist()))
    return coords_out, solid_cells, wall_vs, layer_ids


def _orient_outward(coords, cells, tris):
    """Orient boundary triangles so their normal points OUT of the owning
    tet (standard boundary orientation)."""
    from vasp_tpu_torch.mesh.tetmesh import TetMesh as _TM

    mesh = _TM(coords, cells, np.ones(len(cells), np.int64))
    fv, c0, l0, c1, l1 = mesh._facet_tables
    ext = c1 < 0
    key = {}
    for row, cell in zip(fv[ext], c0[ext]):
        key[tuple(sorted(row))] = int(cell)
    out = []
    for tri in tris:
        cell = key[tuple(sorted(tri))]
        centroid = coords[cells[cell]].mean(axis=0)
        e0 = coords[tri[1]] - coords[tri[0]]
        e1 = coords[tri[2]] - coords[tri[0]]
        n = np.cross(e0, e1)
        # outward = away from the owning cell's centroid
        if np.dot(n, centroid - coords[tri[0]]) > 0:
            tri = tri[[0, 2, 1]]
        out.append(tri)
    return np.asarray(out)


# ------------------------------------------------------------- assembly
def bifurcation_fsi_mesh(parent: BranchSpec, d1: BranchSpec, d2: BranchSpec,
                         m=8, n_parent=8, n_daughter=10, trans_frac=0.5,
                         thickness_frac=0.25, solid_thickness=None,
                         n_r_solid=2, scale_factor=1.0,
                         branch_ids_offset=0) -> TetMesh:
    """Two-domain FSI mesh of a bifurcation (markers per project
    convention; see module docstring). branch_ids_offset > 0 marks the
    SECOND daughter's solid cells 2 + offset (reference
    vmtkmeshgeneratorfsi.py:255-316 branch clipping contract)."""
    coords, fcells, meta = bifurcation_fluid_mesh(
        parent, d1, d2, m=m, n_parent=n_parent, n_daughter=n_daughter,
        trans_frac=trans_frac)

    mesh0 = TetMesh(coords, fcells,
                    np.ones(len(fcells), np.int64))
    fv, c0, l0, c1, l1 = mesh0._facet_tables
    ext = c1 < 0
    ext_tris = fv[ext]

    inlet_set = set(meta["parent_inlet"].tolist())
    outlet_sets = [set(d["outlet"].tolist()) for d in meta["daughters"]]

    def all_in(tris, s):
        return np.array([all(v in s for v in row) for row in tris])

    is_inlet = all_in(ext_tris, inlet_set)
    is_out = np.zeros(len(ext_tris), bool)
    for s in outlet_sets:
        is_out |= all_in(ext_tris, s)
    wall_tris = ext_tris[~(is_inlet | is_out)]
    wall_tris = _orient_outward(coords, fcells, wall_tris)

    if solid_thickness is not None:
        thick = float(solid_thickness)
    else:
        rbar = float(np.mean(parent.radii))
        thick = thickness_frac * rbar
    coords2, scells, wall_vs, slayer_ids = extrude_solid_shell(
        coords, fcells, wall_tris, thick, n_r_solid=n_r_solid)

    cells = np.concatenate([fcells, scells], axis=0)
    cell_markers = np.concatenate([
        np.ones(len(fcells), np.int64), 2 * np.ones(len(scells), np.int64)])

    if branch_ids_offset:
        # second daughter's solid cells: nearest daughter-2 lumen layer
        d2ids = np.concatenate(
            [ids.ravel() for ids in meta["daughters"][1]["layer_ids"][1:]])
        d2set = set(d2ids.tolist())
        # solid cells whose base wall vertex belongs to daughter 2
        base = {}
        for k, ids in enumerate(slayer_ids):
            for v_wall, v_lay in zip(slayer_ids[0], ids):
                base[int(v_lay)] = int(v_wall)
        sc_off = np.array([
            any(base.get(int(v), -1) in d2set for v in row)
            for row in scells])
        cell_markers[len(fcells):][sc_off] += int(branch_ids_offset)

    # facet markers on the combined mesh
    mesh1 = TetMesh(coords2, cells, cell_markers)
    fv1, c0a, l0a, c1a, l1a = mesh1._facet_tables
    ext1 = c1a < 0
    inlet_arr = np.fromiter(inlet_set, np.int64)
    markers = []
    facets = []

    # fluid end facets (inlet/outlets) re-detected on the combined mesh
    tris1 = fv1[ext1]
    own_marker = cell_markers[c0a[ext1]]
    in1 = all_in(tris1, inlet_set) & (own_marker == 1)
    facets.append(tris1[in1])
    markers.append(np.full(in1.sum(), 2, np.int64))
    for s in outlet_sets:
        o1 = all_in(tris1, s) & (own_marker == 1)
        facets.append(tris1[o1])
        markers.append(np.full(o1.sum(), 3, np.int64))

    # FSI interface: interior facets between fluid and solid cells
    intr = (c1a >= 0)
    both = intr & (
        (np.minimum(cell_markers[c0a], np.where(intr, cell_markers[c1a], 0))
         % 1000 == 1)
        & (np.maximum(cell_markers[c0a],
                      np.where(intr, cell_markers[c1a], 0)) % 1000 == 2))
    facets.append(fv1[both])
    markers.append(np.full(both.sum(), 22, np.int64))

    # solid exterior: ends (11) vs outer wall (33). End facets lie in the
    # inlet/outlet planes: every vertex is an end-ring wall vertex or one
    # of its extruded copies.
    ring_vs = set()
    for s in [inlet_set] + outlet_sets:
        ring_vs |= (s & set(wall_vs.tolist()))
    ring_ext = set()
    wall_index = {int(v): k for k, v in enumerate(slayer_ids[0])}
    for v in ring_vs:
        k = wall_index[int(v)]
        for ids in slayer_ids:
            ring_ext.add(int(ids[k]))
    sol_ext = ext1 & (cell_markers[c0a] % 1000 == 2)
    tris_s = fv1[sol_ext]
    is_end = all_in(tris_s, ring_ext)
    facets.append(tris_s[is_end])
    markers.append(np.full(is_end.sum(), 11, np.int64))
    facets.append(tris_s[~is_end])
    markers.append(np.full((~is_end).sum(), 33, np.int64))

    facets = np.concatenate(facets, axis=0)
    markers = np.concatenate(markers, axis=0)
    coords2 = coords2 * float(scale_factor)
    return TetMesh(coords2, cells, cell_markers, facets, markers)


def template_specs(r_parent=0.002, r_d1=0.0016, r_d2=0.0016,
                   l_parent=0.01, l_daughter=0.012, angle_deg=35.0,
                   n_samp=20):
    """Parametric symmetric-Y branch specs (surrogate geometry for tests
    and the AVF/bifurcation template path)."""
    t = np.linspace(0.0, 1.0, n_samp + 1)[:, None]
    z = np.array([0.0, 0.0, 1.0])
    parent = BranchSpec(centers=t * l_parent * z,
                        radii=np.full(n_samp + 1, r_parent))
    a = np.deg2rad(angle_deg)
    p0 = l_parent * z
    specs = []
    tt = t.ravel()
    for sgn, r in ((-1.0, r_d1), (1.0, r_d2)):
        # diverge at the full branch angle IMMEDIATELY (sharp-Y template):
        # a tangential start leaves the junction crotch gap opening at
        # O(step^2), which produces sliver solid cells between the nearly
        # coincident daughter walls; the immediate kink opens it at
        # O(step)
        d = np.array([sgn * np.sin(a), 0.0, np.cos(a)])
        # mild straightening far downstream keeps outlets parallel-ish
        dirs = (1 - 0.5 * tt)[:, None] * d[None, :] \
            + (0.5 * tt)[:, None] * z[None, :]
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        step = l_daughter / n_samp
        cs = [p0]
        for k in range(n_samp):
            cs.append(cs[-1] + step * dirs[k + 1])
        specs.append(BranchSpec(centers=np.asarray(cs),
                                radii=np.full(n_samp + 1, r)))
    return parent, specs[0], specs[1]
