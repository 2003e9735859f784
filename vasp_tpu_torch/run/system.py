"""FSISystem: build the monolithic FSI operator from a config dict.

Counterpart of vasp_tpu.run.system (turtleFSI's internal setup: mixed
space, fluid / solid / extrapolation forms, Robin BC), driven by the same
configuration vocabulary the reference's problem files use
(SURVEY.md §2.3): dx_f_id / mu_f lists for multi-viscosity zones
(reference: src/vasp/simulations/offset_stenosis.py:59-61), solid_properties
dicts per solid subdomain, St.Venant-Kirchhoff or Mooney-Rivlin
(reference: src/vasp/simulations/avf.py:76-80), robin_bc/k_s/c_s/ds_s_id
(reference: src/vasp/simulations/aneurysm.py:73-76), and the mesh lifting
``extrapolation`` (laplace, elastic, no_extrapolation, or biharmonic with
sub-type bc1/bc2 and ``biharmonic_beta``; SURVEY.md:160-163), ``p_stab``
and ``gravity``.
Blocks are built on the device named by the config key ``device``
(default "cuda").

linear_solver "gmres", "iterative" and "ras" select the Newton-Krylov
solver (fem/timestepper.py), configured from the same keys and defaults as
vasp_tpu's make_solver, its preconditioner by the key "precond" ("banded",
the default, or "ras", with "ras_overlap"); "mumps" and "lu" the host-LU
Newton solver (fem/solver.py), and any other value (e.g. "krylov") that
solver's Krylov branch (element-block additive Schwarz and GMRES), as in
vasp_tpu.

Not ported yet, and refused with the ROADMAP item that will port it:
n_devices > 1 (queue 1, item 13); fem/timestepper.py refuses the
iterative options it does not cover.
"""
import dataclasses

import numpy as np
import torch

from vasp_tpu_torch.device import resolve_device
from vasp_tpu_torch.fem.assembly import (
    Assembler,
    CellBlock,
    FacetBlock,
    cell_geometry,
)
from vasp_tpu_torch.fem.biharmonic import build_biharmonic
from vasp_tpu_torch.fem.dirichlet import BCSet, DirichletBC
from vasp_tpu_torch.fem.forms import (
    interface_pressure_vector,
    make_fluid_kernel,
    make_robin_kernel,
    make_solid_kernel,
)
from vasp_tpu_torch.fem.functionspace import DVPSpace
from vasp_tpu_torch.fem.solver import NewtonOptions, NewtonSolver
from vasp_tpu_torch.fem.timestepper import (
    IterativeNewtonSolver,
    StepOptions,
    not_ported as _not_ported,
)

_SINGLE_DEVICE = (None, "None", "", 0, 1, "1")


def normalize_fluid_properties(cfg):
    if cfg.get("fluid_properties"):
        props = cfg["fluid_properties"]
        return props if isinstance(props, list) else [props]
    ids = np.atleast_1d(cfg.get("dx_f_id", 1)).tolist()
    mus = cfg.get("mu_f", 1.0)
    rhos = cfg.get("rho_f", 1.0)
    mus = mus if isinstance(mus, (list, tuple)) else [mus] * len(ids)
    rhos = rhos if isinstance(rhos, (list, tuple)) else [rhos] * len(ids)
    return [
        {"dx_f_id": i, "rho_f": r, "mu_f": m} for i, r, m in zip(ids, rhos, mus)
    ]


def normalize_solid_properties(cfg):
    if cfg.get("solid") == "no_solid":
        return []
    props = cfg.get("solid_properties")
    if props:
        return props if isinstance(props, list) else [props]
    ids = np.atleast_1d(cfg.get("dx_s_id", 2)).tolist()
    out = []
    for k, i in enumerate(ids):
        def pick(key, default=None):
            val = cfg.get(key, default)
            if isinstance(val, (list, tuple)):
                return val[k]
            return val
        out.append(
            {
                "dx_s_id": i,
                "material_model": pick("material_model", "StVenantKirchoff"),
                "rho_s": pick("rho_s", 1e3),
                "mu_s": pick("mu_s"),
                "lambda_s": pick("lambda_s"),
                "C01": pick("C01"),
                "C10": pick("C10"),
                "C11": pick("C11"),
            }
        )
    return out


class FSISystem:
    """Monolithic DVP system on a TetMesh, configured like the reference."""

    def __init__(self, mesh, cfg):
        self.mesh = mesh
        self.cfg = dict(cfg)
        self.device = resolve_device(cfg.get("device", "cuda"))
        if cfg.get("n_devices") not in _SINGLE_DEVICE:
            _not_ported(f"n_devices={cfg['n_devices']!r}", 13)
        self.space = DVPSpace(mesh)
        space = self.space
        dev = self.device
        dt = float(cfg["dt"])
        theta = float(cfg.get("theta", 0.501))
        qd = int(cfg.get("quadrature_degree", 6))

        Jinv, detJ, vol = cell_geometry(mesh.coords, mesh.cells)
        self._geom = (Jinv, detJ, vol)

        def f64(a):
            return torch.as_tensor(a, dtype=torch.float64, device=dev)

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        lift = cfg.get("extrapolation", "laplace")
        lift_sub = cfg.get("extrapolation_sub_type", "constant")
        lift_coeff = 1.0
        if lift == "laplace" and lift_sub == "small_constant":
            lift_coeff = 0.01 * mesh.hmin ** 2
        self.lift = None
        if lift == "biharmonic":
            # the correction's tables first: the element kernels carry
            # beta*gamma*L, the spectral surrogate of the true beta
            # L M^-1 L block, so that the element-Jacobian preconditioners
            # see the right d-block magnitude (fem/biharmonic.py); beta=1
            # is vasp_tpu's validated default, tunable by biharmonic_beta
            beta = float(cfg.get("biharmonic_beta", 1.0))
            self.lift = build_biharmonic(
                mesh, space, np.atleast_1d(cfg.get("dx_f_id", 1)).tolist(),
                sub_type=lift_sub, quad_degree=min(qd, 3), beta=beta,
                device=dev)
            lift_coeff = float(self.lift["beta_gamma"])

        blocks = []
        self.fluid_props = normalize_fluid_properties(cfg)
        self.solid_props = normalize_solid_properties(cfg)

        dofs_mixed = space.cell_dofs_mixed
        # d-dofs that carry the solid KINEMATIC equation (d-dot = v): every
        # d-dof owned by a solid cell. The fluid mesh-lifting form must not
        # contribute to those rows (see CellBlock.rowmask; the reference
        # stack's equivalent is turtleFSI's delta=1e10 kinematic weight).
        solid_sel_all = [np.nonzero(mesh.cell_markers == sp["dx_s_id"])[0]
                         for sp in self.solid_props]
        if solid_sel_all and sum(len(s) for s in solid_sel_all):
            kin_d = np.unique(
                dofs_mixed[np.concatenate(solid_sel_all)][:, :30])
        else:
            kin_d = np.empty(0, np.int64)

        for fp in self.fluid_props:
            sel = np.nonzero(mesh.cell_markers == fp["dx_f_id"])[0]
            if len(sel) == 0:
                continue
            kern = make_fluid_kernel(
                rho_f=float(fp["rho_f"]),
                mu_f=float(fp["mu_f"]),
                dt=dt,
                theta=theta,
                lift=lift,
                lift_sub=lift_sub,
                lift_coeff=lift_coeff,
                quad_degree=qd,
                p_stab=float(cfg.get("p_stab", 0.0)),
            )
            rowmask = None
            if len(kin_d):
                bd = dofs_mixed[sel]
                rm = np.ones(bd.shape, np.float64)
                rm[:, :30] = (~np.isin(bd[:, :30], kin_d)).astype(np.float64)
                if (rm == 0.0).any():
                    rowmask = f64(rm)
            blocks.append(CellBlock(
                name=f"fluid_{fp['dx_f_id']}", kernel=kern,
                dofs=i64(dofs_mixed[sel]), Jinv=f64(Jinv[sel]),
                detJ=f64(detJ[sel]), vol=f64(vol[sel]), rowmask=rowmask))
        for sp in self.solid_props:
            sel = np.nonzero(mesh.cell_markers == sp["dx_s_id"])[0]
            if len(sel) == 0:
                continue
            kern = make_solid_kernel(
                props={k: v for k, v in sp.items() if v is not None},
                dt=dt,
                theta=theta,
                gravity=cfg.get("gravity"),
                quad_degree=qd,
            )
            blocks.append(CellBlock(
                name=f"solid_{sp['dx_s_id']}", kernel=kern,
                dofs=i64(dofs_mixed[sel]), Jinv=f64(Jinv[sel]),
                detJ=f64(detJ[sel]), vol=f64(vol[sel])))

        if cfg.get("robin_bc"):
            blocks += self._robin_blocks(cfg, qd, f64, i64)
        self.assembler = Assembler(space.ndof, blocks)

    def _robin_blocks(self, cfg, qd, f64, i64):
        """The Robin facet blocks of the solid's outer wall (tissue
        support k_s d + c_s v): one per marker of ds_s_id, with k_s and c_s
        given per marker or as one scalar for all; local dofs [d 18, v 18]
        of each P2 triangle, its vertices sorted."""
        mesh, space = self.mesh, self.space
        ds_ids = np.atleast_1d(cfg["ds_s_id"]).tolist()
        k_list, c_list = cfg["k_s"], cfg["c_s"]
        if not isinstance(k_list, (list, tuple)):
            k_list = [k_list] * len(ds_ids)
        if not isinstance(c_list, (list, tuple)):
            c_list = [c_list] * len(ds_ids)
        blocks = []
        for ds_id, k_s, c_s in zip(ds_ids, k_list, c_list):
            fv = mesh.exterior_facets(ds_id)[0]
            if len(fv) == 0:
                continue
            fv_sorted = np.sort(fv.astype(np.int64), axis=1)
            x = mesh.coords[fv_sorted]
            area2 = np.linalg.norm(
                np.cross(x[:, 1] - x[:, 0], x[:, 2] - x[:, 0]), axis=1)
            p2d = space.facet_dofs_p2(fv_sorted).reshape(-1)  # (K*6,)
            d_idx = space.field_dofs("d", p2d).reshape(-1, 18)
            v_idx = space.field_dofs("v", p2d).reshape(-1, 18)
            blocks.append(FacetBlock(
                name=f"robin_{ds_id}",
                kernel=make_robin_kernel(float(k_s), float(c_s), qd),
                dofs=i64(np.concatenate([d_idx, v_idx], axis=1)),
                area2=f64(area2)))
        return blocks

    # -------------- interface pressure load --------------
    def interface_pressure_load(self, fsi_id=None):
        """Geometry vector b with R_v += P(t) * b on the FSI interface
        (reference: src/vasp/simulations/cylinder.py:164-169), a float64
        tensor on the run's device."""
        cfg = self.cfg
        fsi_id = fsi_id if fsi_id is not None else cfg.get("fsi_id", 22)
        fv, cp, lp, cm, lm = self.mesh.interior_facets(fsi_id)
        fv_sorted = np.sort(fv.astype(np.int64), axis=1)
        p2d = self.space.facet_dofs_p2(fv_sorted)
        b = interface_pressure_vector(
            self.space, fv_sorted, cp, p2d,
            quad_degree=int(cfg.get("quadrature_degree", 6)),
        )
        return torch.as_tensor(b, dtype=torch.float64, device=self.device)

    # -------------- standard auto BCs --------------
    def auto_pressure_pin_bcs(self):
        """Pin pressure dofs with no equation: P1 dofs strictly interior to
        the solid (continuity only lives on the fluid)."""
        if not self.solid_props or not self.fluid_props:
            return []
        f_ids = [fp["dx_f_id"] for fp in self.fluid_props]
        s_ids = [sp["dx_s_id"] for sp in self.solid_props]
        pdofs = self.space.solid_only_pressure_dofs(f_ids, s_ids)
        if len(pdofs) == 0:
            return []
        return [DirichletBC(self.space.pressure_dofs(pdofs), 0.0)]

    def make_bcset(self, bcs, auto_pin_pressure=True):
        bcs = list(bcs)
        if auto_pin_pressure:
            bcs += self.auto_pressure_pin_bcs()
        return BCSet(self.space.ndof, bcs)

    def make_solver(self, bc_set, **opts):
        cfg = self.cfg
        lin = cfg.get("linear_solver", "lu")
        if lin in ("gmres", "iterative", "ras"):
            return self._make_iterative_solver(bc_set, **opts)
        options = NewtonOptions(
            atol=float(cfg.get("atol", 1e-7)),
            rtol=float(cfg.get("rtol", 1e-7)),
            max_it=int(cfg.get("max_it", 50)),
            lmbda=float(cfg.get("lmbda", 1.0)),
            recompute=int(cfg.get("recompute", 5)),
            recompute_tstep=int(cfg.get("recompute_tstep", 1)),
            # reference configs say "mumps": the host direct-LU path is the
            # drop-in equivalent (reference: offset_stenosis.py:44)
            linear_solver={"mumps": "lu"}.get(lin, lin),
            verbose=bool(cfg.get("verbose", True)),
            raise_on_fail=bool(cfg.get("raise_on_fail", True)),
        )
        for k, v in opts.items():
            setattr(options, k, v)
        return NewtonSolver(self.assembler, bc_set, options, lift=self.lift)

    def _make_iterative_solver(self, bc_set, **opts):
        cfg = self.cfg
        kw = dict(
            atol=float(cfg.get("atol", 1e-7)),
            rtol=float(cfg.get("rtol", 1e-7)),
            max_it=int(cfg.get("max_it", 50)),
            lmbda=float(cfg.get("lmbda", 1.0)),
            # the iterative path's own within-step reuse knob, deliberately
            # not the problem configs' `recompute` (as in vasp_tpu)
            recompute=int(cfg.get("jac_recompute", 1)),
            gmres_tol=float(cfg.get("gmres_tol", 1e-6)),
            gmres_restart=int(cfg.get("gmres_restart", 60)),
            gmres_maxiter=int(cfg.get("gmres_maxiter", 300)),
            jac_chunk=int(cfg.get("jac_chunk", 8192)),
            overlap=int(cfg.get("ras_overlap", 2)),
            jac_dtype=str(cfg.get("jac_dtype", "f32")),
            krylov_dtype=cfg.get("krylov_dtype"),
            residual_dtype=cfg.get("residual_dtype"),
            precond=str(cfg.get("precond", "banded")),
            predictor=str(cfg.get("predictor", "none")),
            endgame_factor=float(cfg.get("endgame_factor", 30.0)),
            chain_anchor=bool(cfg.get("chain_anchor", False)),
            chain_reanchor=int(cfg.get("chain_reanchor", 1)),
        )
        # the caller's options override the config's before StepOptions
        # validates them (residual_dtype="f32" is refused unless
        # delta_endgame=False comes with it)
        known = {f.name for f in dataclasses.fields(StepOptions)}
        kw.update({k: v for k, v in opts.items() if k in known})
        sopts = StepOptions(**kw)
        return IterativeNewtonSolver(
            self, bc_set, sopts,
            recompute_tstep=int(cfg.get("recompute_tstep", 20)),
            verbose=bool(cfg.get("verbose", True)),
            raise_on_fail=bool(cfg.get("raise_on_fail", True)))

    def zero_state(self):
        return torch.zeros(self.space.ndof, dtype=torch.float64,
                           device=self.device)
