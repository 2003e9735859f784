"""test_jac_carry_unwrapped_age of tests/test_iterative_stepper.py on the
port, against vasp_tpu on the small FSI tube: recompute=3 with jac_carry
over six steps of the same load. The carry's age stays below recompute
and cycles, and every step's age and Newton iterations equal vasp_tpu's
(every step here takes at most 8 iterations, so vasp_tpu's dispatch
chunking, which the port does not have, changes nothing)."""
import pytest

from _torch_small_fsi import loaded_pair, run_steps, torch_threads

_threads = torch_threads(2)


@pytest.fixture(scope="module")
def pair():
    return loaded_pair()


def test_jac_carry_unwrapped_age(pair):
    opts = dict(atol=1e-8, rtol=1e-8, max_it=8, gmres_tol=1e-7,
                gmres_restart=60, gmres_maxiter=600, jac_dtype="f32",
                recompute=3, jac_carry=True)
    _, out = run_steps(pair, opts, [1.0] * 6, recompute_tstep=100)
    ages = []
    for jU, jstats, tU, tstats, jage, tage in out:
        assert tstats["iterations"] == int(jstats["iterations"])
        assert tstats["residual"] <= 1e-8 * max(1.0, tstats["r0"])
        assert tage == jage
        ages.append(tage)
    held = [a for a in ages if a is not None]
    assert all(a < 3 for a in held), ages
    assert (None in ages) or (len(held) >= 2 and min(held) < max(held)), ages


def test_jac_carry_holds_the_facet_block():
    """On the tiny aneurysm (the port alone): the rebuild, the banded plan
    and the Jacobian carry take a block list with the Robin facet block;
    the carry holds its (K, 36, 36) Jacobians beside the cells' and the
    steps that start from it converge."""
    import torch

    from vasp_tpu_torch.fem.timestepper import IterativeStepper, StepOptions
    from vasp_tpu_torch.models import aneurysm
    from vasp_tpu_torch.run.config import default_variables
    from vasp_tpu_torch.run.system import FSISystem

    cfg = aneurysm.set_problem_parameters(default_variables())
    cfg.update(device="cpu", mesh_path=None, quadrature_degree=2,
               generated_mesh_params=dict(n_theta=8, n_z=8))
    mesh = aneurysm.get_mesh_domain_and_boundaries(**cfg)
    system = FSISystem(mesh, cfg)
    bcs = aneurysm.create_bcs(**dict(cfg, t=0.0, mesh=mesh, system=system,
                                     space=system.space))["bcs"]
    bc = system.make_bcset(bcs)
    st = IterativeStepper(system, bc, StepOptions(
        atol=1e-8, rtol=1e-8, max_it=8, gmres_tol=1e-7, gmres_maxiter=600,
        jac_dtype="f32", recompute=2, jac_carry=True), recompute_tstep=100)
    load = 1e3 * system.interface_pressure_load()
    U = system.zero_state()
    held = 0
    for tstep in (1, 2, 3):
        bcv = torch.as_tensor(bc.values_at(1e-3 * tstep))
        U, stats = st.step(U, bcv, load, tstep)
        assert stats["residual"] <= 1e-8 * max(1.0, stats["r0"])
        if st._jac_carry is not None:
            jacs, age = st._jac_carry
            assert [A.shape[1:] for A in jacs] == [(64, 64), (64, 64),
                                                  (36, 36)]
            assert 0 < age < 2
            held += 1
    assert held >= 1
    assert st.rebuilds == 1 and torch.isfinite(U).all()
