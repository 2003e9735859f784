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
