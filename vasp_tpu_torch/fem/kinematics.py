"""Continuum kinematics and material models on torch tensors (pointwise).

Counterpart of vasp_tpu.fem.kinematics. All functions take ``grad_d``: the
3x3 displacement gradient d d_i / d X_j in the reference configuration.

St.Venant-Kirchhoff takes its closed-form second Piola-Kirchhoff stress
S = lambda tr(E) I + 2 mu E, the same expression the CUDA solid kernel
evaluates; the tests hold it against torch.func.grad of the strain energy
W_st_venant_kirchoff. MooneyRivlin is not ported yet.
"""
import torch


def E_(grad_d):
    """Green-Lagrange strain, CANCELLATION-FREE form.

    E = (F^T F - I)/2 == (H + H^T + H^T H)/2 with H = grad(d), exactly.
    The second form never subtracts the identity, so the roundoff is
    RELATIVE to |E| (~1e-3 strains here) instead of absolute at the
    working precision's epsilon per C entry."""
    H = grad_d
    Ht = H.transpose(-1, -2)
    return 0.5 * (H + Ht + Ht @ H)


def W_st_venant_kirchoff(E, props):
    mu, lam = props["mu_s"], props["lambda_s"]
    trE = torch.diagonal(E, dim1=-2, dim2=-1).sum(-1)
    trEE = torch.diagonal(E @ E, dim1=-2, dim2=-1).sum(-1)
    return 0.5 * lam * trE ** 2 + mu * trEE


def S_(grad_d, props):
    """Second Piola-Kirchhoff stress for props['material_model']
    (default StVenantKirchoff; LinearElastic is its alias, as in the
    reference package). (..., 3, 3) -> (..., 3, 3)."""
    model = props.get("material_model", "StVenantKirchoff")
    if model not in ("StVenantKirchoff", "LinearElastic"):
        raise NotImplementedError(
            f"material_model={model!r} is not ported to vasp_tpu_torch yet "
            f"(ROADMAP.md queue 1, item 10: physics breadth)")
    E = E_(grad_d)
    trE = torch.diagonal(E, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    return props["lambda_s"] * trE[..., None, None] * eye + 2.0 * props["mu_s"] * E


def piola1(grad_d, props):
    """First Piola-Kirchhoff stress P = F S."""
    eye = torch.eye(3, dtype=grad_d.dtype, device=grad_d.device)
    return (eye + grad_d) @ S_(grad_d, props)
