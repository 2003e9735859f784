"""Continuum kinematics and material models on torch tensors (pointwise).

Counterpart of vasp_tpu.fem.kinematics. All functions take ``grad_d``: the
3x3 displacement gradient d d_i / d X_j in the reference configuration.

Both materials take a closed-form second Piola-Kirchhoff stress, the same
expressions the CUDA solid kernel evaluates (csrc/element_forms.cuh); the
tests hold each against torch.func.grad of its strain energy and against
vasp_tpu's S_ (jax.grad of the same energy):
- St.Venant-Kirchhoff (LinearElastic is its alias): S = lambda tr(E) I
  + 2 mu E;
- compressible Mooney-Rivlin: see S_mooney_rivlin.
"""
import torch

from vasp_tpu_torch.fem.smallmat import adj3, det3


def E_(grad_d):
    """Green-Lagrange strain, CANCELLATION-FREE form.

    E = (F^T F - I)/2 == (H + H^T + H^T H)/2 with H = grad(d), exactly.
    The second form never subtracts the identity, so the roundoff is
    RELATIVE to |E| (~1e-3 strains here) instead of absolute at the
    working precision's epsilon per C entry."""
    H = grad_d
    Ht = H.transpose(-1, -2)
    return 0.5 * (H + Ht + Ht @ H)


def _trace(A):
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)


def _invariant_deltas(E):
    """(I1 - 3, I2 - 3, 2 ln J) of C = I + 2E, each cancellation-free.

    det(C) = det(I + 2E) = 1 + x with
    x = 2 tr E + 2 ((tr E)^2 - tr E^2) + 8 det E (exact 3x3 expansion),
    so 2 ln J = ln det C = log1p(x)."""
    trE = _trace(E)
    q = trE ** 2 - _trace(E @ E)
    dI1 = 2.0 * trE
    dI2 = 4.0 * trE + 2.0 * q
    x = 2.0 * trE + 2.0 * q + 8.0 * det3(E)
    return dI1, dI2, torch.log1p(x)


def W_st_venant_kirchoff(E, props):
    mu, lam = props["mu_s"], props["lambda_s"]
    return 0.5 * lam * _trace(E) ** 2 + mu * _trace(E @ E)


def W_mooney_rivlin(E, props):
    """Compressible Mooney-Rivlin with (C01, C10, C11) + lambda_s volumetric
    term; stress-free at E = 0."""
    C01, C10, C11 = props["C01"], props["C10"], props["C11"]
    lam = props["lambda_s"]
    dI1, dI2, lndetC = _invariant_deltas(E)
    lnJ = 0.5 * lndetC
    return (C01 * dI1 + C10 * dI2 + C11 * dI1 * dI2 + 0.5 * lam * lnJ ** 2
            - (2.0 * C01 + 4.0 * C10) * lnJ)


def S_mooney_rivlin(E, props):
    """dW_mooney_rivlin/dE in closed form, for symmetric E.

    With q = (tr E)^2 - tr E^2, x as in _invariant_deltas, lnJ =
    log1p(x)/2, c0 = 2 C01 + 4 C10 and cof(E) the cofactor matrix (the
    derivative of det E):

      dW/dE = 2 C01 I + C10 ((4 + 4 tr E) I - 4 E)
              + C11 (2 dI2 I + dI1 ((4 + 4 tr E) I - 4 E))
              + (lam lnJ - c0) (2 I + 4 tr E I - 4 E + 8 cof E) / (2 (1 + x)).

    The constant terms c0 I and -c0 I / (1 + x) cancel to O(|E|); they
    are folded here into c0 ((2 q + 8 det E) I + 2 E - 4 cof E) / (1 + x),
    the same expression with no O(1) terms left, so that float32 keeps
    its precision relative to |S| (as E_ and log1p keep it for E and
    lnJ):

      S = a I + b E + g cof E,
      a = 4 C10 tr E + C11 (2 dI2 + dI1 (4 + 4 tr E))
          + (c0 (2 q + 8 det E) + lam lnJ (1 + 2 tr E)) / (1 + x),
      b = -4 C10 - 4 C11 dI1 + 2 (c0 - lam lnJ) / (1 + x),
      g = -4 (c0 - lam lnJ) / (1 + x)."""
    C01, C10, C11 = (float(props[k]) for k in ("C01", "C10", "C11"))
    lam = float(props["lambda_s"])
    c0 = 2.0 * C01 + 4.0 * C10
    trE = _trace(E)
    q = trE * trE - _trace(E @ E)
    detE = det3(E)
    x = 2.0 * trE + 2.0 * q + 8.0 * detE
    lnJ = 0.5 * torch.log1p(x)
    dI1 = 2.0 * trE
    dI2 = 4.0 * trE + 2.0 * q
    inv = 1.0 / (1.0 + x)
    h = (c0 - lam * lnJ) * inv
    a = (4.0 * C10 * trE + C11 * (2.0 * dI2 + dI1 * (4.0 + 4.0 * trE))
         + (c0 * (2.0 * q + 8.0 * detE) + lam * lnJ * (1.0 + 2.0 * trE))
         * inv)
    b = -4.0 * C10 - 4.0 * C11 * dI1 + 2.0 * h
    g = -4.0 * h
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    # adj3(E) is cof(E)^T, and both are cof(E) for symmetric E
    return (a[..., None, None] * eye + b[..., None, None] * E
            + g[..., None, None] * adj3(E))


_MODELS = ("StVenantKirchoff", "LinearElastic", "MooneyRivlin")


def S_(grad_d, props):
    """Second Piola-Kirchhoff stress for props['material_model']
    (default StVenantKirchoff, matching the reference default_variables;
    LinearElastic is its alias, as in the reference package), symmetrized
    as vasp_tpu symmetrizes its autodiff gradient. (..., 3, 3) ->
    (..., 3, 3)."""
    model = props.get("material_model", "StVenantKirchoff")
    if model not in _MODELS:
        raise KeyError(f"unknown material_model {model!r}; known: "
                       f"{list(_MODELS)}")
    E = E_(grad_d)
    if model == "MooneyRivlin":
        S = S_mooney_rivlin(E, props)
        return 0.5 * (S + S.transpose(-1, -2))
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    return props["lambda_s"] * _trace(E)[..., None, None] * eye \
        + 2.0 * props["mu_s"] * E


def piola1(grad_d, props):
    """First Piola-Kirchhoff stress P = F S."""
    eye = torch.eye(3, dtype=grad_d.dtype, device=grad_d.device)
    return (eye + grad_d) @ S_(grad_d, props)


def get_eig(T):
    """Largest eigenvalue of symmetric (..., 3, 3) tensors in closed form
    (Cardano), vasp_tpu's get_eig term for term (reference:
    postprocessing_h5py_common.py:734-801): the clip of r to [-1, 1], and
    the trace third where p2 <= 1e-30 (a near-isotropic tensor). The plain
    version of the eigenvalue in the K20b kernels (kernels/postproc.py)."""
    q = _trace(T) / 3.0
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    B = T - q[..., None, None] * eye
    p2 = (B * B).sum(dim=(-2, -1)) / 2.0
    p = torch.sqrt(torch.clamp_min(p2 / 3.0, 1e-300))
    r = det3(B) / torch.clamp_min(2.0 * p ** 3, 1e-300)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    eig_max = q + 2.0 * p * torch.cos(phi)
    return torch.where(p2 <= 1e-30, q, eig_max)
