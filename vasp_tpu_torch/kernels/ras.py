"""K18: the restricted additive Schwarz (RAS) apply.

Plain torch version (``apply_plain``), CUDA launch (csrc/ras.cu) and the
dispatch fem/ras.py calls: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.

Replaces vasp_tpu/fem/ras.py make_apply: r gathered at each subdomain's
dofs (padded with the dof ndof, which reads 0) in the stored inverses'
type, the local products pinv_s r_s in that type, each real dof's value
kept from the subdomain that owns it, in r's type. Costs and design: see
the head of csrc/ras.cu. Instances: pinv float64 (counter ``ras_apply``)
or float32 (``ras_apply_f32``), each with a float64 or float32 r.
"""
import torch

from vasp_tpu_torch.kernels import build

_FLOATS = (torch.float32, torch.float64)
# the dynamic shared memory one block of an H100 takes: the gathered r_s
SHARED_BYTES = 227 * 1024


def counter(pinv):
    return "ras_apply" if pinv.dtype == torch.float64 else "ras_apply_f32"


def apply_plain(pinv, idx, own, r):
    """y (ndof,) in r's dtype: y[idx[s, i]] = (pinv_s r[idx_s])_i for the
    owned (s, i)."""
    ndof = r.shape[0]
    rl = torch.cat([r, r.new_zeros(1)])[idx].to(pinv.dtype)
    yl = torch.matmul(pinv, rl[..., None])[..., 0].to(r.dtype)
    y = r.new_zeros(ndof + 1)
    y[idx[own]] = yl[own]
    return y[:ndof]


def apply_cuda(pinv, idx, own, r):
    S, m = idx.shape
    dev, ndof = r.device, r.shape[0]
    if pinv.dtype not in _FLOATS or r.dtype not in _FLOATS:
        raise ValueError(f"K18 takes float32/float64 inverses and vectors, "
                         f"got {pinv.dtype} and {r.dtype}")
    if m * pinv.element_size() > SHARED_BYTES:
        raise ValueError(f"K18 gathers a subdomain's {m} dofs into "
                         f"{SHARED_BYTES} bytes of shared memory at most")
    build.require(pinv, "pinv", pinv.dtype, (S, m, m), dev)
    build.require(idx, "idx", torch.int64, (S, m), dev)
    build.require(own, "own", torch.bool, (S, m), dev)
    build.require(r, "r", r.dtype, (ndof,), dev)
    y = torch.empty_like(r)
    name = counter(pinv)
    build.check(build.library().vt_ras_apply(
        *map(build.ptr, (pinv, idx, own, r, y)), S, m, ndof,
        int(pinv.dtype == torch.float64), int(r.dtype == torch.float64),
        build.stream_handle(dev)), name)
    build.LAUNCHES[name] += 1
    return y


def apply(pinv, idx, own, r):
    if build.on_cuda(r, "ras_apply"):
        return apply_cuda(pinv, idx, own, r)
    return apply_plain(pinv, idx, own, r)
