"""Explicit device selection: the config key ``device`` (default "cuda").

Asking for CUDA where there is none is an error, never a silent move to the
CPU."""
import torch


def resolve_device(name="cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain torch path")
    return dev
