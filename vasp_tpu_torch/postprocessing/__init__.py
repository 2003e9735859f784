"""Postprocessing stages of vasp_tpu_torch's results folders (host code)."""
