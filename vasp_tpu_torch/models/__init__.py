"""Problem definitions on the vasp_tpu_torch hook protocol."""
