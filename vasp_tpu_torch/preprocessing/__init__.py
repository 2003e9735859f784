"""Host-side mesh construction (numpy), copied from vasp_tpu.preprocessing."""
