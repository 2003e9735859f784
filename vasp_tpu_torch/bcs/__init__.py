from vasp_tpu_torch.bcs.waveforms import (  # noqa: F401
    CosineRamp,
    FourierFlowWaveform,
    InterfacePressure,
    ParabolicInflow,
    PatientWaveform,
    WomersleyInflow,
)
