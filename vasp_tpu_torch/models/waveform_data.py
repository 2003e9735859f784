"""Physiological waveform Fourier coefficients (data, not code).

Counterpart of vasp_tpu.models.waveform_data, the same tables. ICA
flow-rate waveform of older adults (Hoi et al. 2010, cited by the
reference at docs/aneurysm.md:62) and the matching pressure waveform —
numerically identical to the reference's bundled data tables
(reference: src/vasp/simulations/FC_MCA_10 and FC_Pressure) since these are
measured physiological coefficients required for case parity.

Each table: columns (An, Bn); complex coefficients Cn = (An - i Bn),
waveform f(t) = Re{sum Cn e^{i n w t}}, normalized to mean 1 (C0 = 1).
"""
import numpy as np

# cardiac period of the flow waveform, milliseconds
MCA_PERIOD_MS = 951

FC_MCA_10 = np.array([
    [1.0, 0.0],
    [-0.03885602, 0.389033342],
    [-0.147282143, 0.130334152],
    [-0.11754038, 0.003512608],
    [-0.020021036, 0.009457453],
    [-0.075084472, 0.009008134],
    [-0.02801715, -0.043570018],
    [0.00135982, -0.019541939],
    [0.005021068, -0.014658254],
    [0.014010913, -0.000665383],
    [0.001818315, 0.008984162],
    [-0.002389044, 0.003027716],
    [-0.002902271, 0.002916296],
    [-0.00375792, -0.00072257],
    [-0.000742721, -0.001574683],
    [-0.000450886, -0.000799589],
    [0.000585817, -0.001015015],
    [0.000751712, 0.000426051],
    [-2.19157e-05, 0.000342771],
    [1.59484e-06, 0.000451814],
    [-0.000597902, 0.000239054],
])

# pressure waveform period, seconds
PRESSURE_PERIOD_S = 0.951

FC_PRESSURE = np.array([
    [1.000000000000000000e+00, -0.000000000000000000e+00],
    [2.379780782403263515e-05, 1.850157941758481805e-01],
    [-4.284421301647262786e-02, 6.962088411850136938e-02],
    [-3.565613326767262670e-02, 1.599002298946930814e-02],
    [-4.503349131056780252e-03, 2.353553962146848547e-02],
    [-3.404287339990662298e-02, 1.201203303029594292e-02],
    [-1.243772780019024131e-02, -1.032403356872503217e-02],
    [-3.984544205787552383e-03, -3.365671661870378584e-03],
    [-7.300691486131872599e-04, -5.824184514530326810e-03],
    [4.996589394237049321e-03, 1.622769828275012305e-04],
    [-7.670595397262789446e-05, 3.556346306673033482e-03],
    [-5.534279551735392204e-04, 1.071440975837440043e-03],
    [-1.018874104777825430e-03, 1.712834813783358943e-03],
    [-1.499033326081060684e-03, -9.639519284944336557e-05],
    [-1.462356223861603622e-04, -2.825963580107712864e-04],
    [-3.282477477568552311e-04, -3.866745938539891005e-05],
    [1.977886651033047448e-04, -3.242412368713196115e-04],
    [2.432448911569127939e-04, 2.904355486496067239e-04],
    [-4.512215298463576881e-05, 1.153663898619083607e-04],
    [4.527316504252485856e-05, 2.023924429324363574e-04],
])


def load_fc(name: str):
    """Return (An, Bn) arrays for a named waveform table
    ('FC_MCA_10' or 'FC_Pressure'), mirroring np.loadtxt(FC_file).T usage
    (reference: src/vasp/simulations/aneurysm.py:111-113)."""
    table = {"FC_MCA_10": FC_MCA_10, "FC_Pressure": FC_PRESSURE}[name]
    return table[:, 0].copy(), table[:, 1].copy()
