"""The port's spectral stack, Cardano eigenvalue, WSS tables and log
plotter against vasp_tpu's and scipy's, on the CPU.

Mirrors tests/test_spectral.py (PSD and spectrogram against scipy and
against vasp_tpu, the high-pass filter, chroma and SBI, the windowed RMS,
sonification), tests/test_hemodynamics.py (Hagen-Poiseuille WSS) and
tests/test_log_plotter.py (synthetic logs, TKE, selectors and the CLI),
with the same seeded inputs handed to both packages. The PSD and the
spectrogram run K20c's plain version here; the WSS series K20a's; the
eigenvalue K20b's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import periodogram, spectrogram as scipy_spectrogram

from vasp_tpu.fem.functionspace import DVPSpace as JaxSpace
from vasp_tpu.fem.kinematics import get_eig as jax_get_eig
from vasp_tpu.mesh.generate import poiseuille_pipe_mesh as jax_pipe
from vasp_tpu.postprocessing import log_plotter as jax_log
from vasp_tpu.postprocessing.fields.hemodynamics import (
    FluidBoundaryTables as JaxTables,
)
from vasp_tpu.postprocessing.spectral import core as jax_spec
from vasp_tpu_torch.fem.functionspace import DVPSpace
from vasp_tpu_torch.kernels import build, postproc
from vasp_tpu_torch.mesh.generate import poiseuille_pipe_mesh
from vasp_tpu_torch.postprocessing import log_plotter
from vasp_tpu_torch.postprocessing.fields.hemodynamics import (
    FluidBoundaryTables,
    hemodynamic_indices,
)
from vasp_tpu_torch.postprocessing.spectral import core as spec
from _torch_small_fsi import torch_threads

_threads = torch_threads(2)


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(0)
    fs = 1000.0
    t = np.arange(2000) / fs
    base = np.sin(2 * np.pi * 50 * t) + 0.5 * np.sin(2 * np.pi * 120 * t)
    data = base[None, :] + 0.1 * rng.standard_normal((6, len(t)))
    return data, fs, t


@pytest.mark.parametrize("scaling", ["density", "spectrum"])
@pytest.mark.parametrize("n_t", [2000, 1999])
def test_psd_matches_scipy_and_vasp_tpu(signals, scaling, n_t):
    """The node-mean periodogram against scipy's per-row periodograms
    (rtol 1e-8, as tests/test_spectral.py) and against vasp_tpu's
    (1e-12 relative to the peak: the same arithmetic in another order;
    even and odd lengths, for the Nyquist bin)."""
    data, fs, _ = signals
    data = data[:, :n_t]
    build.reset_launch_counts()
    Pxx, f = spec.get_psd(data, fs, scaling=scaling, device="cpu")
    assert not any(build.LAUNCHES.values())
    ref = np.mean([periodogram(row, fs=fs, window="blackmanharris",
                               scaling=scaling)[1] for row in data], axis=0)
    np.testing.assert_allclose(Pxx, ref, rtol=1e-8, atol=1e-12)
    Pj, fj = jax_spec.get_psd(data, fs, scaling=scaling)
    np.testing.assert_array_equal(f, fj)
    np.testing.assert_allclose(Pxx, Pj, rtol=0, atol=1e-12 * Pj.max())
    assert abs(f[np.argmax(Pxx)] - 50.0) < 2.0


@pytest.mark.parametrize("n_window", [4, 7])
def test_spectrogram_matches_scipy_and_vasp_tpu(signals, n_window):
    data, fs, _ = signals
    Pxx, freqs, bins = spec.get_spectrogram(data, fs, n_window,
                                            overlap_frac=0.75,
                                            window="blackmanharris",
                                            device="cpu")
    NFFT = spec.shift_bit_length(int(data.shape[1] / n_window))
    ref = np.mean([scipy_spectrogram(
        row, fs=fs, nperseg=NFFT, noverlap=int(0.75 * NFFT), nfft=2 * NFFT,
        window="blackmanharris", scaling="spectrum")[2] for row in data],
        axis=0)
    assert Pxx.shape == ref.shape
    np.testing.assert_allclose(Pxx, ref, rtol=1e-6, atol=1e-12)
    Pj, fj, bj = jax_spec.get_spectrogram(data, fs, n_window)
    np.testing.assert_array_equal(freqs, fj)
    np.testing.assert_array_equal(bins, bj)
    np.testing.assert_allclose(Pxx, Pj, rtol=0, atol=1e-12 * Pj.max())


def test_average_spectrogram_and_filter_match_vasp_tpu(signals):
    """The thresholded log spectrogram of the high-passed data: 50 Hz
    killed, 120 Hz kept, and vasp_tpu's values to 1e-10 absolute on the
    log scale."""
    data, fs, _ = signals
    filtered = spec.filter_time_data(data, fs, lowcut=80.0, order=6,
                                     btype="highpass")
    Pxx, f = spec.get_psd(filtered, fs, device="cpu")
    p50 = Pxx[np.argmin(np.abs(f - 50))]
    p120 = Pxx[np.argmin(np.abs(f - 120))]
    assert p120 > 100 * p50
    args = (data, fs, 4, 0.75, "blackmanharris", 0.0, 2.0, -20.0)
    out = spec.compute_average_spectrogram(*args, filter_data=True,
                                           device="cpu")
    ref = jax_spec.compute_average_spectrogram(*args, filter_data=True)
    np.testing.assert_allclose(out[2], ref[2], rtol=0, atol=1e-10)
    assert out[3:] == pytest.approx(ref[3:], rel=1e-12)


def test_chroma_and_sbi(signals):
    data, fs, _ = signals
    Pxx, freqs, bins = spec.get_spectrogram(data, fs, 4, device="cpu")
    n_fft = 2 * spec.shift_bit_length(int(data.shape[1] / 4))
    chroma = spec.chromagram_from_spectrogram(Pxx, fs, n_fft, n_chroma=24,
                                              norm="sum")
    assert chroma.shape[0] == 24
    assert np.allclose(chroma.sum(axis=0), 1.0)
    sbi = spec.calc_chroma_entropy(chroma, 24)
    assert np.all(sbi >= -1e-9) and np.all(sbi <= 1.0 + 1e-9)
    np.testing.assert_allclose(
        chroma, jax_spec.chromagram_from_spectrogram(
            jax_spec.get_spectrogram(data, fs, 4)[0], fs, n_fft, n_chroma=24,
            norm="sum"), rtol=1e-10, atol=1e-14)
    rng = np.random.default_rng(1)
    noise = rng.standard_normal((6, data.shape[1]))
    Pn, _, _ = spec.get_spectrogram(noise, fs, 4, device="cpu")
    chn = spec.chromagram_from_spectrogram(Pn, fs, n_fft, n_chroma=24,
                                           norm="sum")
    assert sbi.mean() > spec.calc_chroma_entropy(chn, 24).mean()


def test_windowed_rms_and_sonify(tmp_path, signals):
    t = np.linspace(0, 1, 1000)
    sig = np.sin(2 * np.pi * 100 * t)
    rms = spec.calculate_windowed_rms(sig, 100)
    assert abs(rms[400:600].mean() - 1 / np.sqrt(2)) < 0.02
    data, fs, _ = signals
    path = spec.sonify(data[0], 44100, tmp_path / "tone.wav")
    from scipy.io import wavfile

    rate, wav = wavfile.read(path)
    assert rate == 44100 and len(wav) == data.shape[1]


def test_cuda_device_without_a_card_raises(signals, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, fs, _ = signals
    with pytest.raises(RuntimeError, match="cuda"):
        spec.get_psd(data, fs)


def _sym(rng, n):
    A = rng.normal(size=(n, 3, 3))
    return 0.5 * (A + A.transpose(0, 2, 1))


def test_get_eig_matches_vasp_tpu_and_numpy():
    """The Cardano eigenvalue (kernels/postproc.max_eig's plain version)
    against vasp_tpu's get_eig and numpy's eigvalsh, relative to each
    tensor's scale: 1e-10 on random symmetric tensors of scales 1e-6-1e6
    and on isotropic ones (its p2 <= 1e-30 branch); 2 sqrt(eps64) = 3e-8
    on ones with a double eigenvalue, where r = +-1 (its clip) and acos's
    infinite slope turns a rounding change of r into sqrt(eps) of the
    eigenvalue, in either package (measured 6e-9)."""
    rng = np.random.default_rng(7)
    A = _sym(rng, 200) * 10.0 ** rng.uniform(-6, 6, size=(200, 1, 1))
    iso = np.eye(3) * rng.normal(size=(20, 1, 1))
    Q, _ = np.linalg.qr(rng.normal(size=(20, 3, 3)))
    double = Q @ np.diag([1.0, 1.0, -2.0]) @ Q.transpose(0, 2, 1)
    A = np.concatenate([A, iso, double, -double])
    rel = np.concatenate([np.full(220, 1e-10),
                          np.full(40, 2 * np.sqrt(np.finfo(float).eps))])
    ours = postproc.max_eig(torch.as_tensor(A)).numpy()
    tol = rel * np.abs(A).max(axis=(1, 2))
    ref = np.linalg.eigvalsh(A)[:, -1]
    np.testing.assert_array_less(np.abs(ours - ref), tol)
    theirs = np.asarray(jnp.stack([jax_get_eig(jnp.asarray(a)) for a in A]))
    np.testing.assert_array_less(np.abs(ours - theirs), tol)


G, MU, R, L = 4.0, 1.0, 1.0, 5.0


@pytest.fixture(scope="module")
def pipe():
    """Steady Hagen-Poiseuille flow in a pipe (G=4, mu=1, R=1: WSS = 2),
    its tables in both packages and the port's WSS of two equal steps."""
    kw = dict(radius=R, length=L, n_theta=24, n_r=4, n_z=8)
    mesh = poiseuille_pipe_mesh(**kw)
    space = DVPSpace(mesh)
    xyz = space.p2_coords
    u = np.zeros((space.n_p2, 3))
    u[:, 2] = G / (4 * MU) * (R ** 2 - xyz[:, 0] ** 2 - xyz[:, 1] ** 2)
    tables = FluidBoundaryTables(mesh, dx_f_id=1, quad_degree=2)
    idx, tau = hemodynamic_indices(tables, np.stack([u, u]),
                                   space.cell_dofs_p2, MU, [0.0, 1.0],
                                   device="cpu")
    jmesh = jax_pipe(**kw)
    jtables = JaxTables(jmesh, dx_f_id=1, quad_degree=2)
    jtau = np.asarray(jtables.wss_series(
        np.stack([u, u]), JaxSpace(jmesh).cell_dofs_p2, MU))
    return tables, idx, tau, jtau


def _wall_nodes(tables):
    nodes = np.unique(tables.facet_bnodes[tables.markers == 22])
    z = tables.boundary_coords[nodes, 2]
    return nodes[(z > 0.1) & (z < L - 0.1)]


def test_poiseuille_wss(pipe):
    """TAWSS within the reference's band (1.95, 2.05)
    (reference tests/test_compute_hemodynamics.py:73), OSI ~0 for steady
    flow, the WSS along -z, and vasp_tpu's series to 1e-10 of its scale."""
    tables, idx, tau, jtau = pipe
    nodes = _wall_nodes(tables)
    assert 1.95 < idx["TAWSS"][nodes].mean() < 2.05
    assert idx["OSI"][nodes].max() < 1e-10
    assert np.all(np.abs(tau[0][nodes, 2]) > 1.5)
    np.testing.assert_allclose(tau, jtau, rtol=0,
                               atol=1e-10 * np.abs(jtau).max())


def _probe_log(n_steps):
    lines = []
    for step in range(1, n_steps + 1):
        t = step * 0.001
        lines += [
            f"ramp_factor = {0.5 * step} m^3/s",
            "Instantaneous normal stress prescribed at the FSI interface "
            f"{1000.0 * step} Pa",
            f"Probe Point 0: Velocity: ({0.1*step}, {0.0}, {0.0}) | "
            f"Pressure: {100.0*step}",
            f"Probe Point 0: Displacement: ({1e-6*step}, {0.0}, {0.0})",
            f"Minimum Jacobian: {1.0 - 0.01*step}",
            "Flow Properties:",
            f"  Flow Rate at Inlet: {1e-6*step}",
            f"  Velocity (mean, min, max): {0.1*step}, {0.01*step}, "
            f"{0.2*step}",
            f"  CFL (mean, min, max): {0.1}, {0.01}, {0.2}",
            f"  Reynolds Numbers (mean, min, max): {10.0}, {1.0}, {20.0}",
            f"Solved for timestep {step}, t = {t:.4f} in 1.0 s",
        ]
    return "\n".join(lines) + "\n"


def test_log_plotter_parses_as_vasp_tpu(tmp_path):
    """The parsed log equals vasp_tpu's, key by key, and the figures and
    per-cycle comparisons are written (tests/test_log_plotter.py)."""
    log_file = tmp_path / "synthetic.log"
    log_file.write_text(_probe_log(8))
    data = log_plotter.parse_log_file(log_file)
    ref = jax_log.parse_log_file(log_file)
    assert sorted(data) == sorted(ref)
    assert repr(data) == repr(ref)
    assert np.allclose(data["probe_points"][0]["pressure"],
                       100.0 * np.arange(1, 9))
    log_plotter.plot_all(data, tmp_path / "Images", period=0.004)
    assert (tmp_path / "Images" / "probe_points_tke.png").exists()
    assert len(log_plotter.plot_compare_cycles(
        data, tmp_path / "Images", period=0.004)) >= 1
    trimmed = log_plotter.trim_cycles(data, 0.004, start_cycle=2,
                                      end_cycle=2)
    assert len(trimmed["time"]) == 4 and np.isclose(trimmed["time"][0],
                                                    0.005)


def test_tke_phase_average_matches_vasp_tpu():
    period, dt = 0.1, 0.001
    t = np.arange(0, 1.0, dt)
    v = np.stack([np.sin(2 * np.pi * t / period), np.zeros_like(t),
                  np.zeros_like(t)], axis=1)
    phase_t, tke = log_plotter.compute_tke(v, t, period)
    assert np.abs(tke).max() < 1e-20
    v_noisy = v + 0.1 * np.random.default_rng(0).standard_normal(v.shape)
    _, tke2 = log_plotter.compute_tke(v_noisy, t, period)
    _, tke_ref = jax_log.compute_tke(v_noisy, t, period)
    assert tke2.mean() > 1e-4
    np.testing.assert_allclose(tke2, tke_ref, rtol=1e-12)


def test_log_plotter_cli(tmp_path):
    log_file = tmp_path / "run.log"
    log_file.write_text(_probe_log(8))
    out = tmp_path / "Images"
    log_plotter.main(["--log-file", str(log_file), "--period", "0.004",
                      "--compute-average", "--compare-cycles", "--save",
                      "--save-probes", "--output-directory", str(out)])
    for name in ("average/flow_rate.png", "average/probe_points_tke.png",
                 "compare_cycles/flow_rate_comparison.png",
                 "compare_cycles/probe_points_tke_comparison_0.png",
                 "probe_points_displacement.pickle"):
        assert (out / name).exists(), name
