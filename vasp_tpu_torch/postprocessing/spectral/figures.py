"""Composite spectrogram/chromagram/SBI figures and standalone spectra.

Counterpart of vasp_tpu.postprocessing.spectral.figures (matplotlib is
imported at first use; the PSD and spectrogram run on `device`).
Parity targets:
- vasp-create-spectrograms-chromagrams
  (reference: postprocessing_h5py/create_spectrograms_chromagrams.py:21-219):
  high-pass filtered PSD plot, thresholded log-power spectrogram, 'sum'-
  normalized chromagram, SBI trace; multi-panel composite figure + CSVs,
- vasp-create-spectrum (reference: postprocessing_h5py/create_spectrum.py:19-72):
  standalone PSD plot + CSV.
"""
from pathlib import Path

import numpy as np

from vasp_tpu_torch.postprocessing.spectral import core as spec


def _pyplot():
    """matplotlib.pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# per-quantity default color ranges (reference: spectrograms.py:133-155)
QUANTITY_COLORS = {
    "v": (-20, -2.5),
    "d": (-42, -25),
    "p": (-5, 12),
    "wss": (-18, 0),
    "strain": (-30, -20),
}


def get_sampling_constants(times):
    T = times[-1] - times[0]
    nsamples = len(times)
    fs = nsamples / T if T > 0 else 1.0
    return T, nsamples, fs


def create_spectrogram_composite(case_name, quantity, data, times, start_t,
                                 end_t, num_windows_per_sec, overlap_frac,
                                 window, lowcut, min_color, max_color,
                                 image_folder, power_scaled=False, ylim=None,
                                 n_chroma=24, device="cuda"):
    """Returns dict of computed arrays; writes PNG + CSVs like the
    reference."""
    plt = _pyplot()

    image_folder = Path(image_folder)
    image_folder.mkdir(parents=True, exist_ok=True)
    num_windows = np.round(num_windows_per_sec * (end_t - start_t)) + 3
    T, nsamples, fs = get_sampling_constants(times)

    data_filtered = spec.filter_time_data(
        data, fs, lowcut=lowcut, highcut=15000.0, order=6, btype="highpass"
    )
    Pxx_array, freq_array = spec.get_psd(data_filtered, fs, device=device)

    fig_psd = plt.figure()
    plt.plot(freq_array, Pxx_array)
    plt.xlabel("Freq. (Hz)")
    plt.ylabel("input units^2/Hz")
    if ylim is not None:
        plt.xlim([0, ylim])
    psd_path = image_folder / f"{quantity}_psd_{case_name}.png"
    plt.savefig(psd_path)
    plt.close(fig_psd)

    # composite: spectrogram + chromagram + SBI
    fig1, (ax2, ax3, ax4) = plt.subplots(
        3, sharex=True, gridspec_kw={"height_ratios": [3, 1, 1]}
    )
    fig1.set_size_inches(7.5, 9)

    bins, freqs, Pxx, *_ = spec.compute_average_spectrogram(
        data_filtered, fs, num_windows, overlap_frac, window, start_t,
        end_t, min_color, scaling="spectrum", thresh_method="new",
        device=device,
    )
    bins = bins + start_t
    im = ax2.pcolormesh(bins, freqs, Pxx, shading="gouraud",
                        vmin=min_color, vmax=max_color)
    fig1.colorbar(im, ax=ax2)
    ax2.set_ylabel("Freq (Hz)")
    if ylim is not None:
        ax2.set_ylim([0, ylim])

    # chromagram of the unfiltered data
    bins_raw, freqs_raw, Pxx_raw, *_ = spec.compute_average_spectrogram(
        data, fs, num_windows, overlap_frac, window, start_t, end_t,
        min_color, scaling="spectrum", thresh_method="none", device=device,
    )
    bins_raw = bins_raw + start_t
    n_fft = spec.shift_bit_length(int(np.asarray(data).shape[1]
                                      / num_windows)) * 2
    chroma = spec.chromagram_from_spectrogram(Pxx_raw, fs, n_fft,
                                              n_chroma=n_chroma, norm="sum")
    ax3.pcolormesh(bins_raw, np.arange(n_chroma), chroma, shading="gouraud")
    ax3.set_ylabel("Chroma")

    sbi = spec.calc_chroma_entropy(chroma, n_chroma)
    ax4.plot(bins_raw, sbi)
    ax4.set_ylabel("SBI")
    ax4.set_xlabel("Time (s)")

    fig_path = image_folder / (
        f"{quantity}_spectrogram_{case_name}.png"
    )
    fig1.savefig(fig_path)
    plt.close(fig1)

    # CSV exports (reference saves spectrogram/chroma/SBI CSVs)
    np.savetxt(image_folder / f"{quantity}_psd_{case_name}.csv",
               np.column_stack([freq_array, Pxx_array]), delimiter=",",
               header="freq,psd")
    np.savetxt(image_folder / f"{quantity}_sbi_{case_name}.csv",
               np.column_stack([bins_raw, sbi]), delimiter=",",
               header="time,sbi")
    return dict(psd=(freq_array, Pxx_array), spectrogram=(bins, freqs, Pxx),
                chroma=(bins_raw, chroma), sbi=(bins_raw, sbi),
                figures=[psd_path, fig_path])


def create_spectrum(case_name, quantity, data, times, start_t, end_t,
                    image_folder, lowcut=0.0, ylim=None,
                    power_scaled=False, device="cuda"):
    """Standalone power spectrum (reference: create_spectrum.py:19-72)."""
    plt = _pyplot()

    image_folder = Path(image_folder)
    image_folder.mkdir(parents=True, exist_ok=True)
    T, nsamples, fs = get_sampling_constants(times)
    if lowcut and lowcut > 0:
        data = spec.filter_time_data(data, fs, lowcut=lowcut,
                                     highcut=15000.0, order=6,
                                     btype="highpass")
    Pxx, freqs = spec.get_psd(data, fs, device=device)
    fig = plt.figure()
    plt.semilogy(freqs, Pxx)
    plt.xlabel("Freq. (Hz)")
    plt.ylabel("PSD")
    if ylim is not None:
        plt.xlim([0, ylim])
    path = image_folder / f"{quantity}_spectrum_{case_name}.png"
    plt.savefig(path)
    plt.close(fig)
    np.savetxt(image_folder / f"{quantity}_spectrum_{case_name}.csv",
               np.column_stack([freqs, Pxx]), delimiter=",",
               header="freq,psd")
    return path
