"""Spectral analysis core: PSD/spectrogram/chroma/SBI/filter kernels.

Counterpart of vasp_tpu.postprocessing.spectral.core (reference:
src/vasp/postprocessing/postprocessing_h5py/spectrograms.py):
- get_psd (L397): node-averaged blackmanharris periodograms,
- get_spectrogram (L424): node-averaged scipy-convention spectrograms with
  NFFT = next-pow-2(T/nWindow), nfft = 2*NFFT zero padding,
- spectrogram_scaling (L476): log-power with lower threshold,
- butter_bandpass(_filter) / filter_time_data (L502-583): Butterworth
  band/stop/high/low-pass with zero-phase filtfilt,
- chromagram_from_spectrogram + SBI = 1 - chroma entropy / log(n_chroma)
  (L685-745),
- calculate_windowed_rms (reference: postprocessing_h5py_common.py:685-733),
- sonify (L817): WAV export.

The PSD and the spectrogram run on `device`: the detrend and the window in
plain torch, the rfft in torch.fft (cuFFT on a card, as vasp_tpu leaves it
to XLA's FFT), and the power pass (|X|^2, scaling, the one-sided
correction, the node mean) in K20c (kernels/postproc.py). The filters, the
chroma and the windowed RMS are scipy/numpy on the host, as in vasp_tpu.

The chroma filterbank follows the published librosa algorithm (ISC; the
reference vendors the original code at chroma_filters.py; here it is
reimplemented from the algorithm description).
"""
import numpy as np
import torch
from scipy.signal import butter, filtfilt, get_window

from vasp_tpu_torch.device import resolve_device
from vasp_tpu_torch.kernels import postproc


def shift_bit_length(x: int) -> int:
    """Next power of two >= x (reference: spectrograms.py NFFT choice)."""
    return 1 << (int(x) - 1).bit_length()


# ---------------- PSD / spectrogram ----------------
def _power(frames, w, n_fft, scale, device):
    """(F, B) numpy: the node-mean one-sided power of detrended, windowed
    frames (n, B, L) (scipy's constant detrend), on `device`."""
    frames = frames - frames.mean(dim=2, keepdim=True)
    xw = frames * torch.as_tensor(w, dtype=torch.float64, device=device)
    spec = torch.fft.rfft(xw, n=n_fft, dim=2)  # (n, B, F)
    return postproc.spectral_power(spec, scale, n_fft % 2 == 0).cpu().numpy()


def get_psd(data, fs, scaling="density", window="blackmanharris",
            device="cuda"):
    """Node-averaged periodogram. data: (n_nodes, T). Returns (Pxx_mean, f).
    """
    # filtfilt's output has negative strides, which torch refuses
    data = np.ascontiguousarray(np.atleast_2d(data), dtype=np.float64)
    n, T = data.shape
    dev = resolve_device(device)
    w = get_window(window, T)
    if scaling == "density":
        scale = 1.0 / (fs * np.sum(w ** 2))
    else:  # spectrum
        scale = 1.0 / np.sum(w) ** 2
    x = torch.as_tensor(data, dtype=torch.float64, device=dev)[:, None, :]
    p = _power(x, w, T, scale, dev)[:, 0]
    f = np.fft.rfftfreq(T, 1.0 / fs)
    return p, f


def get_spectrogram(data, fs, n_window, overlap_frac=0.75,
                    window="blackmanharris", start_t=0.0, end_t=1.0,
                    scaling="spectrum", interpolate=False, device="cuda"):
    """Node-averaged spectrogram with the reference's conventions:
    NFFT = next_pow2(T / n_window), nperseg = NFFT, noverlap =
    overlap_frac*NFFT, nfft = 2*NFFT. Returns (Pxx_mean (F,B), freqs, bins).
    """
    # filtfilt's output has negative strides, which torch refuses
    data = np.ascontiguousarray(np.atleast_2d(data), dtype=np.float64)
    n, T = data.shape
    dev = resolve_device(device)
    NFFT = shift_bit_length(int(T / n_window))
    nperseg = NFFT
    noverlap = int(overlap_frac * NFFT)
    nfft = 2 * NFFT
    step = nperseg - noverlap
    nframes = max(0, (T - nperseg) // step + 1)
    w = get_window(window, nperseg)
    if scaling == "density":
        scale = 1.0 / (fs * np.sum(w ** 2))
    else:
        scale = 1.0 / np.sum(w) ** 2

    idx = np.arange(nperseg)[None, :] + step * np.arange(nframes)[:, None]
    x = torch.as_tensor(data, dtype=torch.float64, device=dev)
    frames = x[:, torch.as_tensor(idx, device=dev)]  # (n, B, nperseg)
    Pxx = _power(frames, w, nfft, scale, dev)  # (F, B)
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    bins = (nperseg / 2 + step * np.arange(nframes)) / fs
    Pxx[Pxx < 0] = 1e-16
    if interpolate and Pxx.shape[1] > 3 and Pxx.shape[0] > 3:
        # smooth-display interpolation onto a 4x denser time axis
        # (reference: spectrograms.py:465-468 RectBivariateSpline option)
        from scipy.interpolate import RectBivariateSpline

        spl = RectBivariateSpline(freqs, bins, Pxx)
        bins_i = np.linspace(bins[0], bins[-1], 4 * len(bins))
        Pxx = np.maximum(spl(freqs, bins_i), 1e-16)
        bins = bins_i
    return Pxx, freqs, bins


def spectrogram_scaling(Pxx_mean, lower_thresh):
    """Log-power with lower threshold (reference: spectrograms.py:476-499)."""
    Pxx_scaled = np.log(Pxx_mean)
    max_val = np.max(Pxx_scaled)
    min_val = np.min(Pxx_scaled)
    Pxx_scaled[Pxx_scaled < lower_thresh] = lower_thresh
    return Pxx_scaled, max_val, min_val, lower_thresh


def compute_average_spectrogram(data, fs, n_window, overlap_frac, window,
                                start_t, end_t, thresh, scaling="spectrum",
                                filter_data=False, thresh_method="new",
                                device="cuda"):
    """reference: spectrograms.py:586-660 semantics (thresh_method 'new':
    log + threshold; 'old': log of normalized; 'log_only')."""
    if filter_data:
        data = filter_time_data(data, fs)
    Pxx, freqs, bins = get_spectrogram(data, fs, n_window, overlap_frac,
                                       window, start_t, end_t, scaling,
                                       device=device)
    if thresh_method == "new":
        Pxx_scaled, max_val, min_val, lower_thresh = spectrogram_scaling(
            Pxx, thresh
        )
    elif thresh_method == "log_only":
        Pxx_scaled = np.log(Pxx)
        max_val, min_val, lower_thresh = (np.max(Pxx_scaled),
                                          np.min(Pxx_scaled), None)
    else:
        Pxx_scaled, max_val, min_val, lower_thresh = Pxx, None, None, None
    return bins, freqs, Pxx_scaled, max_val, min_val, lower_thresh


# ---------------- filters ----------------
def butter_bandpass(lowcut, highcut, fs, order=5, btype="band"):
    """reference: spectrograms.py:502-532."""
    nyq = 0.5 * fs
    low = lowcut / nyq
    high = highcut / nyq
    if btype == "band":
        return butter(order, [low, high], btype="band")
    if btype == "stop":
        return butter(order, [low, high], btype="bandstop")
    if btype == "highpass":
        return butter(order, low, btype="highpass")
    if btype == "lowpass":
        return butter(order, high, btype="lowpass")
    if "pass" in btype:
        return butter(order, [low, high], btype="bandpass")
    raise ValueError(f"unknown btype {btype}")


def butter_bandpass_filter(data, lowcut=25.0, highcut=15000.0, fs=2500.0,
                           order=5, btype="band"):
    b, a = butter_bandpass(lowcut, highcut, fs, order=order, btype=btype)
    data = np.asarray(data)
    # clamp the reflection padding for short series (scipy default padlen
    # 3*max(len(a),len(b)) must stay below the signal length)
    padlen = min(3 * max(len(a), len(b)), data.shape[-1] - 1)
    return filtfilt(b, a, data, axis=-1, padlen=max(padlen, 0))


def filter_time_data(data, fs, lowcut=25.0, highcut=15000.0, order=6,
                     btype="highpass"):
    """Zero-phase Butterworth over every node's series (vectorized; the
    reference loops rows, reference: spectrograms.py:558-583)."""
    return butter_bandpass_filter(np.asarray(data), lowcut, highcut, fs,
                                  order, btype)


# ---------------- chroma / SBI ----------------
def _hz_to_octs(frequencies, tuning=0.0, bins_per_octave=12):
    A440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return np.log2(np.asarray(frequencies) / (A440 / 16))


def chroma_filterbank(sr, n_fft, n_chroma=24, tuning=0.0, ctroct=5.0,
                      octwidth=2, norm=2, base_c=True):
    """Gaussian-bump log-frequency chroma filterbank (librosa algorithm;
    the reference vendors the original ISC code at
    reference: postprocessing_h5py/chroma_filters.py:397-531)."""
    wts = np.zeros((n_chroma, n_fft))
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    frqbins = n_chroma * _hz_to_octs(frequencies, tuning=tuning,
                                     bins_per_octave=n_chroma)
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate(
        (np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0])
    )
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    # normalize columns
    if norm == 2:
        length = np.sqrt(np.sum(wts ** 2, axis=0, keepdims=True))
        wts = wts / np.maximum(length, 1e-300)
    if octwidth is not None:
        wts *= np.tile(
            np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
            (n_chroma, 1),
        )
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : int(1 + n_fft / 2)])


def chromagram_from_spectrogram(Pxx, fs, n_fft, n_chroma=24, norm=True):
    """reference: spectrograms.py:685-727."""
    chromafb = chroma_filterbank(sr=fs, n_fft=n_fft, tuning=0.0,
                                 n_chroma=n_chroma, ctroct=5, octwidth=2)
    chroma = chromafb @ np.asarray(Pxx)
    if norm == "max":
        chroma = chroma / np.maximum(np.abs(chroma).max(axis=0,
                                                        keepdims=True),
                                     1e-300)
    elif norm == "sum":
        denom = np.sum(chroma, axis=0, keepdims=True)
        chroma = chroma / np.where(denom == 0, 1.0, denom)
    return chroma


def calc_chroma_entropy(chroma, n_chroma):
    """Spectral Bandedness Index SBI = 1 - chroma entropy / log(n_chroma)
    (reference: spectrograms.py:730-745)."""
    chroma = np.asarray(chroma)
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -np.nansum(
            np.where(chroma > 0, chroma * np.log(chroma), 0.0), axis=0
        ) / np.log(n_chroma)
    return 1 - ent


# ---------------- windowed RMS ----------------
def calculate_windowed_rms(signal, window_size, axis=-1):
    """Windowed RMS amplitude via moving-average of squares
    (reference: postprocessing_h5py_common.py:685-733)."""
    signal = np.asarray(signal)
    sq = signal ** 2
    kernel = np.ones(window_size) / window_size
    ma = np.apply_along_axis(
        lambda x: np.convolve(x, kernel, mode="same"), axis, sq
    )
    return np.sqrt(ma)


# ---------------- sonification ----------------
def sonify(series, fs_audio, path, fs_data=None):
    """Export a time series as a WAV file
    (reference: spectrograms.py:817-852)."""
    from scipy.io import wavfile

    y = np.asarray(series, np.float64)
    y = y - y.mean()
    m = np.abs(y).max()
    if m > 0:
        y = y / m
    wavfile.write(path, int(fs_audio), (y * 32767).astype(np.int16))
    return path
