"""Empirical spectral density estimation, which seeds spectral-mixture
kernels (the port's copy of the JAX package's `ops/spectral.py`; numpy and
scipy, no torch).
"""

from __future__ import annotations

import numpy as np


def estimate_spectral_density(x, y, prominence: float = 1000.0,
                              return_power: bool = False):
    """Peak frequencies and periods of the rFFT periodogram of evenly spaced
    observations.

    Args:
      x: (N,) evenly spaced inputs; y: (N,) observations.
      prominence: `scipy.signal.find_peaks`' peak prominence.
      return_power: also return the periodogram's power at each peak (for
        the top-K choice of spectral-mixture components).
    Returns (freqs, periods) lists, plus `powers` when return_power; the
    zero-frequency bin is never a peak, so the lists stay aligned.
    """
    from scipy.signal import find_peaks

    x = np.squeeze(np.asarray(x))
    y = np.squeeze(np.asarray(y))
    N = x.shape[0]
    emp_spect = np.abs(np.fft.rfft(y) ** 2) / N
    freq = np.fft.rfftfreq(N, d=abs(x[1] - x[0]))
    peaks, _ = find_peaks(emp_spect, prominence=prominence)
    peaks = [i for i in peaks if freq[i] != 0]
    freqs = [freq[i] for i in peaks]
    periods = [1.0 / f for f in freqs]
    if return_power:
        powers = [float(emp_spect[i]) for i in peaks]
        return freqs, periods, powers
    return freqs, periods
