"""Debug visualization (counterpart of libllsm2_tpu.utils.plotting;
reference: ciglet's optional gnuplot macros).

Matplotlib-based quick looks at chunks and spectra; the import is
deferred, so nothing on a library path imports matplotlib (the card's
machine may have none).  Chunk fields may be tensors on any device.
"""
from __future__ import annotations

import numpy as np


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def plot_chunk(chunk, path: str, fs: float | None = None) -> None:
    """One-page overview of a chunk: F0 track, harmonic amplitude
    spectrogram, warped noise PSD, band envelope DC."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fs = fs or chunk.conf.fs
    t = np.arange(chunk.nfrm) * chunk.conf.thop
    fig, axes = plt.subplots(4, 1, figsize=(10, 10), sharex=True)
    axes[0].plot(t, _np(chunk.f0))
    axes[0].set_ylabel("F0 [Hz]")
    a = _np(chunk.ampl)
    axes[1].imshow(20 * np.log10(np.maximum(a, 1e-6)).T, origin="lower",
                   aspect="auto", extent=[t[0], t[-1], 1, a.shape[1]])
    axes[1].set_ylabel("harmonic #")
    p = _np(chunk.psd)
    axes[2].imshow(10 * np.log10(np.maximum(p, 1e-12)).T, origin="lower",
                   aspect="auto", extent=[t[0], t[-1], 0, p.shape[1]])
    axes[2].set_ylabel("warped PSD bin")
    axes[3].plot(t, _np(chunk.edc))
    axes[3].set_ylabel("band env DC")
    axes[3].set_xlabel("time [s]")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_spectra(path: str, fs: float, **signals) -> None:
    """Overlayed magnitude spectra of named signals (debug comparison)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    for name, x in signals.items():
        x = _np(x).astype(np.float64)
        f = np.fft.rfftfreq(len(x), 1 / fs)
        s = 20 * np.log10(np.abs(np.fft.rfft(x * np.hanning(len(x)))) + 1e-9)
        ax.plot(f, s, label=name, alpha=0.7)
    ax.set_xlabel("Hz")
    ax.set_ylabel("dB")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
