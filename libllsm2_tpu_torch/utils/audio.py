"""Host-side WAV I/O (counterpart of libllsm2_tpu/utils/audio.py, copied
whole; reference: ciglet.h -> wavread/wavwrite).

Uses scipy on the host; audio never needs to touch the device for I/O.
"""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def wavread(path: str):
    fs, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim > 1:
        x = x.mean(axis=1)
    return x, float(fs)


def wavwrite(path: str, x, fs: float) -> None:
    x = np.asarray(x, np.float32)
    x = np.clip(x, -1.0, 1.0)
    wavfile.write(path, int(round(fs)), (x * 32767.0).astype(np.int16))
