"""The audio frontend: Whisper's log-mel spectrogram, the port of
``align_anything_tpu/ops/audio.py``.

The reference computes log-mel on the host per sample with
torchaudio/librosa (utils/process_audio.py:58 ``waveform2melspec``); here,
as in JAX, the whole frontend runs on the model's device over a batch of
waveforms: framing, the periodic Hann window, the real FFT, the slaney mel
filterbank and the log compression.  It is plain PyTorch: the TPU package
runs it as XLA ops, not as a Pallas kernel.

The mel product runs in true fp32 whatever ``allow_tf32`` says: TF32's
10-bit mantissa moves a log-mel bin by up to ~1e-3, far more than the
frontend's other roundings.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mel_filter_bank(n_freqs: int, n_mels: int, sample_rate: int,
                    fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-scale mel filterbank (librosa/Whisper convention),
    shape (n_freqs, n_mels).  Host-side constant."""
    fmax = fmax or sample_rate / 2

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = 3.0 * f / 200.0
        log_region = f >= 1000.0
        mel = np.where(log_region,
                       15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                       / np.log(6.4) * 27.0,
                       mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = 200.0 * m / 3.0
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0), f)
        return f

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    freqs = np.linspace(0, sample_rate / 2, n_freqs)

    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        lower, center, upper = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lower) / max(center - lower, 1e-10)
        down = (upper - freqs) / max(upper - center, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    # slaney normalization
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[None, :]
    return fb.astype(np.float32)


def _fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with TF32 off for the call (restored after)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def log_mel_spectrogram(waveform: torch.Tensor, *, n_fft: int = 400,
                        hop_length: int = 160, n_mels: int = 128,
                        sample_rate: int = 16000) -> torch.Tensor:
    """(B, T) waveform -> (B, n_mels, T // hop) fp32 Whisper log-mel, on the
    waveform's device.

    Matches WhisperFeatureExtractor: reflect-pad n_fft // 2, periodic Hann
    window, power spectrum, slaney mel, log10 with an 8-decade clamp under
    each sample's maximum, (x + 4) / 4 scaling; the last frame is dropped.
    """
    x = waveform.float()
    pad = n_fft // 2
    x = F.pad(x[:, None], (pad, pad), mode='reflect')[:, 0]
    frames = x.unfold(-1, n_fft, hop_length)              # (B, F, n_fft)
    window = torch.from_numpy(
        np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(x.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    power = spec.abs() ** 2                                # (B, F, n_fft//2+1)

    fb = torch.from_numpy(mel_filter_bank(n_fft // 2 + 1, n_mels,
                                          sample_rate)).to(x.device)
    mel = _fp32_matmul(power, fb)                          # (B, F, n_mels)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    # whisper drops the final frame and clamps to max - 8 per sample
    log_spec = log_spec[:, :-1].transpose(1, 2)            # (B, n_mels, F-1)
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0
