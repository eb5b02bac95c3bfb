"""Procedural datasets, the port's copy of ``repro/data/synthetic.py``.

numpy only, copied as it is, so every array equals the reference's bit
for bit for the same seeds (Omniglot and GSC are not available offline):

* ``GlyphClasses`` — Omniglot-like handwritten-character classes: each class
  is a fixed set of random strokes; each sample redraws them with jitter,
  rendered to 28x28 and flattened pixelwise to a length-784 sequence
  ("sequential Omniglot", paper Fig. 14).
* ``KeywordAudio`` — GSC-like keyword classes: class-specific formant
  trajectories + noise at 16 kHz; raw 1 s clips (16k samples) or 28-dim
  log-mel "MFCC" frames with the paper's 32 ms / 16 ms framing (63 frames).
* ``lm_batch`` — deterministic, *seekable* synthetic token stream (mixture of
  hash noise and copy/repeat structure so an LM can reduce loss); stateless
  in the step index, which is what makes checkpoint-resume exact.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Omniglot-like glyphs
# ---------------------------------------------------------------------------

class GlyphClasses:
    def __init__(self, n_classes: int, seed: int = 0, size: int = 28):
        self.n_classes = n_classes
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.protos = [self._make_proto() for _ in range(n_classes)]

    def _make_proto(self):
        n_strokes = int(self.rng.integers(2, 5))
        strokes = []
        for _ in range(n_strokes):
            n_pts = int(self.rng.integers(3, 6))
            pts = self.rng.uniform(3, self.size - 3, (n_pts, 2))
            strokes.append(pts)
        return strokes

    def _render(self, strokes, jitter_rng):
        img = np.zeros((self.size, self.size), np.float32)
        yy, xx = np.mgrid[0:self.size, 0:self.size]
        for pts in strokes:
            p = pts + jitter_rng.normal(0, 0.8, pts.shape)
            for a, b in zip(p[:-1], p[1:]):
                for t in np.linspace(0, 1, 12):
                    c = a * (1 - t) + b * t
                    img += np.exp(-((yy - c[1]) ** 2 + (xx - c[0]) ** 2) / 1.6)
        img = np.clip(img, 0, 1.5) / 1.5
        return img

    def sample(self, cls: int, n: int, seed: int):
        """n samples of class cls -> (n, 784, 1) pixel sequences in [0,1]."""
        rng = np.random.default_rng((seed, cls))
        out = np.stack([self._render(self.protos[cls], rng) for _ in range(n)])
        return out.reshape(n, self.size * self.size, 1)


# ---------------------------------------------------------------------------
# GSC-like keyword audio
# ---------------------------------------------------------------------------

class KeywordAudio:
    SR = 16000

    def __init__(self, n_classes: int = 12, seed: int = 0, duration_s: float = 1.0):
        self.n_classes = n_classes
        self.n_samples = int(self.SR * duration_s)
        rng = np.random.default_rng(seed)
        # class-specific formant trajectories (2-3 "phonemes")
        self.classes = []
        for _ in range(n_classes):
            segs = []
            for _ in range(int(rng.integers(2, 4))):
                f0 = rng.uniform(100, 300)
                f1 = rng.uniform(400, 2500)
                slope = rng.uniform(-400, 400)
                segs.append((f0, f1, slope))
            self.classes.append(segs)

    def sample(self, cls: int, n: int, seed: int, snr: float = 6.0):
        """(n, n_samples, 1) raw audio in [-1, 1]."""
        rng = np.random.default_rng((seed, cls, 7))
        t = np.arange(self.n_samples) / self.SR
        out = np.zeros((n, self.n_samples), np.float32)
        segs = self.classes[cls]
        seg_len = self.n_samples // len(segs)
        for i in range(n):
            x = np.zeros(self.n_samples, np.float32)
            for j, (f0, f1, slope) in enumerate(segs):
                s, e = j * seg_len, (j + 1) * seg_len
                tt = t[s:e] - t[s]
                jf = rng.normal(0, 20)
                x[s:e] = (np.sin(2 * np.pi * ((f0 + jf) * tt))
                          + 0.6 * np.sin(2 * np.pi * ((f1 + jf + slope * tt) * tt)))
            env = np.hanning(self.n_samples)
            noise = rng.normal(0, 10 ** (-snr / 20), self.n_samples)
            out[i] = np.clip(x * env * 0.5 + noise, -1, 1)
        return out[..., None]

    def mfcc(self, audio: np.ndarray, n_mels: int = 28, win_ms: float = 32.0,
             hop_ms: float = 16.0):
        """Log-mel features (the paper's 28-D 'MFCC' map, 63 frames/s)."""
        x = audio[..., 0]
        win = int(self.SR * win_ms / 1000)
        hop = int(self.SR * hop_ms / 1000)
        # pad like the paper's framing (63 frames for 1 s @ 32/16 ms)
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, win)])
        n_frames = 1 + (x.shape[-1] - win) // hop
        frames = np.stack([x[..., i * hop:i * hop + win] for i in range(n_frames)], -2)
        spec = np.abs(np.fft.rfft(frames * np.hanning(win), axis=-1)) ** 2
        n_bins = spec.shape[-1]
        # triangular mel-ish filterbank
        centers = np.linspace(2, n_bins - 2, n_mels + 2)
        fb = np.zeros((n_mels, n_bins), np.float32)
        for m in range(n_mels):
            l, c, r = centers[m], centers[m + 1], centers[m + 2]
            bins = np.arange(n_bins)
            fb[m] = np.clip(np.minimum((bins - l) / (c - l + 1e-9),
                                       (r - bins) / (r - c + 1e-9)), 0, 1)
        mel = spec @ fb.T
        return np.log1p(mel).astype(np.float32)


# ---------------------------------------------------------------------------
# Seekable synthetic LM stream
# ---------------------------------------------------------------------------

def _hash_tokens(step: int, idx: np.ndarray, vocab: int, salt: int) -> np.ndarray:
    mix = (step * 1442695040888963407 + salt) % (1 << 64)
    h = (idx.astype(np.uint64) * np.uint64(6364136223846793005)
         + np.uint64(mix))
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    return (h % np.uint64(vocab)).astype(np.int32)


def lm_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0):
    """Deterministic (step -> batch) token stream with learnable structure:
    the second half of each row repeats the first half (copy task), so
    cross-entropy can fall well below ln(vocab).  Returns {tokens, labels}."""
    idx = np.arange(batch * (seq + 1), dtype=np.uint64).reshape(batch, seq + 1)
    toks = _hash_tokens(step, idx, vocab, seed)
    half = (seq + 1) // 2
    toks[:, half:half * 2] = toks[:, :half]
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
