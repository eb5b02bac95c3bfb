"""Always-on raw 16 kHz keyword audio.

Each cycle pushes the next ``steps_per_push`` samples of every one of
``sessions`` streams.  A stream plays a seeded sequence of 1 s keyword
clips from a pool (``classes`` x ``clips_per_class`` clips at ``snr_db``),
back to back, starting at a seeded frame of its first clip.  The clips are
a frozen copy of the program's ``data/synthetic.KeywordAudio``.
"""

from __future__ import annotations

import numpy as np

from bench.harness.traffic import Generator, below, mix


class KeywordAudio:
    SR = 16000

    def __init__(self, n_classes: int = 12, seed: int = 0,
                 duration_s: float = 1.0):
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
                          + 0.6 * np.sin(2 * np.pi * ((f1 + jf + slope * tt)
                                                      * tt)))
            env = np.hanning(self.n_samples)
            noise = rng.normal(0, 10 ** (-snr / 20), self.n_samples)
            out[i] = np.clip(x * env * 0.5 + noise, -1, 1)
        return out[..., None]


class AudioStreams(Generator):
    def __init__(self, spec: dict, seed: int):
        self.seed = int(seed) % (1 << 64)
        self.sessions = int(spec["sessions"])
        self.steps = int(spec["steps_per_push"])
        n_cls, per = int(spec["classes"]), int(spec["clips_per_class"])
        gen = KeywordAudio(n_cls, seed=int(mix(self.seed, 1)))
        clips = np.concatenate([
            gen.sample(c, per, int(mix(self.seed, 2)), snr=spec["snr_db"])
            for c in range(n_cls)])[..., 0]
        if gen.n_samples % self.steps:
            raise ValueError(f"a clip of {gen.n_samples} samples is not a "
                             f"whole number of {self.steps}-sample pushes")
        self.frames = gen.n_samples // self.steps
        self.pool = clips.reshape(len(clips), self.frames, self.steps)
        self.first_frame = below(self.frames, self.seed, 3,
                                 np.arange(self.sessions))

    def push(self, p: int) -> np.ndarray:
        """Cycle p's input of every stream: (sessions, steps, 1) float32."""
        s = np.arange(self.sessions)
        g = self.first_frame + p
        clip = below(len(self.pool), self.seed, 6, s, g // self.frames)
        x = self.pool[clip, g % self.frames]
        return np.ascontiguousarray(x, dtype=np.float32)[..., None]

    def cycle(self, p: int, run) -> None:
        run.push(self.push(p))


def make(spec: dict, seed: int, service: dict) -> AudioStreams:
    return AudioStreams(spec, seed)
