"""repro_torch.data against the JAX package's repro.data: the port keeps
its own numpy copy, so every array must equal the reference's bit for bit
for the same seeds (glyphs, audio, MFCC, episodes, class splits, the LM
token stream)."""

import numpy as np
import pytest

from repro import data as jd
from repro_torch import data as td


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size,seed", [(8, 0), (8, 3), (28, 1)])
def test_glyph_classes_equal(size, seed):
    jg, tg = jd.GlyphClasses(6, seed=seed, size=size), \
        td.GlyphClasses(6, seed=seed, size=size)
    for cj, ct in zip(jg.protos, tg.protos):
        for a, b in zip(cj, ct):
            _same(a, b)
    for cls in (0, 5):
        _same(tg.sample(cls, 3, seed=11), jg.sample(cls, 3, seed=11))


@pytest.mark.parametrize("seed", [0, 2])
def test_keyword_audio_and_mfcc_equal(seed):
    ja = jd.KeywordAudio(4, seed=seed, duration_s=0.1)
    ta = td.KeywordAudio(4, seed=seed, duration_s=0.1)
    for cls in range(4):
        a, b = ta.sample(cls, 2, seed=5), ja.sample(cls, 2, seed=5)
        _same(a, b)
        _same(ta.mfcc(a), ja.mfcc(b))


@pytest.mark.parametrize("n_ways,k,q", [(5, 1, 4), (5, 3, 3), (3, 5, 2)])
def test_episodes_equal(n_ways, k, q):
    jtr, jte = jd.split_classes(20, 0.6, seed=0)
    ttr, tte = td.split_classes(20, 0.6, seed=0)
    _same(ttr, jtr)
    _same(tte, jte)
    js = jd.EpisodicSampler(jd.GlyphClasses(20, seed=0, size=8), jtr, seed=1)
    ts = td.EpisodicSampler(td.GlyphClasses(20, seed=0, size=8), ttr, seed=1)
    for ep in (0, 7):
        for a, b in zip(ts.episode(ep, n_ways, k, q),
                        js.episode(ep, n_ways, k, q)):
            _same(a, b)


@pytest.mark.parametrize("n,frac,seed", [(100, 0.7, 0), (40, 0.5, 3)])
def test_split_classes_equal(n, frac, seed):
    for a, b in zip(td.split_classes(n, frac, seed), jd.split_classes(n, frac, seed)):
        _same(a, b)


@pytest.mark.parametrize("step", [0, 1, 17, 10 ** 6])
def test_lm_batch_equal(step):
    a, b = td.lm_batch(step, 3, 33, 257, seed=4), jd.lm_batch(step, 3, 33, 257, seed=4)
    assert a.keys() == b.keys()
    for key in a:
        _same(a[key], b[key])
