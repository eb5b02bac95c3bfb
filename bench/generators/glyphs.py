"""Omniglot-like glyphs flattened to 784-step sequences, for tenants that
stream glyphs and enroll classes.

``tenants`` tenants of ``sessions_per_tenant`` streams each.  A cycle makes
``pushes_per_cycle`` pushes (0 or more) of one whole glyph per stream, then
``enrolls_per_cycle`` enrollments of ``shots`` glyphs of one class each, to
tenants in turn, through the tenant's first stream.  An enrollment's label
is a new one (a new way) with probability ``new_label_share`` while its
tenant has fewer ways than the service's ``max_ways``, else one of the
tenant's labels (a refinement).  Banks start at ``initial_ways`` ways of
``initial_count`` shots with seeded sums (0: the tenants start empty).  The
glyphs are a frozen copy of the program's ``data/synthetic.GlyphClasses``
(``classes`` classes of ``glyphs_per_class`` glyphs; label ``l`` shows
class ``l mod classes``).
"""

from __future__ import annotations

import numpy as np

from bench.harness.traffic import Generator, below, mix, uniform

_U64 = np.uint64


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


class TenantGlyphs(Generator):
    def __init__(self, spec: dict, seed: int, max_ways: int):
        self.spec = spec
        self.seed = int(seed) % (1 << 64)
        self.steps = int(spec["steps_per_push"])
        self.tenants = int(spec["tenants"])
        self.per_tenant = int(spec["sessions_per_tenant"])
        self.sessions = self.tenants * self.per_tenant
        self.pushes = int(spec.get("pushes_per_cycle", 1))
        self.enrolls = int(spec.get("enrolls_per_cycle", 0))
        self.shots = int(spec.get("shots", 0))
        self.max_ways = int(max_ways)
        n_cls, per = int(spec["classes"]), int(spec["glyphs_per_class"])
        gen = GlyphClasses(n_cls, seed=int(mix(self.seed, 4)))
        if gen.size * gen.size != self.steps:
            raise ValueError(f"a glyph is {gen.size ** 2} steps, not "
                             f"{self.steps}")
        self.pool = np.concatenate([gen.sample(c, per, int(mix(self.seed, 5)))
                                    for c in range(n_cls)])[..., 0]
        self.classes, self.per_class = n_cls, per
        if self.shots > per:
            raise ValueError(f"{self.shots} shots but {per} glyphs a class")
        init = int(spec.get("initial_ways", 0))
        if not 0 <= init <= self.max_ways:
            raise ValueError(f"initial_ways {init} outside [0, {max_ways}]")
        self.ways = [init] * self.tenants   # the label -> way mirror
        self._q = 0                          # enrollments made so far

    def tenant_of(self, s: int) -> int:
        return s // self.per_tenant

    def push(self, p: int) -> np.ndarray:
        """Push p's input of every stream: (sessions, steps, 1) float32."""
        x = self.pool[below(len(self.pool), self.seed, 7,
                            np.arange(self.sessions), p)]
        return np.ascontiguousarray(x, dtype=np.float32)[..., None]

    def enrollment(self) -> tuple[int, int, np.ndarray]:
        """The next enrollment: (tenant, label, shots (k, steps, 1))."""
        q = self._q
        self._q += 1
        t = int((mix(self.seed, 8) + _U64(q)) % _U64(self.tenants))
        n = self.ways[t]
        if n < self.max_ways and (n == 0 or uniform(self.seed, 9, q)
                                  < self.spec["new_label_share"]):
            label = n
            self.ways[t] = n + 1
        else:
            label = int(below(n, self.seed, 10, q))
        pick = np.argsort(mix(self.seed, 11, q,
                              np.arange(self.per_class)))[:self.shots]
        shots = self.pool[(label % self.classes) * self.per_class + pick]
        return t, label, np.ascontiguousarray(shots)[..., None]

    def cycle(self, p: int, run) -> None:
        for i in range(self.pushes):
            run.push(self.push(p * self.pushes + i))
        for _ in range(self.enrolls):
            t, label, shots = self.enrollment()
            run.enroll(t * self.per_tenant, label, shots)

    def initial_banks(self, dim: int) -> dict[int, dict]:
        """Seeded sums of ``initial_count`` shots for ``initial_ways`` ways,
        labels = ways."""
        n = int(self.spec.get("initial_ways", 0))
        if n == 0:
            return {}
        k = float(self.spec["initial_count"])
        rng = np.random.default_rng(int(mix(self.seed, 12)))
        protos = np.abs(rng.standard_normal((self.tenants, n, dim),
                                            dtype=np.float32)) * 0.5
        return {t: {"s_sums": protos[t] * np.float32(k),
                    "counts": np.full(n, k, np.float32), "n_ways": n,
                    "labels": {i: i for i in range(n)}}
                for t in range(self.tenants)}


def make(spec: dict, seed: int, service: dict) -> TenantGlyphs:
    return TenantGlyphs(spec, seed, service.get("max_ways", 0))
