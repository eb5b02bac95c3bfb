"""What every traffic generator shares: seeded hashing and the interface
the driver calls.

A traffic mix is a data file, ``bench/traffic/<mix>.json``, whose
``generator`` key names a module ``bench/generators/<generator>.py``.  The
module's ``make(spec, seed, service)`` returns a :class:`Generator` for the
mix's parameters ``spec``, the run's ``seed`` and the cell's service
geometry.  The generator owns the run's calls: ``setup`` opens the streams
and adopts the tenants' banks, and ``cycle`` makes one cycle's calls
(pushes, enrollments, parks, whatever the mix asks for), each through the
driver's recorder (bench/harness/driver.py ``Recorder``), which times and
records them.  A new kind of traffic is a new generator module and data
files; nothing here or in the driver names one.

Every choice comes from a hash of (seed, what, index), so a stream's inputs
do not depend on how many cycles the window reaches, and every seed gets
the same sizes in another order.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def mix(*keys) -> np.ndarray:
    """splitmix64 over the keys in order (ints in [0, 2**64) or integer
    arrays, which broadcast): uniform 64-bit values, vectorized."""
    with np.errstate(over="ignore"):
        h = np.zeros((), np.uint64)
        for k in keys:
            z = h ^ np.asarray(k).astype(np.uint64)
            z = z + _U64(0x9E3779B97F4A7C15)
            z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
            z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
            h = z ^ (z >> _U64(31))
        return h


def uniform(*keys) -> np.ndarray:
    return (mix(*keys) >> _U64(11)).astype(np.float64) * 2.0 ** -53


def below(n: int, *keys) -> np.ndarray:
    """Seeded integers in [0, n)."""
    return (mix(*keys) % _U64(n)).astype(np.int64)


class Generator:
    """One run's traffic.  ``sessions`` streams, of which stream ``s``
    belongs to tenant ``tenant_of(s)`` (None: the shared head)."""

    sessions: int = 0
    tenants: int = 0

    def tenant_of(self, s: int) -> int | None:
        return None

    def initial_banks(self, dim: int) -> dict[int, dict]:
        """Each tenant's layout-free bank blob at the start (tenants not
        listed start empty)."""
        return {}

    def setup(self, run) -> None:
        """Adopt the initial banks, then open every stream."""
        for t, blob in self.initial_banks(run.dim).items():
            run.adopt(t, blob)
        for s in range(self.sessions):
            run.open(s, self.tenant_of(s))

    def cycle(self, p: int, run) -> None:
        """Make cycle ``p``'s calls through ``run``."""
        raise NotImplementedError
