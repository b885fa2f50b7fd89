"""The port's service profiles (``repro_torch.core.profiles``) against the
JAX package's (``repro.core.profiles``, which imports no JAX).

* ``mean`` of ``LogNormalProfile`` and ``FixedProfile``, and
  ``ScalarService``'s ``sample``, ``sample_batch``, ``moments``, ``mean``
  and ``name``, equal to the reference's on the same profile and seed,
  bit for bit;
* ``ScalarService`` stays the frozen dataclass it was: the same fields,
  the same equality, and the same fingerprints (the digests below were
  taken on the tree before these methods existed), so no cached cell's
  key moves.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import profiles as J

from repro_torch.cache import fingerprint
from repro_torch.core import profiles as P
from repro_torch.scenarios import get
from repro_torch.vector import compile_experiment

PROFILES = {
    "xapian": (lambda m: m.tailbench_profile("xapian")),
    "sphinx": (lambda m: m.tailbench_profile("sphinx")),
    "no-tail": (lambda m: m.LogNormalProfile("flat", 2e-3, sigma=0.0)),
    "fixed": (lambda m: m.FixedProfile("fixed", 0.004)),
}


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_profile_mean_matches_reference(name):
    assert PROFILES[name](P).mean == PROFILES[name](J).mean


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_scalar_service_delegates_as_the_reference(name):
    port = P.ScalarService(PROFILES[name](P))
    ref = J.ScalarService(PROFILES[name](J))
    assert port.name == ref.name
    assert port.mean == ref.mean
    assert port.moments() == ref.moments()
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    assert [port.sample(r1) for _ in range(5)] == \
        [ref.sample(r2) for _ in range(5)]
    got, want = port.sample_batch(r1, 1000), ref.sample_batch(r2, 1000)
    assert got.tobytes() == want.tobytes()
    # the two streams stayed in step
    assert r1.random() == r2.random()


def test_scalar_service_name_without_a_profile_name():
    class Bare:
        mean = 1.0
    assert P.ScalarService(Bare()).name == \
        J.ScalarService(Bare()).name == "scalar"


def test_scalar_service_fields_and_equality_unchanged():
    assert [f.name for f in dataclasses.fields(P.ScalarService)] == \
        ["profile", "kind"]
    a = P.ScalarService(P.tailbench_profile("xapian"))
    assert a == P.ScalarService(P.tailbench_profile("xapian"))
    assert a != P.ScalarService(P.tailbench_profile("silo"))
    assert a.kind == "scalar"
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.profile = None


#: fingerprints taken before ``ScalarService`` and the profiles had these
#: methods: adding them must move no cache key
FINGERPRINTS = {
    "service_xapian":
        "cb7d957702d37e106eaa5cbb95d37067a8b19a537ec10a66d692d5277abf270e",
    "service_fixed":
        "838171fef9608f132d0e80eb2de8567109ab7c558a9cccf43c226bc24db3f428",
    "steady_program":
        "854dffe570271e42ac2bcad798149fc421dca8af31a43abc174666b952c02be0",
    "steady_experiment":
        "2202c10455fa05e1a296c2448a8a696dccd71424ff40ab374c75c36464388800",
}


def test_fingerprints_unchanged():
    exp = get("steady", seed=3, duration=2.0).compile()
    got = {
        "service_xapian": fingerprint(P.ScalarService(
            P.tailbench_profile("xapian"))),
        "service_fixed": fingerprint(P.ScalarService(
            P.FixedProfile("f", 0.002))),
        "steady_program": fingerprint(compile_experiment(exp)),
        "steady_experiment": fingerprint(exp),
    }
    assert got == FINGERPRINTS
