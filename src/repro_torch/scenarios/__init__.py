"""Named scenario registry of the port.

The seven canonical dynamic scenarios (``canonical``) and the four chaos
scenarios (``chaos``: retry-storm, correlated-failure, gray-failure,
flash-crowd-autoscale) register themselves here; ``get()`` builds one by
name with optional overrides.

    from repro_torch.scenarios import get, names
    sc = get("flash-crowd", duration=30.0, seed=3)

Run any of them on the card, or on the host's event simulator, from
the command line:

    PYTHONPATH=src python -m repro_torch.scenarios --list
    PYTHONPATH=src python -m repro_torch.scenarios server-failure --backend vector
    PYTHONPATH=src python -m repro_torch.scenarios retry-storm --backend sim
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.scenario import Scenario

SCENARIOS: Dict[str, Callable[..., Scenario]] = {}


def register(name: str):
    """Decorator: register a ``(**overrides) -> Scenario`` builder."""
    def deco(fn):
        SCENARIOS[name] = fn
        fn.scenario_name = name
        return fn
    return deco


def names() -> list[str]:
    return sorted(SCENARIOS)


def get(name: str, **overrides) -> Scenario:
    try:
        builder = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; available: {names()}") \
            from None
    return builder(**overrides)


from repro_torch.scenarios import canonical as _canonical  # noqa: E402,F401  (registers)
from repro_torch.scenarios import chaos as _chaos  # noqa: E402,F401  (registers)
