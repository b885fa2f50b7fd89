"""The flash crowd's autoscaler in the vector runtime's fluid control
pre-pass against the event simulator (``sim``), in both packages, over
five seeds.

The fluid pre-pass (``vector.compile``) replays the controller against
the expected backlog; ``sim`` runs it on sampled requests.  The two
disagree by the fluid model's own gap.  Held here, every time EQUAL:

* the port's fluid pre-pass gives the reference's first scale-out and
  first scale-in times (and actions) at every seed;
* the port's ``sim`` gives the reference's ``sim`` times;
* so the fluid-against-``sim`` gap (``sim`` minus fluid, in seconds, for
  the scale-out and the scale-in) is the same in both packages: any gap
  is the fluid model's, not the port's.  The test prints the gaps.
"""
from __future__ import annotations

import pytest

pytest.importorskip("jax")

from repro import scenarios as jsc  # noqa: E402
from repro.core.runtime import run_scenario as jax_run_scenario  # noqa: E402
from repro.vector import compile_experiment as jax_compile  # noqa: E402

from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.core.runtime import run_scenario  # noqa: E402
from repro_torch.vector import compile_experiment  # noqa: E402

SEEDS = [1, 2, 3, 4, 5]
NAME = "flash-crowd-autoscale"


def _first_out_and_in(log) -> tuple:
    """(time of the first scale-out, time of the first scale-in after it)
    of a control log or a program's ``control_actions``; None where the
    controller never took one."""
    t_out = t_in = None
    peak = None
    for t, kind, p in log:
        if kind != "set_scale":
            continue
        if t_out is None:
            t_out, peak = t, p["n"]
        elif p["n"] > peak:
            peak = p["n"]
        elif p["n"] < peak:
            t_in = t
            break
    return t_out, t_in


def _gap(sim, fluid) -> tuple:
    return tuple(None if s is None or f is None else s - f
                 for s, f in zip(sim, fluid))


@pytest.mark.parametrize("seed", SEEDS)
def test_fluid_against_sim_gap_is_the_same_in_both_packages(seed):
    port_fluid = compile_experiment(
        tsc.get(NAME, seed=seed).compile()).control_actions
    ref_fluid = jax_compile(jsc.get(NAME, seed=seed).compile()).control_actions
    assert port_fluid == ref_fluid
    port_sim = run_scenario(tsc.get(NAME, seed=seed), "sim").control_log
    ref_sim = jax_run_scenario(jsc.get(NAME, seed=seed), "sim").control_log
    assert port_sim == ref_sim
    fluid, sim = _first_out_and_in(port_fluid), _first_out_and_in(port_sim)
    assert fluid == _first_out_and_in(ref_fluid)
    assert fluid[0] is not None and sim[0] is not None
    gap = _gap(sim, fluid)
    assert gap == _gap(_first_out_and_in(ref_sim),
                       _first_out_and_in(ref_fluid))
    print(f"seed {seed}: fluid out/in {fluid}, sim out/in {sim}, "
          f"gap (sim - fluid) {gap}")
