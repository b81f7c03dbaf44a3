"""Scenario subsystem: registry-driven workloads replayed by the engine.

    from repro_torch.scenarios import get_scenario, run_population

    spec = get_scenario("commuter")          # or any of list_scenarios()
    co = spec.colocation(seed=0, n_mules=20, n_steps=500)
    final, aux = run_population(pop, co, batch_fn, train_fn, pcfg, key=0,
                                eval_every=100, eval_fn=eval_hook)
"""
from repro_torch.scenarios.engine import run_population  # noqa: F401
from repro_torch.scenarios.registry import (  # noqa: F401
    SCENARIOS, ChurnSpec, ScenarioSpec, SpaceSpec, get_scenario,
    list_scenarios, register, trace_colocation)
