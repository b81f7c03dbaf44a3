"""Scenario subsystem: registry-driven workloads replayed by the engine.

    from repro_torch.scenarios import get_scenario, run_population

    spec = get_scenario("commuter")          # or any of list_scenarios()
    co = spec.colocation(seed=0, n_mules=20, n_steps=500)
    final, aux = run_population(pop, co, batch_fn, train_fn, pcfg, key=0,
                                eval_every=100, eval_fn=eval_hook)

``run_sweep`` replays S seeds at once; ``stack_trees`` and
``stack_colocations`` build its lane-stacked inputs.
``run_population_streamed`` replays a chunk generator
(``scenario_generator``), ``run_population_distributed`` a population cut
over the ranks of a ``torch.distributed`` world.
"""
from repro_torch.scenarios.engine import (  # noqa: F401
    run_population, run_population_distributed, run_population_streamed)
from repro_torch.scenarios.sweep import (  # noqa: F401
    run_sweep, run_sweep_distributed, stack_colocations, stack_trees)
from repro_torch.scenarios.registry import (  # noqa: F401
    SCENARIOS, ChurnSpec, ScenarioSpec, SpaceSpec, get_scenario,
    list_scenarios, register, scenario_generator, trace_colocation,
    walk_colocation)
