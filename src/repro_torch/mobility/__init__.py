"""Mobility: visit-log generators, churn masks and their [T, M] expansion,
the random walk of paper Sec 4.1, and the streamed schedules."""
from repro_torch.mobility.patterns import (  # noqa: F401
    commuter_trace, duty_cycle_mask, event_crowd_trace, flash_churn_mask,
    markov_churn_mask, multi_area_trace, shift_worker_trace)
from repro_torch.mobility.trace import (  # noqa: F401
    area_over_time, dwell_exchange_flags, synth_foursquare_trace,
    trace_to_colocation, trace_to_colocation_loop)
from repro_torch.mobility.random_walk import (  # noqa: F401
    MobilityConfig, WalkDraws, init_mobility, mobility_step,
    sample_walk_draws, simulate_trajectories, space_of)
from repro_torch.mobility.streaming import (  # noqa: F401
    CommuterStream, CompactColocation, commuter_stream, compact_colocation,
    materialize_generator, reorder_generator_arrays)
