"""Mobility: visit-log generators, churn masks and their [T, M] expansion."""
from repro_torch.mobility.patterns import (  # noqa: F401
    commuter_trace, event_crowd_trace, flash_churn_mask, markov_churn_mask,
    shift_worker_trace)
from repro_torch.mobility.trace import (  # noqa: F401
    dwell_exchange_flags, synth_foursquare_trace, trace_to_colocation)
