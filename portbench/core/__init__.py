"""The harness: finding pieces by name, weights and inputs from the seed,
the measured window, the trace and its reduction, the result line."""
