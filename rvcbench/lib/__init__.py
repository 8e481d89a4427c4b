"""What every cell shares: discovery of configurations, traffic and
metrics by name, weights and voices from the seed, the window's
statistics, the trace's reading and the result line."""
