"""The benchmark harness: files by name, data, weights, traces, checks."""
