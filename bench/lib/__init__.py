"""The harness: cells, traffic, spans, traces, counts and checks."""
