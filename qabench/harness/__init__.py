"""The harness: cells found by name, the generator of planes and of
traffic, the window, the trace, the check."""
