"""The cell-independent parts of the benchmark: files found by name, seeds,
the SURF-22 trace generator, the device, the trace reader and the result."""
