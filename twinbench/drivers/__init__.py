"""The timed loop of each entry of the twin, one module a driver, found by
the ``driver`` name of a traffic file."""
