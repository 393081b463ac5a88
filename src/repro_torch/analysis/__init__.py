"""Step accounting of the port: op-by-op cost of a step (``cost``) and an
H100 roofline over it (``roofline``)."""
