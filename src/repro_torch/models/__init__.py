"""The LM substrate of the port: parameter specs, layers, the dense LM."""
