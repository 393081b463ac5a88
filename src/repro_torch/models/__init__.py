"""The LM substrate of the port: parameter specs, layers, and the dense,
Mamba2 (SSM) and Zamba2 (hybrid) LMs."""
