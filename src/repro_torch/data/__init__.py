"""Data of the port: the synthetic LM token pipeline (port of ``repro.data``)."""
