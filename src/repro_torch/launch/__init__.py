"""Launchers of the port: step factories and the serving entry point."""
