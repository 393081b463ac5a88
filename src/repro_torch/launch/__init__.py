"""Launchers of the port: step factories, device meshes and the serving entry point."""
