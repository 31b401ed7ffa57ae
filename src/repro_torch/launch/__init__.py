"""Launchers: the serving driver (port of ``repro.launch``)."""
