"""Command-line launchers of the port (counterparts of ``repro.launch``)."""
