"""Dense decoder models of the port (counterparts of ``repro.models``)."""
