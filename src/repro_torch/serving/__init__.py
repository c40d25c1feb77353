"""Serving tier of the port: the continuous-batching engine and the
§6.4 autoscaler (counterparts of ``repro.serving``)."""
