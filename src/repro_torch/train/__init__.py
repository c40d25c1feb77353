"""Training of the port: data, optimizers, checkpoints and the
preemptible training job (counterparts of ``repro.train``)."""
