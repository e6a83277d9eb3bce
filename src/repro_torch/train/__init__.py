"""Training utilities (port of ``repro.train``): the functional optimizers."""
