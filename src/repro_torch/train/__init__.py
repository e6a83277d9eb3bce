"""Training (port of ``repro.train``): the optimizers, the LM train state and
step, checkpoints in the reference's layout, and the train loop."""
