"""The training substrate (the port of ``repro.train``): a functional
optimizer library, the train state, npz checkpoints, the synthetic token
pipeline and the LM trainer."""
