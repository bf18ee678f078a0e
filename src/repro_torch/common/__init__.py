"""Tree and type helpers shared by the trainer and checkpointing (the
port of ``repro.common``)."""
