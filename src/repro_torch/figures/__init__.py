"""The paper's figure runners on the port: one module per figure, each with
the basename of its counterpart in the reference's ``benchmarks/``.

``python -m repro_torch.figures.run [--smoke] [--only SUBSTR] [--device
cuda|cpu]`` runs them in order and prints ``name,us_per_call,derived``
rows; ``BENCH_FAST=0`` selects the full profile. The learned agents, the
interference predictor and the engines run on ``--device`` (``cuda`` by
default, which raises without a GPU). JSON artifacts go to
``experiments/figures_torch/`` under the working directory, and a PNG
beside each where matplotlib imports."""
