"""The experiment layer of the port: the per-dataset tables, the flow
architectures and the experiment CLI (`python -m
tgp.pytorch_tpu_torch.experiments.main`)."""
