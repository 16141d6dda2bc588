"""The JAX package's two examples through the port's public names:
`quickstart` (a TGP on boston, trained, checkpointed and served) and
`deep_tgp` (a 2-layer deep TGP against a shallow SVGP on step data).

    python -m tgp.pytorch_tpu_torch.examples.quickstart [--platform cpu] [--epochs 2000]
    python -m tgp.pytorch_tpu_torch.examples.deep_tgp [--platform cpu] [--epochs 1500]
"""
