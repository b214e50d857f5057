"""Entry points of the port, each run as ``python -m twotowers_tpu_torch.scripts.<name>``:
``train`` (the experiment runner) and ``generate_and_train`` (synthetic
data, then training)."""
