"""Config-driven entry points (``python -m avjepa_tpu_torch.app.main``)."""
