from repro_torch.checkpoint.io import restore, save  # noqa: F401
