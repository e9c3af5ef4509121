from mvlpt_torch.data.coop import datasets  # noqa: F401  (registers loaders)
