from mvlpt_torch.data.transforms import device_normalize
