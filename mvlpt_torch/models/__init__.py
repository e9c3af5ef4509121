from mvlpt_torch.models.custom_clip import MVLPTModel, TaskClassRanges
