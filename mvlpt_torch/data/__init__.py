from mvlpt_torch.data.datum import DatasetBase, Datum
from mvlpt_torch.data.loader import DataLoader, build_data_loader, eval_mode
from mvlpt_torch.data.managers import (
    CoopMultitaskDataManager,
    ElevaterDataManager,
    ElevaterMultitaskDataManager,
    build_data_manager,
)
from mvlpt_torch.data.transforms import (
    EvalTransform,
    TrainTransform,
    build_transform,
    device_normalize,
)
