from mvlpt_torch.evaluation.evaluator import ClassificationEvaluator, macro_f1
from mvlpt_torch.evaluation.metrics import get_metric, group_wise, mean_lp_error
from mvlpt_torch.evaluation.detection import (
    detection_map_single_iou, detection_map_multi_iou, detection_map_coco)
from mvlpt_torch.evaluation.matting import (
    matting_mean_iou, matting_foreground_iou, matting_boundary_mean_iou,
    matting_boundary_foreground_iou, matting_l1_error)
from mvlpt_torch.evaluation.caption import caption_report
