from mvlpt_torch.evaluation.evaluator import ClassificationEvaluator, macro_f1
from mvlpt_torch.evaluation.metrics import get_metric
