from .evaluator import gather_and_evaluate, inference_on_dataset, make_detect_fn
from .testing import flatten_results_dict, print_csv_format, verify_results
from .voc_eval import (PascalVOCDetectionEvaluator, voc_ap, voc_eval_class,
                       voc_eval_corloc_class)

__all__ = ["PascalVOCDetectionEvaluator", "flatten_results_dict",
           "gather_and_evaluate", "inference_on_dataset", "make_detect_fn",
           "print_csv_format", "verify_results", "voc_ap", "voc_eval_class",
           "voc_eval_corloc_class"]
