from .coco_eval import COCODetectionEvaluator
from .evaluator import (decode_panoptic_png, gather_and_evaluate,
                        inference_on_dataset, make_detect_fn, make_sem_seg_fn,
                        panoptic_inference_on_dataset,
                        sem_seg_inference_on_dataset)
from .panoptic_eval import (PanopticQualityEvaluator,
                            combine_semantic_and_instance_outputs)
from .sem_seg_eval import SemSegEvaluator
from .testing import flatten_results_dict, print_csv_format, verify_results
from .voc_eval import (PascalVOCDetectionEvaluator, voc_ap, voc_eval_class,
                       voc_eval_corloc_class)

__all__ = ["COCODetectionEvaluator", "PanopticQualityEvaluator",
           "PascalVOCDetectionEvaluator", "SemSegEvaluator",
           "combine_semantic_and_instance_outputs", "decode_panoptic_png",
           "flatten_results_dict", "gather_and_evaluate",
           "inference_on_dataset", "make_detect_fn", "make_sem_seg_fn",
           "panoptic_inference_on_dataset", "print_csv_format",
           "sem_seg_inference_on_dataset", "verify_results", "voc_ap",
           "voc_eval_class", "voc_eval_corloc_class"]
