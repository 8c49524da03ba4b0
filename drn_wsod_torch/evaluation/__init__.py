from .cityscapes_eval import (CityscapesInstanceEvaluator,
                              CityscapesSemSegEvaluator,
                              label_ids_to_train_ids)
from .coco_eval import COCODetectionEvaluator
from .evaluator import (decode_panoptic_png, gather_and_evaluate,
                        inference_on_dataset, make_detect_fn, make_sem_seg_fn,
                        panoptic_inference_on_dataset,
                        sem_seg_inference_on_dataset)
from .lvis_eval import LVISDetectionEvaluator
from .panoptic_eval import (PanopticQualityEvaluator,
                            combine_semantic_and_instance_outputs)
from .rotated_coco_eval import (RotatedCOCODetectionEvaluator,
                                iou_matrix_rotated)
from .sem_seg_eval import SemSegEvaluator
from .testing import flatten_results_dict, print_csv_format, verify_results
from .voc_eval import (PascalVOCDetectionEvaluator, voc_ap, voc_eval_class,
                       voc_eval_corloc_class)

__all__ = ["COCODetectionEvaluator", "CityscapesInstanceEvaluator",
           "CityscapesSemSegEvaluator", "LVISDetectionEvaluator",
           "PanopticQualityEvaluator", "PascalVOCDetectionEvaluator",
           "RotatedCOCODetectionEvaluator", "SemSegEvaluator",
           "combine_semantic_and_instance_outputs", "decode_panoptic_png",
           "flatten_results_dict", "gather_and_evaluate",
           "inference_on_dataset", "iou_matrix_rotated",
           "label_ids_to_train_ids", "make_detect_fn", "make_sem_seg_fn",
           "panoptic_inference_on_dataset", "print_csv_format",
           "sem_seg_inference_on_dataset", "verify_results", "voc_ap",
           "voc_eval_class", "voc_eval_corloc_class"]
