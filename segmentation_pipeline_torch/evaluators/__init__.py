from .contour_image_evaluator import ContourImageEvaluator
from .evaluator import Evaluator
from .label_map_evaluator import LabelMapEvaluator
from .labeled_tensor import LabeledTensor, Table
from .segmentation_evaluator import SegmentationEvaluator

__all__ = ["ContourImageEvaluator", "Evaluator", "LabelMapEvaluator", "LabeledTensor", "Table",
           "SegmentationEvaluator"]
